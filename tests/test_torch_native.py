"""The host libraries of both packages in the test process, and the guard
that every port test comparing against a JAX-package structure built through
``nns_tpu.native`` applies first.

Why a guard: the JAX package's loader (``nns_tpu/native/build.py``) compiles
``libnns_cpu.so`` straight to its final path and marks itself tried before
loading. In a checkout with no library, parallel test workers all start that
build at once; a worker that loads the file while another process is still
writing it gets an ``OSError``, and its loader returns None for the rest of
the process. Its numpy fallbacks do not build the same trees as the native
builds (octree ``children`` and ``order`` differ on clustered refs), so every
port test in that worker that compares a port tree (always native: the
port's loader writes a temporary file and renames it into place) with a JAX
tree fails.

The guard compiles the JAX package's own source into a directory private to
the test process and loads it through the JAX loader itself, so no other
process can be writing that file. It then asserts that both packages'
libraries are loaded, and fails (never skips) when either is missing. It
changes the JAX loader's module state in the test process only.

Use it in a test module with::

    from test_torch_native import native_libraries  # noqa: F401
    pytestmark = pytest.mark.usefixtures("native_libraries")
"""

import numpy as np
import pytest

import nns_tpu.native.build as jax_build
import nns_tpu.trees.beam as jbeam
import nns_tpu_torch.native.build as pt_build
import nns_tpu_torch.trees.beam as pbeam
from nns_tpu.data import make_dataset
from nns_tpu.trees.octree import Octree as JOctree
from nns_tpu_torch.trees.octree import Octree

# Path of the JAX library this process loaded from its private directory.
_private_lib: list[str] = []


def load_both_libraries(private_dir) -> None:
    """Load the JAX package's host library from ``private_dir`` (once per
    process: later calls see it loaded) and the port's, and assert both."""
    lib = jax_build._lib
    if lib is None or not _private_lib or lib._name != _private_lib[0]:
        path = str(private_dir / "libnns_cpu.so")
        shared = jax_build._LIB
        jax_build._LIB = path
        jax_build._tried = False
        jax_build._lib = None
        try:
            if jax_build.load_library() is not None:
                _private_lib[:] = [path]
        finally:
            jax_build._LIB = shared
    assert jax_build._lib is not None, (
        "the JAX package's host library did not load from a private build; "
        "its numpy fallbacks build different trees than the port's native build")
    assert pt_build.load_library() is not None, "the port's host library did not load"


@pytest.fixture(scope="module")
def native_libraries(tmp_path_factory):
    """The guard (module docstring), once per test module."""
    load_both_libraries(tmp_path_factory.mktemp("jax_native"))


def test_both_libraries_load(tmp_path_factory):
    load_both_libraries(tmp_path_factory.mktemp("jax_native"))
    assert jax_build.native_available() and pt_build.native_available()


def _clustered_8192():
    # test_torch_beam.test_frontier_equals_jax's clustered octree case.
    return make_dataset(3, 1, 8192, seed=8192, clustered=True)[1]


def test_guard_repairs_a_failed_jax_loader(monkeypatch, tmp_path):
    # The state a worker is left in when it loaded a half-written library:
    # tried, nothing loaded, numpy fallbacks for the rest of the process.
    monkeypatch.setattr(jax_build, "_tried", True)
    monkeypatch.setattr(jax_build, "_lib", None)
    r = _clustered_8192()
    port = Octree.build(r)
    broken = JOctree.build(r)
    assert jax_build.load_library() is None
    assert not (np.array_equal(port.children, broken.children)
                and np.array_equal(port.order, broken.order)), (
        "the numpy fallback now equals the native build: this case no longer shows the fault")

    load_both_libraries(tmp_path)
    jax_tree = JOctree.build(r)
    np.testing.assert_array_equal(port.children, jax_tree.children)
    np.testing.assert_array_equal(port.order, jax_tree.order)
    pb = pbeam.octree_beam_index(port, 64, device="cpu")
    jb = jbeam.octree_beam_index(jax_tree, 64)
    for f in ("lo", "hi", "pts", "ids", "valid", "extras", "extras_ids"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)), f)


def test_guard_fails_when_the_jax_library_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_build, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(jax_build, "_lib", None)
    monkeypatch.setattr(jax_build, "_tried", False)
    with pytest.raises(AssertionError, match="JAX package's host library"):
        load_both_libraries(tmp_path)
