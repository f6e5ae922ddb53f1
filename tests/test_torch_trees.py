"""Host trees of the PyTorch port against the JAX package: the native
library's own source, its KD and octree bindings, the copied ``KDTree`` and
``Octree`` (native and numpy builds, host queries, npz files), and v10-v13
through ``nns`` and ``NNEngine``.

Tolerances: the host trees do the same numpy or C++ work as their
counterparts, so their arrays and the v10/v12 index arrays must be equal.
v11 and v13 must reach recall@1 = 1.0 against the f64 oracle (their beam
queries may break an exact tie another way than the JAX package)."""

import os

import numpy as np
import pytest
import torch

import nns_tpu
import nns_tpu.native as jax_native
import nns_tpu_torch
import nns_tpu_torch.native as pt_native
import nns_tpu_torch.native.build as pt_native_build
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu.trees.kdtree import KDTree as JKDTree
from nns_tpu.trees.octree import Octree as JOctree
from nns_tpu_torch.kernels.fused import FusedBruteForce
from nns_tpu_torch.trees.beam import BeamIndex
from nns_tpu_torch.trees.kdtree import KDTree
from nns_tpu_torch.trees.octree import Octree
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: its numpy fallbacks
# build other trees (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KD_CASES = [(3, 200, 4096), (16, 64, 2048), (2, 50, 333), (3, 1, 1)]
OCT_CASES = [(1, 1024), (200, 4096), (64, 513)]


def _clustered(n, seed):
    q, r = make_dataset(3, 128, n, seed=seed, clustered=True)
    return q, r


def test_native_source_is_the_jax_package_copy():
    # The port builds its host library from its own copy of nns_cpu.cpp,
    # which must stay byte-equal to the JAX package's.
    with open(os.path.join(_ROOT, "nns_tpu", "native", "nns_cpu.cpp"), "rb") as f:
        want = f.read()
    with open(pt_native_build._SRC, "rb") as f:
        got = f.read()
    assert os.path.dirname(pt_native_build._SRC) == os.path.join(_ROOT, "nns_tpu_torch", "native")
    assert got == want


@pytest.mark.parametrize("k,m,n", KD_CASES)
def test_native_kd_build_and_query_equal(k, m, n):
    q, r = make_dataset(k, m, n, seed=1000)
    got, want = pt_native.native_kd_build(r), jax_native.native_kd_build(r)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(pt_native.native_kd_query(r, q, *got),
                                  jax_native.native_kd_query(r, q, *want))


@pytest.mark.parametrize("kwargs", [dict(n=4096, seed=3), dict(n=8192, seed=4, clustered=True)])
def test_native_octree_build_and_query_equal(kwargs):
    q, r = make_dataset(3, 100, **kwargs)
    got, want = pt_native.native_octree_build(r, 9), jax_native.native_octree_build(r, 9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(Octree.build(r).query_host(q), JOctree.build(r).query_host(q))


def test_native_kd_build_refuses_high_k():
    _, r = make_dataset(20, 1, 64, seed=1)
    assert pt_native.native_kd_build(r) is None
    assert pt_native.native_octree_build(r, 9) is None


@pytest.mark.parametrize("k,m,n", KD_CASES)
def test_kdtree_equals_jax(k, m, n):
    q, r = make_dataset(k, m, n, seed=1000)
    got, want = KDTree.build(r), JKDTree.build(r)
    for f in ("refs", "node_point", "node_dim"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.depth == want.depth
    np.testing.assert_array_equal(got.query_host(q), want.query_host(q))


@pytest.mark.parametrize("k,m,n", [(3, 64, 1000), (5, 40, 777)])
def test_kdtree_numpy_paths_equal_jax(k, m, n, monkeypatch):
    # The numpy build and the numpy stackless query, for hosts without g++.
    q, r = make_dataset(k, m, n, seed=7)
    got, want = KDTree._build_numpy(r), JKDTree._build_numpy(r)
    for f in ("node_point", "node_dim"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.depth == want.depth
    monkeypatch.setattr(pt_native, "native_kd_query", lambda *a: None)
    monkeypatch.setattr(jax_native, "native_kd_query", lambda *a: None)
    idx = got.query_host(q)
    np.testing.assert_array_equal(idx, want.query_host(q))
    assert_exact(idx, q, r)


@pytest.mark.parametrize("m,n", OCT_CASES)
def test_octree_equals_jax(m, n):
    q, r = make_dataset(3, m, n, seed=1000)
    got, want = Octree.build(r), JOctree.build(r)
    for f in ("refs", "children", "center", "radius", "start", "count", "order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.query_host(q), want.query_host(q))


def test_octree_numpy_paths_equal_jax(monkeypatch):
    q, r = _clustered(3000, 5)
    got, want = Octree._build_numpy(r, 6), JOctree._build_numpy(r, 6)
    for f in ("children", "center", "radius", "start", "count", "order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    monkeypatch.setattr(pt_native, "native_octree_query", lambda *a: None)
    monkeypatch.setattr(jax_native, "native_octree_query", lambda *a: None)
    idx = got.query_host(q)
    np.testing.assert_array_equal(idx, want.query_host(q))
    assert_exact(idx, q, r)


def test_octree_rejects_other_k():
    _, r = make_dataset(4, 1, 100, seed=2)
    with pytest.raises(ValueError, match="3-D"):
        Octree.build(r)


def test_tree_files_load_across_packages(tmp_path):
    q, r = _clustered(4096, 8)
    for ours, theirs in ((KDTree, JKDTree), (Octree, JOctree)):
        a, b = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
        ours.build(r).save(a)
        theirs.build(r).save(b)
        want = theirs.build(r).query_host(q)
        np.testing.assert_array_equal(theirs.load(a).query_host(q), want)
        np.testing.assert_array_equal(ours.load(b).query_host(q), want)
        np.testing.assert_array_equal(ours.load(a).query_host(q), want)


@pytest.mark.parametrize("version", [10, 12])
@pytest.mark.parametrize("k,m,n", [(3, 200, 4096), (3, 64, 20000), (5, 30, 1000), (20, 16, 512)])
def test_host_tree_versions_equal_jax(version, k, m, n):
    # v10 answers k <= 16 on its KD-tree, v12 k == 3 on its octree; both
    # take the linear scan otherwise.
    q, r = make_dataset(k, m, n, seed=k * m)
    got = nns_tpu_torch.nns(q, r, version=version, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(nns_tpu.nns(q, r, version=version)))
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    np.testing.assert_array_equal(eng.query(q), got)


@pytest.mark.parametrize("version", [11, 13])
@pytest.mark.parametrize("k,m,n,clustered", [(3, 200, 4096, False), (3, 128, 8192, True),
                                             (5, 30, 1000, False), (16, 20, 2048, False),
                                             (20, 16, 512, False)])
def test_device_tree_versions_exact(version, k, m, n, clustered):
    q, r = make_dataset(k, m, n, seed=k * m, clustered=clustered)
    got = nns_tpu_torch.nns(q, r, version=version, device="cpu")
    assert got.dtype == np.int32
    assert_exact(got, q, r)
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    assert_exact(eng.query(q), q, r)
    parts = eng.query_many([q[: m // 2], q[m // 2:]])
    assert_exact(np.concatenate(parts), q, r)


@pytest.mark.parametrize("version,k,expect", [
    (10, 3, KDTree), (10, 20, type(None)), (11, 3, KDTree), (11, 16, FusedBruteForce),
    (11, 20, type(None)), (12, 3, Octree), (12, 5, type(None)), (13, 3, Octree),
    (13, 16, FusedBruteForce)])
def test_tree_engine_builds_what_jax_builds(version, k, expect):
    # nns_tpu/api.py:504-541: the tree, the staged fused engine past the
    # tree's k (v11, v13), or nothing (host scans).
    q, r = make_dataset(k, 16, 2048, seed=9)
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    jeng = nns_tpu.NNEngine(version).build(r)
    assert type(eng._built) is expect
    assert type(eng._built).__name__ == type(jeng._built).__name__
    if version in (11, 13) and k == 3:
        assert isinstance(eng._built._beam, BeamIndex)  # the frontier staged at build
    assert_exact(eng.query(q), q, r)


@pytest.mark.parametrize("tree_cls", [KDTree, Octree])
def test_device_index_is_built_once_per_device(tree_cls):
    # The frontier is kept: a device given by name or as a torch.device
    # reuses it (a rebuild per query cost 250 ms per 10K batch at 1M refs
    # on an H100).
    _, r = make_dataset(3, 1, 4096, seed=12)
    tree = tree_cls.build(r)
    first = tree.device_index("cpu")
    assert tree.device_index(torch.device("cpu")) is first
    q = r[:5] + np.float32(1e-3)
    assert_exact(tree.query_device(q, "cpu"), q, r)
    assert tree._beam is first


def test_tree_edge_cases_exact():
    # Duplicates beyond the octree's depth, one point, the corner-neighbour
    # case the reference's octant heuristic misses (tests/test_octree.py).
    rng = np.random.default_rng(0)
    dup = np.concatenate([np.repeat(np.array([[0.25] * 3], np.float32), 100, 0),
                          np.array([[0.8] * 3], np.float32)])
    corner = np.concatenate([np.array([[0.49] * 3, [0.9] * 3], np.float32),
                             rng.random((62, 3), dtype=np.float32) * 0.2
                             + np.array([0, 0, 0.8], np.float32)])
    for r, q in ((dup, np.array([[0.3] * 3, [0.9] * 3], np.float32)),
                 (np.array([[0.5] * 3], np.float32), np.array([[0.1, 0.9, 0.3]], np.float32)),
                 (corner, np.array([[0.51] * 3], np.float32))):
        for version in (10, 11, 12, 13):
            assert_exact(nns_tpu_torch.nns(q, r, version=version, device="cpu"), q, r)
