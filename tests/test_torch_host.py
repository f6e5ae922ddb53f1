"""Host layer of the PyTorch port against the JAX package: copied numpy
modules, torch layouts, the by-path native build, and the package's import
rules. Every comparison here is exact (byte-equal or equal): the code under
test does the same numpy or integer work as its counterpart."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nns_tpu.config as jax_config
import nns_tpu.data as jax_data
import nns_tpu.kernels.layouts as jax_layouts
import nns_tpu.kernels.oracle as jax_oracle
import nns_tpu.native as jax_native
import nns_tpu_torch.config as pt_config
import nns_tpu_torch.data as pt_data
import nns_tpu_torch.kernels.layouts as pt_layouts
import nns_tpu_torch.kernels.oracle as pt_oracle
import nns_tpu_torch.native as pt_native
from nns_tpu_torch.kernels.cell_list import CellListEngine

_PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "nns_tpu_torch")


@pytest.mark.parametrize("kwargs", [
    dict(k=3, m=64, n=1000, seed=1000),
    dict(k=16, m=8, n=777, seed=3),
    dict(k=3, m=32, n=5000, seed=1000, clustered=True),
    dict(k=5, m=16, n=4000, seed=7, clustered=True, sigma=0.02, n_clusters=9,
         anisotropy=20.0, powerlaw=True),
    dict(k=3, m=100, n=64, seed=1, query_box=(-0.5, 1.5)),
], ids=["uniform3", "uniform16", "clustered", "clustered_shaped", "query_box"])
def test_make_dataset_byte_equal(kwargs):
    q_j, r_j = jax_data.make_dataset(**kwargs)
    q_t, r_t = pt_data.make_dataset(**kwargs)
    assert q_t.dtype == q_j.dtype and r_t.dtype == r_j.dtype
    assert q_t.tobytes() == q_j.tobytes() and r_t.tobytes() == r_j.tobytes()


def test_config_fields_equal():
    assert pt_config.REFERENCE_GRID == jax_config.REFERENCE_GRID
    assert pt_config.DEFAULT_SEED == jax_config.DEFAULT_SEED
    for name in ("BenchConfig", "EngineConfig"):
        j = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_config, name))]
        t = [(f.name, f.default) for f in dataclasses.fields(getattr(pt_config, name))]
        assert t == j, name
    assert pt_config.DEFAULT_ENGINE_CONFIG == pt_config.EngineConfig()


def test_oracle_equal():
    q, r = pt_data.make_dataset(3, 200, 3000, seed=21)
    r[50] = r[7]  # an exact tie: both oracles keep the lower index
    q[0] = r[7]
    i_t, d_t = pt_oracle.nn_oracle_f64(q, r)
    i_j, d_j = jax_oracle.nn_oracle_f64(q, r)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert i_t[0] == 7
    np.testing.assert_array_equal(pt_oracle.linear_scan(q, r), jax_oracle.linear_scan(q, r))
    np.testing.assert_array_equal(pt_oracle._linear_scan_numpy(q, r), pt_oracle.linear_scan(q, r))
    wrong = i_t.copy()
    wrong[::3] = (wrong[::3] + 1) % r.shape[0]
    for idx in (i_t, wrong):
        assert pt_oracle.recall_at_1(idx, q, r) == jax_oracle.recall_at_1(idx, q, r)


def test_layouts_padding_contract():
    # layouts.py:8-15: refs pad with replicas of refs[0] (never zeros or a
    # sentinel), queries pad with zeros, dim-major is the transpose.
    rng = np.random.default_rng(2)
    r = rng.random((300, 5), dtype=np.float32) + np.float32(3.0)
    q = rng.random((13, 5), dtype=np.float32)
    pr = pt_layouts.pad_refs(torch.from_numpy(r), 128)
    assert pr.shape == (384, 5)
    assert (pr[300:] == pr[0]).all() and torch.equal(pr[:300], torch.from_numpy(r))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jax_layouts.pad_refs(jnp.asarray(r), 128)))
    pq = pt_layouts.pad_queries(torch.from_numpy(q), 8)
    assert pq.shape == (16, 5) and (pq[13:] == 0).all()
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jax_layouts.pad_queries(jnp.asarray(q), 8)))
    dm = pt_layouts.to_dim_major(pr)
    assert dm.is_contiguous() and torch.equal(dm, pr.t())
    assert pt_layouts.pad_refs(pr, 128) is pr  # already a multiple: no copy
    for x in (1, 7, 8, 9, 1000, 1024):
        assert pt_layouts.pow2_at_least(x) == jax_layouts.pow2_at_least(x)
        assert pt_layouts.round_up(x, 128) == jax_layouts.round_up(x, 128)
    assert pt_layouts.PAD_SENTINEL == jax_layouts.PAD_SENTINEL


@pytest.mark.parametrize("n,d", [(20000, 4), (50000, 5)])
def test_native_cells_build_byte_equal(n, d):
    assert pt_native.native_available() and jax_native.native_available()
    _, r = pt_data.make_dataset(3, 1, n, seed=n)
    mn = r.min(axis=0).astype(np.float64)
    w = ((r.max(axis=0) - r.min(axis=0)) / d).astype(np.float64)
    halo = 0.4 * float(w.min())
    got = pt_native.native_cells_build(r, d, halo, mn, w, 200_000, pt_layouts.PAD_SENTINEL)
    want = jax_native.native_cells_build(r, d, halo, mn, w, 200_000, jax_layouts.PAD_SENTINEL)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_native_cells_stage_byte_equal():
    q, r = pt_data.make_dataset(3, 5000, 10, seed=4)
    q[:7] = -1.0  # outside the box: clipped cells
    mn = np.zeros(3)
    w = np.full(3, 1.0 / 6)
    got = pt_native.native_cells_stage(q, 6, mn, w)
    want = jax_native.native_cells_stage(q, 6, mn, w)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_cell_stage_numpy_path_equals_native(monkeypatch):
    # stage() keeps the JAX package's numpy path for hosts without g++;
    # it must produce the native counting sort's exact staging.
    q, r = pt_data.make_dataset(3, 3000, 8192, seed=5)
    eng = CellListEngine(r, device="cpu")
    native = eng.stage(q)
    monkeypatch.setattr(pt_native, "native_cells_stage", lambda *a: None)
    numpy_path = eng.stage(q)
    assert native[2] == numpy_path[2]
    np.testing.assert_array_equal(native[0], numpy_path[0])
    np.testing.assert_array_equal(native[1], numpy_path[1])


def test_import_leaves_jax_out():
    code = ("import sys, nns_tpu_torch, nns_tpu_torch.convert, nns_tpu_torch.kernels, "
            "nns_tpu_torch.utils.timing; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'nns_tpu')))")
    root = os.path.dirname(_PORT_DIR)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.stdout.strip() == "[]", out.stdout


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(from|import)\s+(jax|nns_tpu)\b")
    offenders = []
    for dirpath, dirnames, files in os.walk(_PORT_DIR):
        dirnames[:] = [d for d in dirnames if d != "_build"]  # build output, not source
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for no, line in enumerate(fh, 1):
                        if pat.match(line):
                            offenders.append(f"{path}:{no}: {line.strip()}")
    assert not offenders, offenders


def test_cuda_build_raises_without_nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.fused import fused_min_idx

    if CUDA_HOME or shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.library()
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()
    # A tensor on neither the CPU nor a CUDA device is refused, never sent
    # to the plain version.
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_min_idx(meta, torch.empty((3, 8), device="meta"))
