"""Supercell engine (v14) of the PyTorch port against the JAX package, on
CPU torch (the plain scan). The JAX scan runs its Pallas kernel in interpret
mode, as its own CPU tests do.

Tolerances: ids, flags and indices exactly equal. min_d2 rtol 2**-21, atol
0 (D2_RTOL): XLA's CPU backend may contract ``d2 + diff * diff`` into an
FMA, which rounds once where torch's CPU ops round the multiply and the add
apart. The JAX kernel breaks exact ties by the smallest global id within a
halo tile and the port by the smallest global id overall; at these sizes
every R_max fits one JAX tile, so the two rules agree slot for slot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nns_tpu.kernels.cell_list as jax_cells
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.convert import cell_engine_from_numpy
from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, nns_cell_list

D2_RTOL = 2.0 ** -21  # FMA contraction on the XLA side only (module docstring)


def _jax_state(jeng):
    return {"refs": jeng.refs, "halo_dm": np.asarray(jeng.halo_dm),
            "halo_ids": np.asarray(jeng.halo_ids), "mn": jeng.mn, "W": jeng.W,
            "halo": jeng.halo, "D": jeng.D, "R_max": jeng.R_max}


def _queries_with_far_rows(m, seed):
    rng = np.random.default_rng(seed)
    q = rng.random((m, 3), dtype=np.float32)
    q[:5] = rng.random((5, 3), dtype=np.float32) * np.float32(3.0) - np.float32(1.0)
    return q


@pytest.mark.parametrize("n,kwargs", [(8192, {}), (32768, {}), (8192, dict(d_per_dim=12, halo=0.5))],
                         ids=["native8192", "native32768", "numpy_wide_halo"])
def test_halo_state_equals_jax(n, kwargs):
    _, r = make_dataset(3, 1, n, seed=1000)
    jeng = jax_cells.CellListEngine(r, device_place=False, **kwargs)
    eng = CellListEngine(r, device="cpu", **kwargs)
    assert (eng.D, eng.R_max, eng.halo) == (jeng.D, jeng.R_max, jeng.halo)
    np.testing.assert_array_equal(eng.mn, jeng.mn)
    np.testing.assert_array_equal(eng.W, jeng.W)
    assert eng.halo_dm.numpy().tobytes() == np.asarray(jeng.halo_dm).tobytes()
    assert eng.halo_ids.tobytes() == jeng.halo_ids.tobytes()
    assert eng.halo_dm.dtype == torch.float32 and eng.halo_ids_dev.dtype == torch.int32
    assert eng.avg_candidates == jeng.avg_candidates


@pytest.mark.parametrize("n", [8192, 32768])
def test_cell_scan_per_slot_equals_jax(n):
    _, r = make_dataset(3, 1, n, seed=n)
    jeng = jax_cells.CellListEngine(r)
    eng = cell_engine_from_numpy(_jax_state(jeng), device="cpu")
    packed, _, q_max = eng.stage(_queries_with_far_rows(600, n))
    dense, _ = eng._dense_scatter(packed, q_max)
    d_j, s_j = jax_cells._cell_scan(jnp.asarray(dense), jeng.halo_dm, jeng.halo_ids_dev,
                                    jnp.float32(jeng.halo) ** 2, interpret=True)
    d_t, s_t = cell_scan(torch.from_numpy(dense), eng.halo_dm, eng.halo_ids_dev, eng.halo2)
    assert s_t.shape == (eng.D ** 3, q_max)
    s_t = s_t.numpy()
    np.testing.assert_array_equal(s_t, np.asarray(s_j)[:, :, 0])
    assert (s_t < 0).any() and (s_t >= 0).any()  # both sides of the certificate
    # rtol D2_RTOL: XLA may fuse the multiply-add, torch does not.
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j)[:, :, 0], rtol=D2_RTOL, atol=0)


@pytest.mark.parametrize("m,n", [(64, 8192), (200, 32768), (1, 8192)])
def test_cell_list_exact(m, n):
    q, r = make_dataset(3, m, n, seed=1000)
    idx = nns_cell_list(q, r, device="cpu")
    assert idx.dtype == np.int32 and idx.shape == (m,)
    assert_exact(idx, q, r)
    np.testing.assert_array_equal(idx, jax_cells.nns_cell_list(q, r))


def test_query_with_flags_equals_jax():
    q, r = make_dataset(3, 1, 16384, seed=14)
    q = _queries_with_far_rows(400, 14)
    jeng = jax_cells.CellListEngine(r)
    eng = CellListEngine(r, device="cpu")
    idx_j, ok_j, d_j = jeng.query_with_flags_dist(q)
    idx_t, ok_t, d_t = eng.query_with_flags_dist(q)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t.all() and ok_t.any()
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(d_t, d_j, rtol=D2_RTOL, atol=0)  # FMA on the XLA side only
    # certified rows are true nearest neighbours
    assert_exact(idx_t[ok_t], q[ok_t], r)


def test_cell_list_far_query_fallback():
    _, r = make_dataset(3, 1, 8192, seed=2)
    r = r * np.float32(0.1)  # compress cloud
    q = np.array([[0.95, 0.95, 0.95]], dtype=np.float32)
    eng = CellListEngine(r, device="cpu")
    idx, ok = eng.query_with_flags(q)
    assert not ok.all()  # certificate correctly rejects
    assert_exact(eng.query(q), q, r)


def test_cell_list_empty_supercell():
    rng = np.random.default_rng(3)
    r = (rng.random((8192, 3)) * 0.3).astype(np.float32)
    q = rng.random((32, 3)).astype(np.float32)
    assert_exact(nns_cell_list(q, r, device="cpu"), q, r)


def test_cell_list_duplicate_lowest_index():
    rng = np.random.default_rng(4)
    r = rng.random((8192, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    for w in (11, 4000, 8000):
        r[w] = target
    q = target[None, :]
    assert CellListEngine(r, device="cpu").query(q)[0] == 11


def test_cell_list_clustered_overflow_guard():
    # Extremely clustered data must either work exactly or raise the
    # overflow guard (and the wrapper falls back to the fused kernel).
    rng = np.random.default_rng(5)
    r = (rng.normal(0, 0.001, (8192, 3)) + 0.5).astype(np.float32)
    q = rng.random((16, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="overflow"):
        CellListEngine(r, max_candidates=1000, device="cpu")
    assert_exact(nns_cell_list(q, r, device="cpu"), q, r)


def test_cell_list_oversized_halo_clamped_stays_exact():
    q, r = make_dataset(3, 64, 8192, seed=9)
    eng = CellListEngine(r, d_per_dim=12, halo=0.5, device="cpu")
    assert eng.halo <= eng.W.min() + 1e-12
    assert_exact(eng.query(q), q, r)


def test_cell_list_skewed_batch_guard():
    # All queries in one supercell: q_max would exceed the kernel's bound;
    # stage() must refuse and query() must fall back exactly.
    rng = np.random.default_rng(10)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r, device="cpu")
    m = eng.q_max_limit() * 2
    q = (np.float32(0.5) + rng.random((m, 3), dtype=np.float32) * np.float32(1e-4))
    packed, order, q_max = eng.stage(q)
    assert packed is None and q_max is None
    idx, ok = eng.query_with_flags(q)
    assert not ok.any()
    idx = eng.query(q)
    assert_exact(idx[:64], q[:64], r)  # subsample keeps the oracle cheap


def test_ragged_queue_mixed_q_max_matches_single_batch():
    rng = np.random.default_rng(31)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r, device="cpu")
    uniform = [rng.random((400, 3), dtype=np.float32) for _ in range(2)]
    skewed = (rng.random((400, 3), dtype=np.float32) * 0.02).astype(np.float32)
    batches = [uniform[0], skewed, uniform[1]]
    denses, fslots, orders = eng.stage_queue_ragged(batches)
    qms = [d.shape[1] for d in denses]
    assert qms[1] > qms[0] and qms[0] == qms[2]
    out = eng.query_queue_staged(denses)
    assert isinstance(out, tuple) and len(out) == 3
    assert [tuple(o.shape) for o in out] == [(eng.D ** 3, qm) for qm in qms]
    served = eng.query_queue(batches)
    for w, qb in enumerate(batches):
        idx_q, ok_q = eng.unscatter_queue(out[w].numpy(), fslots[w], orders[w])
        idx_single, ok_single = eng.query_with_flags(qb)
        np.testing.assert_array_equal(ok_q, ok_single)
        np.testing.assert_array_equal(idx_q, idx_single)
        np.testing.assert_array_equal(served[w], eng.query(qb))
        assert_exact(served[w], qb, r)


def test_query_queue_equals_jax_with_fallback_rows():
    _, r = make_dataset(3, 1, 16384, seed=33)
    batches = [_queries_with_far_rows(300, s) for s in (1, 2)]
    batches.append(np.random.default_rng(9).random((50, 3), dtype=np.float32))
    jeng = jax_cells.CellListEngine(r)
    eng = CellListEngine(r, device="cpu")
    res_t, cov_t = eng.query_queue(batches, return_coverage=True)
    res_j, cov_j = jeng.query_queue(batches, return_coverage=True)
    assert cov_t == cov_j and min(cov_t) < 1.0
    for a, b, qb in zip(res_t, res_j, batches):
        np.testing.assert_array_equal(a, b)
        assert_exact(a, qb, r)


def test_query_dist_upper_bounds_true_nn():
    q, r = make_dataset(3, 128, 16384, seed=14)
    eng = CellListEngine(r, device="cpu")
    idx, ok, d2 = eng.query_with_flags_dist(q)
    true_d2 = np.min(
        np.sum((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2, axis=-1),
        axis=1,
    )
    assert (d2 >= true_d2 - 1e-9).all()


def test_convert_rejects_bad_state():
    _, r = make_dataset(3, 1, 8192, seed=1)
    state = _jax_state(jax_cells.CellListEngine(r, device_place=False))
    with pytest.raises(KeyError):
        cell_engine_from_numpy({k: v for k, v in state.items() if k != "halo_ids"}, "cpu")
    with pytest.raises(ValueError):
        cell_engine_from_numpy({**state, "R_max": state["R_max"] + 256}, "cpu")
