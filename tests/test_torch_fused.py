"""v4 fused brute force of the PyTorch port against the JAX package, on CPU
torch (the plain version). The JAX side runs its Pallas kernel in interpret
mode, as its own CPU tests do.

Tolerances: indices exactly equal. min_d2 rtol 2**-21, atol 0 (D2_RTOL):
XLA's CPU backend may contract ``d2 + diff * diff`` into an FMA, which
rounds once where torch's CPU ops round the multiply and the add apart."""

import numpy as np
import pytest
import torch

import nns_tpu.kernels.cell_list as jax_cells
import nns_tpu.kernels.pallas_fused as jax_fused
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.convert import fused_from_numpy
from nns_tpu_torch.kernels import _cuda, fused, fused_ladder
from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.fused import (
    FusedBruteForce,
    fused_fallback,
    fused_min_idx,
    fused_plan,
    nns_fused,
    prepare_refs,
)
from nns_tpu_torch.kernels.oracle import recall_at_1

D2_RTOL = 2.0 ** -21  # FMA contraction on the XLA side only (module docstring)


def assert_same_idx(got, want, q, r):
    """Exact index equality. On a mismatch the message says whether both
    answers lie inside recall_at_1's f32 band (a tie no f32 engine can
    rank) — the test fails either way."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.flatnonzero(got != want)
    if len(bad):
        both_in_band = (recall_at_1(got[bad], q[bad], r) == 1.0
                        and recall_at_1(want[bad], q[bad], r) == 1.0)
        raise AssertionError(
            f"{len(bad)} indices differ (rows {bad[:8].tolist()}); both answers "
            f"inside recall_at_1's f32 band: {both_in_band}")


def _jax_min_idx(q, r, tile_m=256, tile_n=2048):
    r_dm, tn = jax_fused.prepare_refs(r, tile_n)
    d, i = jax_fused._fused_on_prepared(q, r_dm, tile_m, tn, interpret=True)
    return np.asarray(d), np.asarray(i)


def _port_min_idx(q, r, tile_n=2048):
    r_dm, _ = prepare_refs(r, tile_n, "cpu")
    d, i = fused_min_idx(torch.from_numpy(q), r_dm, r.shape[0])
    return d.numpy(), i.numpy()


def _compare(q, r, tile_m=256, tile_n=2048):
    d_j, i_j = _jax_min_idx(q, r, tile_m, tile_n)
    d_t, i_t = _port_min_idx(q, r, tile_n)
    assert i_t.dtype == np.int32 and d_t.dtype == np.float32
    assert_same_idx(i_t, i_j, q, r)
    # rtol D2_RTOL: XLA may fuse the multiply-add, torch does not.
    np.testing.assert_allclose(d_t, d_j, rtol=D2_RTOL, atol=0)
    return i_t


@pytest.mark.parametrize("case", range(6))
def test_plain_equals_jax_on_grid(case, grid_datasets):
    k, m, n, q, r = grid_datasets[case]
    idx = _compare(q, r)
    assert idx.shape == (m,)
    assert_exact(idx, q, r)


@pytest.mark.parametrize("k,m,n", [(3, 300, 5000), (3, 1, 5000), (5, 33, 777), (16, 300, 5000)])
def test_plain_equals_jax_unaligned(k, m, n):
    # m and n are not tile multiples: padding and ragged-edge paths.
    q, r = make_dataset(k, m, n, seed=m + n)
    _compare(q, r, tile_m=64, tile_n=1024)


@pytest.mark.parametrize("k,m,n", [(64, 9, 700), (128, 20, 300)])
def test_plain_equals_jax_at_high_k(k, m, n):
    # k past the template instances and past one 16-dim slice (the CUDA
    # kernel's sliced instance runs 4 and 8 slices here).
    q, r = make_dataset(k, m, n, seed=k + m)
    _compare(q, r, tile_m=8, tile_n=256)


def test_duplicate_refs_lowest_index():
    rng = np.random.default_rng(4)
    r = rng.random((8192, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    for w in (11, 4000, 8000):
        r[w] = target
    q = np.concatenate([target[None], rng.random((20, 3), dtype=np.float32)])
    idx = _compare(q, r, tile_n=1024)  # duplicates in different ref tiles
    assert idx[0] == 11


def test_all_equal_refs():
    r = np.full((3000, 4), 0.25, dtype=np.float32)
    q = np.random.default_rng(8).random((9, 4), dtype=np.float32)
    idx = _compare(q, r, tile_n=1024)
    np.testing.assert_array_equal(idx, np.zeros(9, np.int32))


def test_far_query_stays_in_range():
    # Replica padding: a query far outside the data cannot select padding.
    # At a 3e6 offset f32 cannot rank the candidates (the JAX package's
    # FMA-contracted sums pick another index here), so, as in
    # test_bruteforce.test_far_query_padding_in_range, the check is
    # in-range + within f32 resolution of the true minimum.
    rng = np.random.default_rng(7)
    r = rng.random((1000, 3), dtype=np.float32)
    q = np.array([[3e6, 3e6, 3e6]], dtype=np.float32)
    idx = nns_fused(q, r, device="cpu").numpy()
    assert 0 <= idx[0] < 1000
    d = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1)[0]
    assert d[idx[0]] <= d.min() * (1 + 4 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 33])
def test_fused_fallback_buckets(m):
    q, r = make_dataset(3, m, 4096, seed=50 + m)
    got = fused_fallback(q, r, device="cpu")
    assert got.shape == (m,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fused.fused_fallback(q, r)))
    # refs already on the device (the cell engine's call) give the same rows
    np.testing.assert_array_equal(fused_fallback(q, torch.from_numpy(r), device="cpu").numpy(),
                                  got.numpy())


def test_fused_engine_state_and_answers_equal_jax():
    q, r = make_dataset(3, 200, 10_000, seed=12)
    jax_eng = jax_fused.FusedBruteForce(r, tile_n=4096)
    eng = fused_from_numpy(r, tile_n=4096, device="cpu")
    assert isinstance(eng, FusedBruteForce) and eng.tile_n == jax_eng.tile_n
    np.testing.assert_array_equal(eng.r_dm.numpy(), np.asarray(jax_eng.r_dm))
    d_j, i_j = (np.asarray(a) for a in jax_eng.query_min_idx(q))
    d_t, i_t = (a.numpy() for a in eng.query_min_idx(q))
    assert_same_idx(i_t, i_j, q, r)
    np.testing.assert_allclose(d_t, d_j, rtol=D2_RTOL, atol=0)  # FMA on the XLA side only
    np.testing.assert_array_equal(eng.query(q).numpy(), i_t)


def test_cpu_path_launches_no_kernel():
    _cuda.reset_launches()
    q, r = make_dataset(3, 40, 2000, seed=3)
    FusedBruteForce(r, device="cpu").query(q)
    fused_fallback(q, r, device="cpu")
    assert set(_cuda.LAUNCHES) >= {"fused_argmin", "cell_scan"}
    assert set(_cuda.LAUNCHES.values()) == {0}


def test_fused_min_idx_rejects_bad_input():
    r_dm, _ = prepare_refs(np.zeros((10, 3), np.float32), 128, "cpu")
    with pytest.raises(ValueError):
        fused_min_idx(torch.zeros((2, 4)), r_dm)
    with pytest.raises(TypeError):
        fused_min_idx(torch.zeros((2, 3), dtype=torch.float64), r_dm)
    with pytest.raises(ValueError):
        fused_min_idx(torch.zeros((2, 3)), r_dm, n=0)


def test_cell_engine_fallback_stages_refs_once_and_equals_jax(monkeypatch):
    # Uncertified rows in two drains: the engine stages its dim-major refs
    # for the exact fallback once, at the first fallback, and every answer
    # equals the JAX package's.
    staged = []
    real = fused.prepare_refs

    def counting(*args, **kw):
        staged.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fused, "prepare_refs", counting)
    _, r = make_dataset(3, 1, 16384, seed=34)
    rng = np.random.default_rng(35)
    batches = [rng.random((200, 3), dtype=np.float32) * np.float32(3.0) - np.float32(1.0)
               for _ in range(2)]
    eng = CellListEngine(r, device="cpu")
    jeng = jax_cells.CellListEngine(r)
    assert staged == []
    for drain in range(2):
        res_t, cov_t = eng.query_queue(batches, return_coverage=True)
        res_j, cov_j = jeng.query_queue(batches, return_coverage=True)
        assert cov_t == cov_j and max(cov_t) < 1.0
        for a, b, qb in zip(res_t, res_j, batches):
            np.testing.assert_array_equal(a, b)
            assert_exact(a, qb, r)
        assert staged == [1], drain
    assert eng._fallback_engine().r_dm.shape == (3, 16384)


@pytest.mark.parametrize("m", [1, 8, 64, 300, 1024, 10000])
@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 40, 128, 4096, 20000])
def test_fused_plan_shapes(m, k):
    # The v4 plan is v5's ring plan with stages of one tensor-map box (at
    # most 256 columns), each 128-byte aligned behind 128 bytes of padded
    # barriers; past k = 16 its shared memory does not grow with k.
    optin = 232448
    plan = fused_plan(m, k, optin)
    ring = fused_ladder.ring_plan("dim_major", m, k, optin)
    assert (plan.q_rows, plan.threads_per_row, plan.dims, plan.stages) == (
        ring.q_rows, ring.threads_per_row, ring.dims, ring.stages)
    assert plan.cols == min(ring.cols, 256) and plan.cols % 4 == 0
    assert plan.dims * plan.cols * 4 % 128 == 0 and (16 * plan.stages + 64) % 128 == 0
    assert plan.smem_bytes == 64 + fused_ladder.ring_smem_bytes(
        "dim_major", k, plan.cols, plan.dims, plan.stages) <= optin
    assert plan.dims == k if k <= 16 else plan.dims <= 16 and plan.smem_bytes <= 65_664
    assert plan.q_tiles(m) * plan.rows_per_tile >= m
