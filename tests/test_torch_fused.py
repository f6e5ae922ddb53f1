"""v4 fused brute force of the PyTorch port against the JAX package, on CPU
torch (the plain version). The JAX side runs its Pallas kernel in interpret
mode, as its own CPU tests do.

Tolerances: indices exactly equal. min_d2 rtol 2**-21, atol 0 (D2_RTOL):
XLA's CPU backend may contract ``d2 + diff * diff`` into an FMA, which
rounds once where torch's CPU ops round the multiply and the add apart."""

import numpy as np
import pytest
import torch

import nns_tpu.kernels.pallas_fused as jax_fused
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.convert import fused_from_numpy
from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels.fused import (
    FusedBruteForce,
    fused_fallback,
    fused_min_idx,
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
