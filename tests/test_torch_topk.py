"""Exact k-NN of the PyTorch port against the JAX package, on CPU torch:
``nns_topk`` (the chunked scan), ``CellListEngine.query_topk`` (the
supercell index's k-NN with its certificate) and ``NNEngine.query_topk``
over every engine.

Tolerances: distances within rtol 1e-6 of the JAX package's (its XLA may
contract a sum into an FMA); ids equal wherever a row's distances are
distinct, and in the JAX package's (distance, index) order on duplicate
points; the f64 distances of the returned ids equal the f64 oracle's top k
within rtol 1e-5 (as tests/test_api.py holds the JAX package)."""

import numpy as np
import pytest

import nns_tpu
import nns_tpu_torch
from nns_tpu.data import make_dataset
from nns_tpu.kernels.cell_list import CellListEngine as JCellListEngine
from nns_tpu.kernels.topk import nns_topk as jax_topk
from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.topk import direct_d2, nns_topk, smallest, sort_keys, split_keys


def _oracle_d(q, r, kk):
    d = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    return np.sort(d, axis=1)[:, :kk]


def _check_against_oracle(d2, idx, q, r, kk):
    assert idx.shape == (q.shape[0], kk) and idx.dtype == np.int32 and d2.dtype == np.float32
    d_ours = ((q[:, None].astype(np.float64) - r[idx].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(d_ours, 1), _oracle_d(q, r, kk), rtol=1e-5, atol=1e-9)
    assert (np.diff(d2, axis=1) >= 0).all()


def _equal_to_jax(got, want):
    (d2, idx), (jd2, jidx) = got, want
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)
    distinct = (np.diff(jd2, axis=1) > 0).all(axis=1)
    np.testing.assert_array_equal(idx[distinct], jidx[distinct])


@pytest.mark.parametrize("k,m,n,kk,chunk", [(3, 32, 4096, 8, 8192), (16, 16, 2048, 4, 8192),
                                            (3, 8, 100000, 8, 8192), (5, 20, 3000, 16, 1000),
                                            (3, 40, 5000, 1, 65536)])
def test_nns_topk_equals_jax(k, m, n, kk, chunk):
    q, r = make_dataset(k, m, n, seed=1000)
    got = nns_topk(q, r, kk, chunk_n=chunk, device="cpu")
    _equal_to_jax(got, jax_topk(q, r, kk, chunk_n=chunk))
    _check_against_oracle(*got, q, r, kk)


@pytest.mark.parametrize("chunk", [512, 3000, 65536])
def test_nns_topk_duplicate_order_equals_jax(chunk):
    # Ties across chunks: the lower index first, as the JAX package's
    # lexsort orders them.
    rng = np.random.default_rng(0)
    r = rng.random((4096, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    dups = [7, 1000, 2000, 3000, 3001, 4095]
    for w in dups:
        r[w] = target
    q = np.stack([target, target + np.float32(1e-4)])
    d2, idx = nns_topk(q, r, 6, chunk_n=chunk, device="cpu")
    _, jidx = jax_topk(q, r, 6, chunk_n=chunk)
    assert idx[0].tolist() == dups
    np.testing.assert_array_equal(idx, jidx)
    assert (d2[0] == 0).all()


def test_nns_topk_k_exceeds_n():
    q, r = make_dataset(3, 4, 5, seed=1)
    d2, idx = nns_topk(q, r, 10, device="cpu")
    jd2, jidx = jax_topk(q, r, 10)
    assert idx.shape == jidx.shape == (4, 5)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)


def test_nns_topk_has_no_phantom_points():
    # The JAX package pads the last chunk with points at 1e6; a query there
    # gets those pads (indices past n) as its neighbours. The port's last
    # chunk is shorter, so its answers are real points.
    r = np.array([[0.0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 3, 3], [4, 4, 4]], np.float32)
    q = np.array([[1e6, 1e6, 1e6]], np.float32)
    _, jidx = jax_topk(q, r, 3, chunk_n=4)
    assert (jidx >= r.shape[0]).any()
    d2, idx = nns_topk(q, r, 3, chunk_n=4, device="cpu")
    assert idx[0].tolist() == [4, 3, 2]
    _check_against_oracle(d2, idx, q, r, 3)


def test_sort_keys_order_and_smallest():
    d2 = np.array([[0.5, 0.0, 0.5, np.inf, 0.25, 0.0]], np.float32)
    import torch

    keys = sort_keys(torch.from_numpy(d2), torch.arange(6, dtype=torch.int32)[None])
    back_d, back_i = split_keys(keys)
    np.testing.assert_array_equal(back_d.numpy(), d2)
    assert back_i.tolist() == [[0, 1, 2, 3, 4, 5]]
    vals, cols = smallest(torch.from_numpy(d2), 5)
    assert cols.tolist() == [[1, 5, 4, 0, 2]]
    assert vals.tolist() == [[0.0, 0.0, 0.25, 0.5, 0.5]]


@pytest.mark.parametrize("k", [3, 16])
def test_direct_d2_shared_and_gathered_candidates(k):
    # One accumulation for every exact path: a shared (1, c, k) candidate
    # set and the same points gathered per query (m, g, c, k) give the same
    # bits, and both are the per-dimension sum in ascending order.
    import torch

    rng = np.random.default_rng(31)
    q = torch.as_tensor(rng.random((5, k), dtype=np.float32))
    r = torch.as_tensor(rng.random((40, k), dtype=np.float32))
    shared = direct_d2(q, r[None])
    gathered = direct_d2(q, r.reshape(1, 4, 10, k).expand(5, -1, -1, -1))
    assert shared.shape == (5, 40) and gathered.shape == (5, 4, 10)
    assert torch.equal(gathered.reshape(5, 40), shared)
    want = torch.zeros((5, 40))
    for d in range(k):
        diff = q[:, d, None] - r[None, :, d]
        want = want + diff * diff
    assert torch.equal(shared, want)


@pytest.mark.parametrize("k_nn", [1, 8, 30])
@pytest.mark.parametrize("kwargs", [dict(seed=21), dict(seed=22, query_box=(-0.3, 1.3))])
def test_cell_topk_equals_jax(k_nn, kwargs):
    q, r = make_dataset(3, 300, 16384, **kwargs)
    got = CellListEngine(r, device="cpu").query_topk(q, k_nn)
    _equal_to_jax(got, JCellListEngine(r).query_topk(q, k_nn))
    _check_against_oracle(*got, q, r, k_nn)


def test_cell_topk_certificate_and_fallbacks(monkeypatch):
    # The index's own k-NN certifies most uniform rows; rows past the halo,
    # more neighbours than halo slots, and a batch too skewed to stage take
    # the exact scan.
    import nns_tpu_torch.kernels.cell_list as cl
    import nns_tpu_torch.kernels.topk as topk

    q, r = make_dataset(3, 200, 16384, seed=23)
    eng = CellListEngine(r, device="cpu")
    rows = []
    real = topk.nns_topk

    def counting(qq, *a, **k):
        rows.append(len(qq))
        return real(qq, *a, **k)

    monkeypatch.setattr(cl, "nns_topk", counting)
    far = np.concatenate([q, q[:10] + np.float32(3.0)])
    d2, idx = eng.query_topk(far, 8)
    _check_against_oracle(d2, idx, far, r, 8)
    assert rows and 10 <= rows[0] < 60
    rows.clear()
    d2, idx = eng.query_topk(q[:20], eng.R_max + 1)
    assert rows == [20]
    _check_against_oracle(d2, idx, q[:20], r, eng.R_max + 1)
    rows.clear()
    skew = np.repeat(q[:1], 4000, axis=0)
    assert eng.stage(skew)[0] is None
    d2, idx = eng.query_topk(skew, 3)
    assert rows == [4000]
    np.testing.assert_array_equal(idx, np.repeat(idx[:1], 4000, axis=0))


@pytest.mark.parametrize("version", [4, 9, 10, 11, 12, 13, 14])
def test_engine_query_topk_equals_jax(version):
    # Every engine answers; the supercell index (v14) through its own k-NN,
    # the others through the exact scan (nns_tpu/api.py:694-713).
    k = 16 if version == 9 else 3
    q, r = make_dataset(k, 32, 8192, seed=version)
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    got = eng.query_topk(q, 4)
    _equal_to_jax(got, nns_tpu.NNEngine(version).build(r).query_topk(q, 4))
    _check_against_oracle(*got, q, r, 4)
    with pytest.raises(ValueError, match="dimension mismatch"):
        eng.query_topk(q[:, :2], 4)
