"""The port's sharded supercell engine (``parallel/sharded_cells.py``)
against the JAX package's, on CPU torch: every case of
tests/test_sharded_cells.py but the trace bound (the port traces nothing).
The port runs on ``Mesh.virtual(D, "cpu")`` (one CPU repeated D times: D
group ranges, D plain scans and the real gather), the JAX package on
``make_mesh(D)`` of the 8 virtual CPU devices that tests/conftest.py gives
it.

Tolerances: indices and certified flags exactly equal to the JAX package's
and to the single-device engine's; the winner tables of a drain bit-equal
to the single-device engine's; best_d2 of ``query_collect_dist`` exactly
equal to the JAX package's (both recompute it in float64 on the host from
the same candidate); k-NN ids exactly equal, and k-NN d2 within rtol
2**-21 of the JAX package's (XLA may contract the multiply-add into an FMA)
and equal to the single-device engine's."""

import numpy as np
import pytest
import torch

import nns_tpu.kernels.cell_list as jax_cells
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu.parallel import sharded_cells as jax_sc
from nns_tpu.parallel.mesh import make_mesh
from nns_tpu_torch.kernels.cell_list import CellListEngine, _upload, cell_scan
from nns_tpu_torch.parallel.mesh import Mesh
from nns_tpu_torch.parallel.sharded_cells import ShardedCellEngine, nns_sharded_cells
from test_torch_native import native_libraries  # noqa: F401  (the guard)

pytestmark = pytest.mark.usefixtures("native_libraries")

D2_RTOL = 2.0 ** -21


def _virtual(n_dev):
    return Mesh.virtual(n_dev, "cpu")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_cells_exact(n_dev):
    q, r = make_dataset(3, 128, 16384, seed=1000)
    eng = ShardedCellEngine(r, _virtual(n_dev))
    assert (eng.n_dev, eng.g_local * n_dev) == (n_dev, eng.g_pad)
    got = eng.query(q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_sc.ShardedCellEngine(r, make_mesh(n_dev)).query(q))
    assert_exact(got, q, r)


def test_sharded_cells_matches_single_chip():
    q, r = make_dataset(3, 64, 8192, seed=2)
    single = CellListEngine(r, device="cpu").query(q)
    np.testing.assert_array_equal(ShardedCellEngine(r, _virtual(8)).query(q), single)
    np.testing.assert_array_equal(single, jax_cells.CellListEngine(r).query(q))


def test_sharded_cells_group_padding():
    # G = 27 on 8 shards: 5 sentinel-only groups pad the last range.
    q, r = make_dataset(3, 32, 8192, seed=3)
    eng = ShardedCellEngine(r, _virtual(8), d_per_dim=3)
    assert (eng.D ** 3, eng.g_pad, eng.g_local) == (27, 32, 4)
    assert eng.shards[-1][1].shape == (4, 3, eng.R_max)
    assert (eng.shards[-1][1][3:] == 1e6).all()
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(8), d_per_dim=3)
    assert jeng.g_pad == eng.g_pad
    np.testing.assert_array_equal(eng.query(q), jeng.query(q))
    assert_exact(eng.query(q), q, r)


def test_sharded_cells_certificate_fallback():
    _, r = make_dataset(3, 1, 8192, seed=4)
    r = r * np.float32(0.1)
    q = np.array([[0.9, 0.9, 0.9]], dtype=np.float32)
    eng = ShardedCellEngine(r, _virtual(4))
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(4))
    idx, ok = eng.query_with_flags(q)
    assert not ok.all()
    idx_j, ok_j = jeng.query_with_flags(q)
    np.testing.assert_array_equal(ok, ok_j)
    # The JAX sharded engine leaves an uncertified row's id sign-encoded
    # (-id-1); the port decodes it, as both single-device engines do.
    np.testing.assert_array_equal(idx, np.where(idx_j >= 0, idx_j, -idx_j - 1))
    got = eng.query(q)
    np.testing.assert_array_equal(got, jeng.query(q))
    assert_exact(got, q, r)


def test_nns_sharded_cells_wrapper():
    q, r = make_dataset(3, 64, 8192, seed=5)
    got = nns_sharded_cells(q, r, mesh=_virtual(8))
    np.testing.assert_array_equal(got, jax_sc.nns_sharded_cells(q, r, mesh=make_mesh(8)))
    assert_exact(got, q, r)
    # non-3-D routes to brute force; one device to the single-device index
    q2, r2 = make_dataset(5, 16, 4096, seed=6)
    got2 = nns_sharded_cells(q2, r2, mesh=_virtual(8))
    np.testing.assert_array_equal(got2, jax_sc.nns_sharded_cells(q2, r2, mesh=make_mesh(8)))
    np.testing.assert_array_equal(nns_sharded_cells(q, r, device="cpu"), got)


def test_sharded_queue_drain_matches_per_batch():
    # The drain (per-shard scans, tables gathered to devices[0], one
    # download) against per-batch queries of both packages, with a mixed
    # q_max queue (two skewed batches take a larger tier) at W = 12; its
    # winner tables against the single-device engine's, table for table.
    rng = np.random.default_rng(55)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, _virtual(8))
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(8))
    single = CellListEngine(r, device="cpu")

    def skew(m=400):
        return (rng.random((m, 3), dtype=np.float32) * 0.02).astype(np.float32)

    queue = [rng.random((400, 3), dtype=np.float32) for _ in range(10)]
    queue.insert(2, skew())
    queue.insert(5, skew())
    out, covs = eng.query_queue(queue, return_coverage=True)
    out_s, covs_s = single.query_queue(queue, return_coverage=True)
    assert covs == covs_s
    for qb, idx, idx_s in zip(queue, out, out_s):
        np.testing.assert_array_equal(idx, idx_s)
        np.testing.assert_array_equal(idx, eng.query(qb))
        assert_exact(idx, qb, r)
    for qb in queue[:3]:
        np.testing.assert_array_equal(eng.query(qb), jeng.query(qb))
    denses, _, _ = eng.stage_queue_ragged(queue)
    assert len({d.shape[1] for d in denses}) >= 2
    G = eng.D ** 3
    for t, t_s in zip(eng.query_queue_staged(denses), single.query_queue_staged(denses)):
        assert t.shape == (eng.g_pad, t_s.shape[1])
        np.testing.assert_array_equal(t[:G].numpy(), t_s.numpy())


def test_sharded_submit_collect_pipeline():
    rng = np.random.default_rng(60)
    r = rng.random((16384, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, _virtual(8))
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(8))
    q1 = rng.random((300, 3), dtype=np.float32)
    q2 = rng.random((300, 3), dtype=np.float32)
    t1 = eng.query_submit(q1)
    t2 = eng.query_submit(q2)
    assert t1.winners.shape == (1, 300)
    idx1, ok1 = eng.query_collect(t1)
    idx2, ok2 = eng.query_collect(t2)
    ref1, rok1 = eng.query_with_flags(q1)
    np.testing.assert_array_equal(idx1, ref1)
    np.testing.assert_array_equal(ok1, rok1)
    for q, idx, ok in ((q1, idx1, ok1), (q2, idx2, ok2)):
        idx_j, ok_j = jeng.query_collect(jeng.query_submit(q))
        np.testing.assert_array_equal(ok, ok_j)
        np.testing.assert_array_equal(idx[ok], np.asarray(idx_j)[ok])
        assert_exact(idx[ok], q[ok], r)
    # Skewed batch: submit returns a token without winners, collect is all-bad.
    qs = (rng.random((2100, 3), dtype=np.float32) * 1e-4).astype(np.float32)
    ts = eng.query_submit(qs)
    assert ts.winners is None
    _, oks = eng.query_collect(ts)
    assert not oks.any()
    _, oks_j = jeng.query_collect(jeng.query_submit(qs))
    np.testing.assert_array_equal(oks, oks_j)


def test_sharded_save_load_roundtrip(tmp_path):
    # The checkpoint is placement-free: it restores onto another mesh size
    # and as a single-device engine, and files cross the two packages.
    rng = np.random.default_rng(61)
    r = rng.random((16384, 3), dtype=np.float32)
    q = rng.random((256, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, _virtual(4))
    want = eng.query(q)
    p = str(tmp_path / "cells.npz")
    eng.save(p)
    re8 = ShardedCellEngine.load(p, _virtual(8))
    assert re8.g_pad % 8 == 0
    np.testing.assert_array_equal(re8.query(q), want)
    np.testing.assert_array_equal(CellListEngine.load(p, device="cpu").query(q), want)
    np.testing.assert_array_equal(jax_sc.ShardedCellEngine.load(p, make_mesh(2)).query(q), want)
    np.testing.assert_array_equal(jax_cells.CellListEngine.load(p).query(q), want)
    pj = str(tmp_path / "cells_jax.npz")
    jax_sc.ShardedCellEngine(r, make_mesh(8)).save(pj)
    with np.load(p) as a, np.load(pj) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], key)
    np.testing.assert_array_equal(ShardedCellEngine.load(pj, _virtual(2)).query(q), want)
    assert_exact(want, q, r)


def test_sharded_query_topk(tmp_path):
    # Each shard answers the staged rows of its groups, on a padded mesh
    # (G = 27, g_pad = 32) where some shards get no rows of a small batch.
    rng = np.random.default_rng(62)
    r = rng.random((16384, 3), dtype=np.float32)
    q = rng.random((64, 3), dtype=np.float32)
    q[0] = (5.0, 5.0, 5.0)  # uncertified: the exact top-k scan answers it
    eng = ShardedCellEngine(r, _virtual(8), d_per_dim=3)
    assert eng.g_pad != eng.D ** 3
    d2, idx = eng.query_topk(q, 4)
    d2_s, idx_s = CellListEngine(r, device="cpu", d_per_dim=3).query_topk(q, 4)
    np.testing.assert_array_equal(idx, idx_s)
    np.testing.assert_array_equal(d2, d2_s)
    d2_j, idx_j = jax_sc.ShardedCellEngine(r, make_mesh(8), d_per_dim=3).query_topk(q, 4)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_allclose(d2, np.asarray(d2_j), rtol=D2_RTOL, atol=0)
    dd = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    rows = np.arange(q.shape[0])[:, None]
    np.testing.assert_allclose(np.sort(dd[rows, idx], 1), np.sort(dd, 1)[:, :4], rtol=1e-5,
                               atol=1e-7)
    one = rng.random((1, 3), dtype=np.float32)
    np.testing.assert_array_equal(eng.query_topk(one, 8)[1],
                                  CellListEngine(r, device="cpu", d_per_dim=3).query_topk(one, 8)[1])


def test_sharded_collect_dist_matches_single_chip():
    q, r = make_dataset(3, 128, 16384, seed=11)
    s_idx, s_ok, s_d2 = CellListEngine(r, device="cpu").query_with_flags_dist(q)
    m_idx, m_ok, m_d2 = ShardedCellEngine(r, _virtual(8)).query_with_flags_dist(q)
    j_idx, j_ok, j_d2 = jax_sc.ShardedCellEngine(r, make_mesh(8)).query_with_flags_dist(q)
    np.testing.assert_array_equal(m_ok, s_ok)
    np.testing.assert_array_equal(m_idx[s_ok], s_idx[s_ok])
    np.testing.assert_allclose(m_d2[s_ok], s_d2[s_ok], rtol=1e-5)
    np.testing.assert_array_equal(m_ok, j_ok)
    np.testing.assert_array_equal(m_idx, j_idx)
    assert m_d2.dtype == np.float64
    np.testing.assert_array_equal(m_d2, j_d2)
    d_true = (((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2)
              .sum(-1).min(1))
    assert (m_d2 >= d_true - 1e-7).all()


def test_sharded_collect_dist_uncertified_rows():
    # Far-out-of-box query: uncertified, but d2 must still bound the truth
    # and idx must come back decoded (never sign-encoded).
    _, r = make_dataset(3, 1, 8192, seed=4)
    r = r * np.float32(0.1)
    q = np.array([[0.9, 0.9, 0.9]], dtype=np.float32)
    idx, ok, d2 = ShardedCellEngine(r, _virtual(4)).query_with_flags_dist(q)
    assert not ok.all()
    assert (idx >= 0).all()
    d_true = ((q.astype(np.float64) - r.astype(np.float64)) ** 2).sum(-1).min()
    assert d2[0] >= d_true - 1e-9
    idx_j, ok_j, d2_j = jax_sc.ShardedCellEngine(r, make_mesh(4)).query_with_flags_dist(q)
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(d2, d2_j)


def test_sharded_cells_refuses_a_2d_mesh():
    _, r = make_dataset(3, 1, 8192, seed=7)
    with pytest.raises(ValueError, match="1-D mesh"):
        ShardedCellEngine(r, Mesh.virtual((2, 2), "cpu"))


@pytest.mark.parametrize("n_dev,alternate", [(1, False), (2, False), (4, False), (5, False),
                                             (4, True)])
def test_sharded_device_staging_equals_jax_and_one_device(n_dev, alternate, monkeypatch):
    # query_submit and query_queue through the sharded device body: each
    # shard with rows scans its groups, a shard with none launches nothing
    # (the corner batch lands on shard 0 alone), and each run of shards on
    # one device takes one upload per batch: one run on the virtual mesh,
    # one per shard when the devices alternate ("cpu", "cpu:0"), as on a
    # mesh of distinct devices. Answers equal the single-device engine's
    # and the JAX sharded engine's on as many of its virtual CPU devices.
    import nns_tpu_torch.parallel.sharded_cells as sc_mod

    rng = np.random.default_rng(70 + n_dev + alternate)
    r = rng.random((16384, 3), dtype=np.float32)
    mesh = (Mesh(tuple(torch.device("cpu", j % 2) if j % 2 else torch.device("cpu")
                       for j in range(n_dev)), (n_dev,)) if alternate else _virtual(n_dev))
    eng = ShardedCellEngine(r, mesh)
    assert len(eng._runs) == (n_dev if alternate else 1)
    single = CellListEngine(r, device="cpu")
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(n_dev))
    far = rng.random((40, 3), dtype=np.float32) * np.float32(3.0) - np.float32(1.0)
    corner = rng.random((200, 3), dtype=np.float32) * np.float32(0.05)
    queue = [np.concatenate([rng.random((300, 3), dtype=np.float32), far]), corner,
             rng.random((1, 3), dtype=np.float32)]
    scans, uploads = [], []
    monkeypatch.setattr(sc_mod, "cell_scan", lambda dense, *a: scans.append(len(dense))
                        or cell_scan(dense, *a))
    monkeypatch.setattr(sc_mod, "_upload", lambda rows, dev: uploads.append(len(rows))
                        or _upload(rows, dev))
    got, cov = eng.query_queue(queue, return_coverage=True)
    cuts = [eng._shard_cuts(eng.stage(b)[0]) for b in queue]
    busy = [int((np.diff(c) > 0).sum()) for c in cuts]
    assert len(scans) == sum(busy) and set(scans) == {eng.g_local}
    assert len(uploads) == sum(c[lo] < c[hi + 1] for c in cuts for _, lo, hi in eng._runs)
    assert sum(uploads) == sum(len(b) for b in queue)
    if n_dev > 1:
        assert busy[1] == 1
    want, cov_s = single.query_queue(queue, return_coverage=True)
    want_j, cov_j = jeng.query_queue(queue, return_coverage=True)
    assert cov == cov_s == cov_j and min(cov) < 1.0
    for a, b, c, qb in zip(got, want, want_j, queue):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert_exact(a, qb, r)
    for qb in queue:
        token = eng.query_submit(qb)
        assert token.winners.shape == (1, len(qb)) and token.winners.dtype == torch.int32
        idx, ok, d2 = eng.query_collect_dist(token)
        idx_s, ok_s = single.query_with_flags(qb)
        np.testing.assert_array_equal(ok, ok_s)
        np.testing.assert_array_equal(idx, idx_s)
        idx_j, ok_j, d2_j = jeng.query_collect_dist(jeng.query_submit(qb))
        np.testing.assert_array_equal(ok, ok_j)
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(d2, d2_j)
