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
from nns_tpu_torch.kernels.cell_list import (_SENTINEL_MARGIN, CellListEngine, cell_scan,
                                             nns_cell_list)
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL
from sentinel_corner import corner_rows
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: its numpy fallbacks
# build other trees (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

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


def test_submit_collect_equals_jax():
    # Two tokens in flight, a skewed batch's token and the sentinel-risk
    # rows: each collect equals the JAX engine's, and the synchronous path.
    q, r = make_dataset(3, 1, 16384, seed=15)
    rng = np.random.default_rng(15)
    batches = [_queries_with_far_rows(300, 16), rng.random((257, 3), dtype=np.float32),
               (rng.random((2100, 3), dtype=np.float32) * np.float32(1e-4))]
    jeng = jax_cells.CellListEngine(r)
    eng = CellListEngine(r, device="cpu")
    tokens = [eng.query_submit(b) for b in batches]
    jtokens = [jeng.query_submit(b) for b in batches]
    assert tokens[2].winners is None  # too skewed for the scan
    assert isinstance(tokens[0].winners, torch.Tensor) and tokens[0].winners.shape == (2, 300)
    for b, t, jt in zip(batches, tokens, jtokens):
        idx, ok, d2 = eng.query_collect_dist(t)
        idx_j, ok_j, d2_j = jeng.query_collect_dist(jt)
        np.testing.assert_array_equal(ok, ok_j)
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_allclose(d2, d2_j, rtol=D2_RTOL, atol=0)
        idx2, ok2 = eng.query_collect(t)
        np.testing.assert_array_equal(idx2, idx)
        np.testing.assert_array_equal(ok2, ok)
        if ok.any():
            assert_exact(idx[ok], b[ok], r)
    assert not eng.query_collect(tokens[2])[1].any()


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


def _shared_slot_answers_agree(dense, d2, sgid):
    """Per group, every slot whose coordinates another slot of the group
    shares has that slot's (min_d2, signed id)."""
    for g in range(dense.shape[0]):
        _, inv = np.unique(dense[g], axis=0, return_inverse=True)
        inv = inv.ravel()
        for u in np.unique(inv):
            same = inv == u
            assert (d2[g][same] == d2[g][same][0]).all(), g
            assert (sgid[g][same] == sgid[g][same][0]).all(), g


def test_cell_scan_equal_slots_equal_answers():
    # The invariant the CUDA scan scores by: within one group, slots with
    # the same coordinates get the same answer. Group 0 keeps its padding
    # and gets a real query at the origin (and one at -0.0); group 1 has no
    # zero slot and two repeated queries; the others are the staged batch.
    _, r = make_dataset(3, 1, 8192, seed=41)
    jeng = jax_cells.CellListEngine(r)
    eng = cell_engine_from_numpy(_jax_state(jeng), device="cpu")
    packed, _, q_max = eng.stage(_queries_with_far_rows(100, 41))
    dense, _ = eng._dense_scatter(packed, q_max)
    rng = np.random.default_rng(41)
    pad = np.flatnonzero(~dense[0].any(axis=1))
    assert len(pad) >= 3
    dense[0, pad[0]] = 0.0
    dense[0, pad[1]] = np.array([-0.0, 0.0, -0.0], np.float32)
    dense[1] = rng.random((q_max, 3), dtype=np.float32) * np.float32(0.3) + np.float32(0.01)
    dense[1, 5] = dense[1, 0]
    dense[1, 7] = dense[1, 0]
    assert dense[1].all(axis=1).all()
    d_j, s_j = jax_cells._cell_scan(jnp.asarray(dense), jeng.halo_dm, jeng.halo_ids_dev,
                                    jnp.float32(jeng.halo) ** 2, interpret=True)
    d_t, s_t = cell_scan(torch.from_numpy(dense), eng.halo_dm, eng.halo_ids_dev, eng.halo2)
    for d2, sgid in ((np.asarray(d_j)[:, :, 0], np.asarray(s_j)[:, :, 0]),
                     (d_t.numpy(), s_t.numpy())):
        _shared_slot_answers_agree(dense, d2, sgid)
        zero = ~dense.any(axis=2)  # all padded slots and the origin queries
        for g in range(dense.shape[0]):
            if zero[g].any():
                assert (sgid[g][zero[g]] == sgid[g][zero[g]][0]).all()
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j)[:, :, 0])


def test_empty_queue_returns_empty_list():
    # Deliberate deviation: the JAX package raises ValueError (it
    # concatenates an empty list); the port returns [], as v4 and v9 do.
    _, r = make_dataset(3, 1, 70000, seed=42)
    eng = CellListEngine(r, device="cpu")
    assert eng.query_queue([]) == []
    assert eng.query_queue([], return_coverage=True) == ([], [])
    import nns_tpu_torch
    cells = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    assert isinstance(cells._built, CellListEngine)
    assert cells.query_many([]) == []
    with pytest.raises(ValueError):
        jax_cells.CellListEngine(r).query_queue([])


def _skewed_rows(m, seed, centre=0.5):
    """m rows, the first m // 2 packed into one supercell's corner (QM =
    512 at m = 1000 over 32768 refs), the last five over (-1, 2)^3."""
    q = _queries_with_far_rows(m, seed)[::-1].copy()
    rng = np.random.default_rng(seed)
    q[:m // 2] = np.float32(centre) + rng.random((m // 2, 3), dtype=np.float32) * np.float32(0.01)
    return q


@pytest.mark.parametrize("n,case", [(8192, "far_rows"), (32768, "far_rows"), (8192, "m1"),
                                    (8192, "all_far"), (32768, "skewed")])
def test_query_staged_equals_jax(n, case):
    # The same stage pack through JAX's query_staged (its packed (4, m)
    # hi/lo ids decoded here) and the port's device body: ids and flags
    # exactly equal, d2 within D2_RTOL.
    _, r = make_dataset(3, 1, n, seed=n)
    jeng = jax_cells.CellListEngine(r)
    eng = cell_engine_from_numpy(_jax_state(jeng), device="cpu")
    rng = np.random.default_rng(n + len(case))
    q = {"far_rows": lambda: _queries_with_far_rows(700, n),
         "m1": lambda: rng.random((1, 3), dtype=np.float32),
         "all_far": lambda: (rng.random((64, 3), dtype=np.float32) * np.float32(4.0)
                             - np.float32(2.0)),
         "skewed": lambda: _skewed_rows(1000, n)}[case]()
    packed, order, q_max = eng.stage(q)
    j_packed, j_order, j_q_max = jeng.stage(q)
    assert packed.tobytes() == j_packed.tobytes() and j_q_max == q_max
    np.testing.assert_array_equal(order, j_order)
    if case == "skewed":
        assert q_max >= 512
    out = np.asarray(jeng.query_staged(packed, q_max))
    idx_j = ((out[0].astype(np.int64) << 12) | out[1].astype(np.int64)).astype(np.int32)
    ok_j = out[2].astype(bool)
    signed, d2 = eng.query_staged(packed, q_max)
    assert signed.dtype == torch.int32 and signed.shape == (len(q),)
    assert d2.dtype == torch.float32 and d2.shape == (len(q),)
    signed, d2 = signed.numpy(), d2.numpy()
    ok = signed >= 0
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(np.where(ok, signed, -signed - 1), idx_j)
    np.testing.assert_allclose(d2, out[3], rtol=D2_RTOL, atol=0)  # FMA on the XLA side only
    if case in ("far_rows", "skewed"):
        assert ok.any() and not ok.all()
    if case == "all_far":
        assert not ok.all()
    # A tensor pack takes the same path.
    again = eng.query_staged(torch.from_numpy(packed), q_max)
    np.testing.assert_array_equal(again[0].numpy(), signed)
    assert again[1].numpy().tobytes() == d2.tobytes()


def _host_staged_queue(eng, batches):
    """The host-staged drain, built from the public API: host dense
    scatter, one scan per dense batch, one download of every winner table,
    the host unscatter, the sentinel mask and the exact re-answer."""
    denses, fslots, orders = eng.stage_queue_ragged(batches)
    tables = eng.query_queue_staged(denses)
    flat = torch.cat([t.reshape(-1) for t in tables]).cpu().numpy()
    offs = np.cumsum([0] + [t.numel() for t in tables])
    results, covs = [], []
    for w, qb in enumerate(batches):
        idx, ok = eng.unscatter_queue(flat[offs[w]:offs[w + 1]], fslots[w], orders[w])
        risk = eng._sentinel_risk(qb)
        if risk is not None:
            ok &= ~risk
        covs.append(float(ok.mean()))
        results.append(eng._exact_rows(qb, idx, ok))
    return results, covs


def test_query_queue_device_staging_equals_host_staging(monkeypatch):
    # A ragged queue (two q_max tiers) with fallback rows: the device-staged
    # drain (one upload of the queue's raw rows, binned on the device)
    # equals the host-staged one bit for bit; a batch too skewed for the
    # kernel falls back alone, as query_with_coverage answers it.
    import nns_tpu_torch.kernels.cell_list as cl

    _, r = make_dataset(3, 1, 32768, seed=34)
    eng = CellListEngine(r, device="cpu")
    rng = np.random.default_rng(34)
    queue = [_queries_with_far_rows(500, 3), _skewed_rows(600, 4),
             rng.random((300, 3), dtype=np.float32), _queries_with_far_rows(5, 5)[:1]]
    assert len({eng.stage(b)[2] for b in queue}) >= 2
    uploads = []
    upload = cl._upload_queue
    monkeypatch.setattr(cl, "_upload_queue", lambda qs, dev: uploads.append(
        [len(q) for q in qs]) or upload(qs, dev))
    monkeypatch.setattr(eng, "stage", None)  # the drain never sorts on the host
    got, cov = eng.query_queue(queue, return_coverage=True)
    assert uploads == [[len(b) for b in queue]]
    monkeypatch.undo()
    want, cov_h = _host_staged_queue(eng, queue)
    assert cov == cov_h and min(cov) < 1.0
    for a, b, qb in zip(got, want, queue):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert_exact(a, qb, r)
    too_skewed = (np.float32(0.5) + rng.random((2 * eng.q_max_limit(), 3), dtype=np.float32)
                  * np.float32(1e-4))
    mixed = [queue[0], too_skewed, queue[2]]
    assert eng.stage(too_skewed)[0] is None
    got, cov = eng.query_queue(mixed, return_coverage=True)
    for a, (b, c), cv in zip(got, (eng.query_with_coverage(qb) for qb in mixed), cov):
        np.testing.assert_array_equal(a, b)
        assert cv == c
    assert cov[1] == 0.0


def test_queue_parts_cut_tables_at_the_budget():
    # Batches in queue order, each part's slots within the budget, a batch
    # without a table (q_max 0) joins the part it falls in, a batch larger
    # than the budget makes a part alone, and a queue without tables has
    # no part.
    from nns_tpu_torch.kernels.cell_list import queue_parts

    plan, parts = queue_parts(np.array([16, 0, 16, 32, 0, 8]), 10, 400)
    np.testing.assert_array_equal(plan, [[0, 16], [160, 0], [160, 16], [0, 32], [320, 0],
                                         [320, 8]])
    assert parts == [(0, 3, 320), (3, 6, 400)]
    assert plan.dtype == np.int64
    assert queue_parts(np.array([64, 8, 0]), 10, 100)[1] == [(0, 1, 640), (1, 3, 80)]
    assert queue_parts(np.array([0, 0]), 10, 100)[1] == []


@pytest.mark.parametrize("budget", ["one_batch_each", "largest_table"])
def test_query_queue_in_parts_equals_one_part(monkeypatch, budget):
    # A queue whose tables pass the drain's slot budget is placed, scanned
    # and gathered part by part: the answers and the coverage equal the
    # drain's in one part, the parts cover every batch with a table, and
    # each part's table stays within the budget unless it holds one batch
    # with a table.
    import nns_tpu_torch.kernels.cell_list as cl

    _, r = make_dataset(3, 1, 32768, seed=35)
    eng = CellListEngine(r, device="cpu")
    rng = np.random.default_rng(35)
    too_skewed = (np.float32(0.5) + rng.random((2 * eng.q_max_limit(), 3), dtype=np.float32)
                  * np.float32(1e-4))
    queue = [_queries_with_far_rows(500, 3), _skewed_rows(600, 4), too_skewed,
             rng.random((300, 3), dtype=np.float32), np.zeros((0, 3), np.float32),
             _face_rows(eng, 400, 35), _skewed_rows(1000, 6, centre=0.2)]
    want, cov_want = eng.query_queue(queue, return_coverage=True)
    groups = eng.D ** 3
    tables = [groups * eng.stage(b)[2] for b in queue if len(b) and eng.stage(b)[0] is not None]
    limit = 1 if budget == "one_batch_each" else max(tables)
    placed = []
    place = cl.place_queue
    monkeypatch.setattr(cl, "place_queue", lambda *a: placed.append(
        (int((a[5][:, 1] > 0).sum()), a[6])) or place(*a))
    monkeypatch.setattr(cl, "_QUEUE_SLOTS", limit)
    got, cov = eng.query_queue(queue, return_coverage=True)
    assert cov == cov_want and min(cov) < 1.0
    for a, b, qb in zip(got, want, queue, strict=True):
        np.testing.assert_array_equal(a, b)
    assert_exact(got[1], queue[1], r)
    assert sum(slots for _, slots in placed) == sum(tables)
    assert all(slots <= limit or tabled == 1 for tabled, slots in placed)
    if budget == "one_batch_each":
        assert len(placed) == len(tables)
    else:
        assert 1 < len(placed) < len(tables)


def test_sentinel_bound_equals_f64_pass():
    # Refs near the PAD_SENTINEL corner: rows at, just inside and just
    # outside PAD_SENTINEL - 2 halo (and its margin) get the mask of the
    # f64 pass (the JAX package's _sentinel_risk is that pass alone), and
    # the drain answers them as the JAX package and the host-staged drain do.
    rng = np.random.default_rng(78)
    r = np.float32(1e6) - rng.random((16384, 3), dtype=np.float32) * np.float32(64.0)
    jeng = jax_cells.CellListEngine(r)
    eng = CellListEngine(r, device="cpu")
    assert eng.halo == jeng.halo
    margin = PAD_SENTINEL - 2.0 * eng.halo - _SENTINEL_MARGIN
    corner = corner_rows(eng)
    box = (r.min(axis=0) + rng.random((2000, 3), dtype=np.float32)
           * (r.max(axis=0) - r.min(axis=0))).astype(np.float32)
    far = rng.random((50, 3), dtype=np.float32)
    cases = [corner, box, far, box[box.min(axis=1) < margin - 1.0], far[:0],
             np.concatenate([far, corner[1:2]])] + [corner[i:i + 1] for i in range(len(corner))]
    at_risk = 0
    for q in cases:
        got, want = eng._sentinel_risk(q), jeng._sentinel_risk(q)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
            at_risk += int(want.sum())
    assert at_risk > 0 and eng._sentinel_risk(corner[1:2]) is not None  # just inside
    assert eng._sentinel_risk(cases[2]) is None and eng._sentinel_risk(cases[3]) is None
    queue = [box[:600], corner, far]
    got, cov = eng.query_queue(queue, return_coverage=True)
    want_j, cov_j = jeng.query_queue(queue, return_coverage=True)
    want_h, cov_h = _host_staged_queue(eng, queue)
    assert cov == cov_j == cov_h and cov[1] < 1.0
    for a, b, c, qb in zip(got, want_j, want_h, queue):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert_exact(a, qb, r)


def _face_rows(eng, m, seed):
    """m rows on supercell faces: each coordinate f32(mn + j W) for a
    random face j = 0..D, or one f32 ulp either side of it."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, eng.D + 1, (m, 3))
    q = (eng.mn + j * eng.W).astype(np.float32)
    step = rng.integers(-1, 2, (m, 3))
    q = np.where(step > 0, np.nextafter(q, np.float32(np.inf)), q)
    return np.where(step < 0, np.nextafter(q, np.float32(-np.inf)), q).astype(np.float32)


def _binning_queue(eng, seed):
    """A uniform batch, a batch on supercell faces, one over (-1, 2)^3 and
    an empty one."""
    rng = np.random.default_rng(seed)
    outside = (rng.random((150, 3), dtype=np.float32) * np.float32(3.0)
               - np.float32(1.0)).astype(np.float32)
    return [rng.random((300, 3), dtype=np.float32), _face_rows(eng, 400, seed), outside,
            np.zeros((0, 3), np.float32)]


@pytest.mark.parametrize("seed", [61, 62])
def test_bin_queue_plain_equals_native_stage(seed):
    # The device drain's CPU twin bins as the host's counting sort stages:
    # each row's supercell id, each supercell's count and each batch's
    # largest count equal nns_cells_stage's; a row's slot is its rank among
    # the earlier rows of its (batch, supercell), which is the host's pos.
    from nns_tpu_torch.kernels.cell_list import _upload_queue, bin_queue
    from nns_tpu_torch.native import native_cells_stage

    _, r = make_dataset(3, 1, 32768, seed=seed)
    eng = CellListEngine(r, device="cpu")
    queue = _binning_queue(eng, seed)
    rows, offs = _upload_queue(queue, "cpu")
    assert rows.shape == (sum(len(q) for q in queue), 3) and offs.dtype == torch.int32
    sid, pos, counts, maxima = bin_queue(rows, offs, 400, eng.D, eng.mn, eng.W)
    assert counts.shape == (len(queue), eng.D ** 3)
    for b, q in enumerate(queue):
        lo, hi = int(offs[b]), int(offs[b + 1])
        packed, order, raw_max = native_cells_stage(q, eng.D, eng.mn, eng.W)
        want_sid = np.empty(len(q), np.int64)
        want_pos = np.empty(len(q), np.int64)
        want_sid[order] = packed[:, 3]
        want_pos[order] = packed[:, 4]
        np.testing.assert_array_equal(sid[lo:hi].numpy(), want_sid)
        np.testing.assert_array_equal(pos[lo:hi].numpy(), want_pos)
        np.testing.assert_array_equal(counts[b].numpy(),
                                      np.bincount(want_sid, minlength=eng.D ** 3))
        assert int(maxima[b]) == raw_max
    assert sid.dtype == pos.dtype == counts.dtype == maxima.dtype == torch.int32
    assert maxima.shape == (len(queue) + 1,) and int(maxima[-1]) == 0
    assert int(maxima[3]) == 0 and (sid[300:700] != sid[300:700][0]).any()


@pytest.fixture(scope="module")
def small_cells():
    _, r = make_dataset(3, 1, 8192, seed=65)
    return r, CellListEngine(r, device="cpu")


@pytest.mark.parametrize("row", ["first", "last"])
@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
def test_bin_queue_plain_counts_non_finite_rows(small_cells, value, dim, row):
    # bin_queue's twin counts the rows with a NaN or an infinity after the
    # per-batch maxima, and bins such a row as a finite row far outside the
    # box on the same side (NaN and -inf to supercell 0 of their dimension,
    # +inf to D - 1): sid, pos, counts and maxima equal that queue's. Rows
    # are counted, not coordinates: a second bad coordinate in the same
    # row leaves the count at 1.
    from nns_tpu_torch.kernels.cell_list import _upload_queue, bin_queue

    _, eng = small_cells
    queue = [q.copy() for q in _binning_queue(eng, 65)[:3]]
    at = 0 if row == "first" else -1
    stand_in = [q.copy() for q in queue]
    queue[1][at, dim] = value
    stand_in[1][at, dim] = eng.mn[dim] + (1e3 if value == np.inf else -1e3)
    got = bin_queue(*_upload_queue(queue, "cpu"), 400, eng.D, eng.mn, eng.W)
    want = bin_queue(*_upload_queue(stand_in, "cpu"), 400, eng.D, eng.mn, eng.W)
    for a, b in zip(got[:3], want[:3], strict=True):
        assert torch.equal(a, b)
    assert got[3][:-1].tolist() == want[3][:-1].tolist()
    assert int(got[3][-1]) == 1 and int(want[3][-1]) == 0
    queue[1][at, (dim + 1) % 3] = np.nan
    assert int(bin_queue(*_upload_queue(queue, "cpu"), 400, eng.D, eng.mn, eng.W)[3][-1]) == 1


@pytest.mark.parametrize("batch", ["first", "last"])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
def test_query_queue_raises_on_non_finite_before_any_scan(small_cells, value, batch):
    # The v14 drain checks finiteness in the pass that bins the queue: a
    # NaN or an infinity in the first or the last batch raises ValueError
    # before a batch is staged, scanned or answered. Every row was checked;
    # the same engine then answers a finite queue exactly, in int32.
    from nns_tpu_torch.utils.spans import COUNTS

    r, eng = small_cells
    rng = np.random.default_rng(66)
    queue = [rng.random((m, 3), dtype=np.float32) for m in (200, 0, 300)]
    bad = [q.copy() for q in queue]
    bad[0 if batch == "first" else -1][-1, 1] = value
    before = dict(COUNTS)
    with pytest.raises(ValueError, match="non-finite"):
        eng.query_queue(bad)
    grew = {name: COUNTS[name] - before[name] for name in COUNTS}
    assert grew["cells.device_checked_rows"] == 500
    assert grew["cells.device_staged_rows"] == grew["cells.rows"] == 0
    got = eng.query_queue(queue)
    assert [(idx.dtype, len(idx)) for idx in got] == [(np.int32, len(qb)) for qb in queue]
    assert_exact(np.concatenate(got), np.concatenate(queue), r)
    assert COUNTS["cells.device_checked_rows"] - before["cells.device_checked_rows"] == 1000


@pytest.mark.parametrize("case", ["mixed", "one_batch"])
def test_query_queue_equals_jax_on_faces_skew_and_outside(case):
    # The device-binned drain against the JAX package's queue drain, idx
    # and coverage: uniform batches, rows on supercell faces, rows outside
    # the box, and a batch above the 2048 skew limit (the JAX drain then
    # answers every batch alone; the port's answers that batch alone);
    # also a queue of one batch. The staged-rows counter counts the
    # batches the scan took.
    from nns_tpu_torch.utils.spans import COUNTS

    _, r = make_dataset(3, 1, 16384, seed=63)
    jeng = jax_cells.CellListEngine(r)
    eng = CellListEngine(r, device="cpu")
    rng = np.random.default_rng(63)
    uniform = rng.random((300, 3), dtype=np.float32)
    faces = _face_rows(eng, 300, 63)
    outside = (rng.random((120, 3), dtype=np.float32) * np.float32(3.0)
               - np.float32(1.0)).astype(np.float32)
    too_skewed = (np.float32(0.5) + rng.random((2 * eng.q_max_limit() + 100, 3),
                                               dtype=np.float32) * np.float32(1e-4))
    assert eng.stage(too_skewed)[0] is None
    if case == "mixed":
        queue = [uniform, faces, too_skewed, outside, rng.random((200, 3), dtype=np.float32)]
    else:
        queue = [np.concatenate([uniform, faces, outside])]
    before = COUNTS["cells.device_staged_rows"]
    got, cov = eng.query_queue(queue, return_coverage=True)
    assert COUNTS["cells.device_staged_rows"] - before == sum(
        len(q) for q in queue if q is not too_skewed)
    want, cov_j = jeng.query_queue(queue, return_coverage=True)
    assert cov == cov_j and min(cov) < 1.0
    for a, b, qb in zip(got, want, queue, strict=True):
        np.testing.assert_array_equal(a, b)
        if qb is not too_skewed:
            assert_exact(a, qb, r)
    if case == "mixed":
        assert cov[2] == 0.0
        assert_exact(got[2][:64], too_skewed[:64], r)


@pytest.mark.parametrize("parts", ["one_part", "one_batch_each"])
@pytest.mark.parametrize("refs", ["uniform", "near_corner"])
def test_cell_answer_plain_equals_host_tail(monkeypatch, refs, parts):
    # The CUDA drain's answer kernel, by its plain twin, on a CPU queue's
    # binned and scanned tables (in one part, and in one part per batch
    # with a table): each row's decoded winner, each batch's certified
    # count and the set of uncertified rows equal what the host tail
    # (_answer_queue: _unstage, _sentinel_risk) hands its exact re-answer.
    # The queue mixes uniform rows, rows over the box [-0.5, 1.5] of the
    # refs' extent, a batch above the 2048 skew limit, an empty batch and
    # rows at and just inside the sentinel corner, some of which the scan
    # certifies and the mask does not. The device path, run whole on the
    # CPU, answers as the host tail does, with one exact call per queue.
    import nns_tpu_torch.kernels.cell_list as cl
    from nns_tpu_torch.utils.spans import COUNTS

    rng = np.random.default_rng(64)
    if refs == "uniform":
        _, r = make_dataset(3, 1, 16384, seed=64)
    else:
        r = np.float32(1e6) - rng.random((16384, 3), dtype=np.float32) * np.float32(64.0)
    eng = CellListEngine(r, device="cpu")
    lo, extent = r.min(axis=0), r.max(axis=0) - r.min(axis=0)
    box = (lo + rng.random((600, 3), dtype=np.float32) * extent).astype(np.float32)
    outside = (lo + (rng.random((300, 3), dtype=np.float32) * np.float32(2.0)
                     - np.float32(0.5)) * extent).astype(np.float32)
    too_skewed = (lo + extent * (np.float32(0.5) + rng.random(
        (2 * eng.q_max_limit() + 10, 3), dtype=np.float32) * np.float32(1e-4))).astype(np.float32)
    corner = corner_rows(eng)
    queue = [box[:400], outside, too_skewed, np.zeros((0, 3), np.float32), corner, box[400:]]
    assert eng.stage(too_skewed)[0] is None
    if parts == "one_batch_each":
        monkeypatch.setattr(cl, "_QUEUE_SLOTS", 1)

    seen = []
    exact = eng._exact_rows
    monkeypatch.setattr(eng, "_exact_rows", lambda qb, idx, ok: seen.append(
        (idx.copy(), ok.copy())) or exact(qb, idx, ok))
    before = COUNTS["cells.exact_calls"]
    want, cov = eng.query_queue(queue, return_coverage=True)
    assert COUNTS["cells.exact_calls"] - before == sum(not ok.all() for _, ok in seen) > 1
    want_idx = np.concatenate([idx for idx, _ in seen])
    want_ok = np.concatenate([ok for _, ok in seen])
    corner_signed = eng._signed_rows(eng._bin(queue))[4]
    assert ((corner_signed >= 0) & ~seen[4][1]).any()  # certified by the scan, masked

    binned = eng._bin(queue)
    rows = len(binned.rows)
    idx = torch.full((rows,), -7, dtype=torch.int32)
    bad = torch.full((rows,), -1, dtype=torch.int32)
    counts = torch.zeros(len(queue) + 1, dtype=torch.int32)
    runs = []

    def answer(a, b, plan, win, slot):
        runs.append((a, b))
        cl.cell_answer(binned.rows, binned.offs[a:b + 1], len(too_skewed), plan, win, slot,
                       (2.0 * eng.halo) ** 2, idx, counts[a:b], bad, counts[len(queue):])

    eng._scan_parts(binned, answer)
    assert [a for a, _ in runs] == [0] + [b for _, b in runs[:-1]] and runs[-1][1] == len(queue)
    assert len(runs) == (1 if parts == "one_part" else 4)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert counts[:-1].tolist() == [int(ok.sum()) for _, ok in seen]
    listed = int(counts[-1])
    np.testing.assert_array_equal(np.sort(bad[:listed].numpy()), np.flatnonzero(~want_ok))
    assert (bad[listed:] == -1).all()
    assert cov == [c / len(q) if len(q) else 1.0 for c, q in zip(counts.tolist(), queue)]

    before = dict(COUNTS)
    got, cov_d = eng._answer_on_device(queue, eng._bin(queue))
    assert COUNTS["cells.exact_calls"] - before["cells.exact_calls"] == 1
    assert (COUNTS["cells.device_answered_rows"] - before["cells.device_answered_rows"]
            == COUNTS["cells.rows"] - before["cells.rows"] == rows)
    assert cov_d == cov
    for a, b, qb in zip(got, want, queue, strict=True):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert_exact(got[1], outside, r)
