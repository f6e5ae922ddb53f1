"""Beam frontier of the PyTorch port against the JAX package, on CPU torch:
the frontier build (a host build: tensors equal), the per-query beam and
the chunk scan (certified flags equal, certified rows true nearest
neighbours, exact answers after the retry and the fallback), the staging
sort, the beam k-NN, and the persistence of the frontier.

Tolerances: the frontier arrays are equal. The beam's flags are equal and
its certified rows are exact against the f64 oracle and equal to the JAX
package's; uncertified rows are held to the final exact answer. The JAX
chunk scan runs its Pallas kernel in interpret mode, as its
own tests do. k-NN distances agree within rtol 1e-6 (the JAX package's XLA
may contract a sum into an FMA), ids are equal off ties, and on duplicate
points the order of the ids is equal."""

import numpy as np
import pytest
import torch

import nns_tpu.trees.beam as jbeam
import nns_tpu_torch.trees.beam as pbeam
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu.kernels.oracle import nn_oracle_f64
from nns_tpu.trees.kdtree import KDTree as JKDTree
from nns_tpu.trees.octree import Octree as JOctree
from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.trees.kdtree import KDTree
from nns_tpu_torch.trees.octree import Octree
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: its numpy fallbacks
# build other trees (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

FIELDS = ("lo", "hi", "pts", "ids", "valid", "extras", "extras_ids")


def _indices(family, r, cap=512):
    """(port BeamIndex on the CPU, JAX BeamIndex) of the same refs."""
    if family == "kd":
        return (pbeam.kd_beam_index(KDTree.build(r), cap, device="cpu"),
                jbeam.kd_beam_index(JKDTree.build(r), cap))
    return (pbeam.octree_beam_index(Octree.build(r), cap, device="cpu"),
            jbeam.octree_beam_index(JOctree.build(r), cap))


def _clustered_16d(seed, n, m):
    rng = np.random.default_rng(seed)
    _, r = make_dataset(16, 1, n, seed=seed, clustered=True)
    base = r[rng.integers(0, n, size=m)]
    return (base + rng.normal(0, 0.01, size=base.shape)).astype(np.float32), r


def _certified_exact(idx, ok, q, r):
    _, dmin = nn_oracle_f64(q[ok], r)
    d = ((q[ok].astype(np.float64) - r[idx[ok]].astype(np.float64)) ** 2).sum(1)
    np.testing.assert_array_equal(d, dmin)


@pytest.mark.parametrize("family,k,n,clustered,cap", [
    ("kd", 3, 20000, False, 512), ("kd", 3, 8192, True, 64), ("kd", 5, 3000, False, 128),
    ("kd", 2, 333, False, 512), ("octree", 3, 20000, False, 512),
    ("octree", 3, 8192, True, 64), ("octree", 3, 513, False, 512)])
def test_frontier_equals_jax(family, k, n, clustered, cap):
    _, r = make_dataset(k, 1, n, seed=n, clustered=clustered)
    got, want = _indices(family, r, cap)
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    if family == "kd":
        np.testing.assert_array_equal(got.desc_dim, want.desc_dim)
        np.testing.assert_array_equal(got.desc_thr, want.desc_thr)
        q, _ = make_dataset(k, 300, n, seed=1)
        np.testing.assert_array_equal(got.home_buckets(q), want.home_buckets(q))
    else:
        assert got.desc_dim is None and want.desc_dim is None


@pytest.mark.parametrize("family", ["kd", "octree"])
@pytest.mark.parametrize("beam", [1, 4, 8, 32])
def test_beam_flags_equal_jax(family, beam):
    q, r = make_dataset(3, 700, 20000, seed=beam + 5, clustered=True, query_box=(-0.2, 1.2))
    got, want = _indices(family, r, 128)
    idx, ok = got.query_with_flags(q, beam)
    j_idx, j_ok = want.query_with_flags(q, beam)
    assert idx.dtype == np.int32 and ok.dtype == bool
    np.testing.assert_array_equal(ok, j_ok)
    assert ok.any() and (beam > 1 or not ok.all())  # at beam 1 both outcomes occur
    _certified_exact(idx, ok, q, r)
    np.testing.assert_array_equal(idx[ok], j_idx[ok])


def test_beam_core_equals_jax_on_one_chunk():
    q, r = make_dataset(5, 200, 3000, seed=2)
    got, want = _indices("kd", r, 64)
    args = [getattr(got, f) for f in ("lo", "hi", "pts", "ids", "extras", "extras_ids")]
    jargs = [getattr(want, f) for f in ("lo", "hi", "pts", "ids", "extras", "extras_ids")]
    idx, ok = pbeam._beam_query_core(torch.from_numpy(q), *args, 8)
    j_idx, j_ok = jbeam._beam_query_core(q, *jargs, 8)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    lb = pbeam.box_lower_bound(torch.from_numpy(q), got.lo, got.hi).numpy()
    # The JAX package's bound, the same per-dimension sum.
    jlb = np.zeros_like(lb)
    lo, hi = np.asarray(want.lo), np.asarray(want.hi)
    for d in range(5):
        gap = np.maximum(np.maximum(lo[None, :, d] - q[:, d:d + 1], q[:, d:d + 1] - hi[None, :, d]), 0)
        jlb = jlb + gap * gap
    np.testing.assert_array_equal(lb, jlb)


def test_select_buckets_takes_equal_bounds_by_bucket_id():
    # The (beam+1)-th smallest bound is the threshold; among equal bounds
    # the lower bucket id is selected first, as the JAX package's repeated
    # argmin selects; with every bucket selected the threshold is inf.
    lb = torch.tensor([[3.0, 0.0, 0.0, 1.0, 0.0], [5.0, 4.0, 3.0, 2.0, 1.0],
                       [float("inf")] * 4 + [0.0]])
    sel, thr = pbeam._select_buckets(lb, 2)
    assert thr.tolist() == [0.0, 3.0, float("inf")]
    assert sel.tolist() == [[1, 2], [4, 3], [4, 0]]
    sel, thr = pbeam._select_buckets(lb, 5)
    assert sel.shape == (3, 5) and torch.isinf(thr).all()


def test_staged_drain_is_one_program_over_chunks():
    # A query set wider than one chunk: certified rows are true NNs, the
    # staged form equals the unstaged one, and query_exact is exact.
    q, r = make_dataset(3, 2500, 20000, seed=8)
    bi = KDTree.build(r).device_index("cpu")
    st = bi.stage_queries(q)
    assert st.q_dev.shape[0] > 1 and st.perm is not None
    idx, ok = bi.query_staged_with_flags(st)
    assert ok.mean() > 0.9
    _certified_exact(idx, ok, q, r)
    idx2, ok2 = bi.query_with_flags(q)
    np.testing.assert_array_equal(idx, idx2)
    np.testing.assert_array_equal(ok, ok2)
    assert_exact(bi.query_exact(q), q, r)
    # The locality sort is the JAX package's, and decoding undoes it.
    jst = jbeam.kd_beam_index(JKDTree.build(r)).stage_queries(q)
    np.testing.assert_array_equal(st.perm, jst.perm)
    np.testing.assert_array_equal(st.q_dev.numpy(), np.asarray(jst.q_dev))


@pytest.mark.parametrize("budget", [2, 8, 32])
def test_chunk_scan_equals_jax(budget):
    q, r = _clustered_16d(11, 8192, 600)
    got, want = _indices("kd", r, 64)
    st, jst = got.stage_queries(q, chunk_m=128), want.stage_queries(q, chunk_m=128)
    idx, ok = got.query_staged_scan_with_flags(st, budget)
    j_idx, j_ok = want.query_staged_scan_with_flags(jst, budget)
    np.testing.assert_array_equal(ok, j_ok)
    _certified_exact(idx, ok, q, r)
    np.testing.assert_array_equal(idx[ok], j_idx[ok])
    # The full serving path (scan, beam retry, exact fallback) is exact.
    out, cov = got.query_staged_with_coverage(st, beam=16, budget=budget)
    _, j_cov = want.query_staged_with_coverage(jst, beam=16, budget=budget)
    assert cov == j_cov
    assert_exact(out, q, r)


def test_chunk_scan_candidates_are_the_scans_kernel_inputs():
    # chunk_scan_candidates builds what _chunk_scan_core hands the v4
    # wrapper: dim-major, a 128-column pitch padded with replicas of
    # candidate 0, scored over the first c columns only.
    from nns_tpu_torch.kernels.fused import fused_min_idx_plain

    q, r = _clustered_16d(12, 8192, 300)
    bi, _ = _indices("kd", r, 64)
    st = bi.stage_queries(q, chunk_m=128)
    args = (bi.lo, bi.hi, bi.pts, bi.ids, bi.extras, bi.extras_ids, 8)
    for qc in st.q_dev:
        lb, sel, cand_dm, c, cand_ids = pbeam.chunk_scan_candidates(qc, *args)
        assert cand_dm.shape[0] == 16 and cand_dm.shape[1] % 128 == 0
        assert c == 8 * 64 + bi.extras.shape[0] == cand_ids.shape[0]
        assert torch.equal(cand_dm[:, c:], cand_dm[:, :1].expand(-1, cand_dm.shape[1] - c))
        _, pos = fused_min_idx_plain(qc, cand_dm, c)
        idx, _ = pbeam._chunk_scan_core(qc, *args)
        assert torch.equal(cand_ids[pos.long()], idx)


@pytest.mark.parametrize("family", ["kd", "octree"])
def test_empty_query_set_equals_jax(family):
    q, r = make_dataset(3, 10, 2048, seed=1)
    got, want = _indices(family, r)
    for scan in (False, True):
        st, jst = got.stage_queries(q[:0]), want.stage_queries(q[:0])
        if scan:
            pair = (got.query_staged_scan_with_flags(st), want.query_staged_scan_with_flags(jst))
        else:
            pair = (got.query_staged_with_flags(st), want.query_staged_with_flags(jst))
        for a, b in zip(*pair):
            assert a.shape == b.shape == (0,) and a.dtype == b.dtype
    assert got.query_with_coverage(q[:0])[1] == want.query_with_coverage(q[:0])[1] == 1.0


def test_chunk_scan_and_fallback_run_the_v4_wrapper(monkeypatch):
    # Both the chunk scan and the exact fallback go through fused_min_idx
    # (on the CPU its plain version, which counts no launch).
    import nns_tpu_torch.kernels.fused as fused

    calls = []
    real = fused.fused_min_idx

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(fused, "fused_min_idx", counting)
    monkeypatch.setattr(pbeam, "fused_min_idx", counting)
    q, r = _clustered_16d(13, 4096, 300)
    # Four buckets: no 4x retry at beam 1, so the uncertified rows go
    # straight to the fallback.
    bi = pbeam.kd_beam_index(KDTree.build(r), 1024, device="cpu")
    assert bi.lo.shape[0] == 4
    _cuda.reset_launches()
    st = bi.stage_queries(q, chunk_m=128)
    idx, cov = bi.query_staged_with_coverage(st, beam=1, budget=1)
    assert_exact(idx, q, r)
    assert cov < 1.0
    # a scan per staged chunk, then one fallback of the uncertified rows
    assert calls[:3] == [128] * 3 and len(calls) == 4
    assert not any(_cuda.LAUNCHES.values())
    first = bi._fused
    assert first is not None
    bi.query_with_coverage(q, beam=1)
    assert bi._fused is first  # the fallback's refs are staged once


def test_exact_fallback_hook_takes_the_uncertified_rows():
    q, r = make_dataset(3, 64, 2048, seed=11)
    bi = KDTree.build(r).device_index("cpu")
    seen = []

    def hook(q_bad):
        seen.append(len(q_bad))
        return nn_oracle_f64(q_bad, r)[0]

    bi.exact_fallback = hook
    idx, cov = bi.query_with_coverage(q, beam=1)
    assert seen and seen[0] == round((1 - cov) * len(q))
    assert_exact(idx, q, r)


@pytest.mark.parametrize("family", ["kd", "octree"])
@pytest.mark.parametrize("k_nn,beam", [(1, 8), (8, 8), (8, 2), (40, 4)])
def test_beam_topk_equals_jax(family, k_nn, beam):
    q, r = make_dataset(3, 300, 8192, seed=k_nn + beam, clustered=True)
    got, want = _indices(family, r, 64)
    d2, idx, ok = got._topk_pass(q, k_nn, beam)
    j_d2, j_idx, j_ok = want._topk_pass(q, k_nn, beam)
    np.testing.assert_array_equal(ok, j_ok)
    fin = np.isfinite(j_d2)
    np.testing.assert_array_equal(np.isfinite(d2), fin)
    np.testing.assert_allclose(d2[fin], j_d2[fin], rtol=1e-6)
    # ids equal off ties: where a row's distances are distinct
    distinct = (np.diff(j_d2, axis=1) > 0).all(axis=1) & ok
    np.testing.assert_array_equal(idx[distinct], j_idx[distinct])
    d, i = got.query_topk(q, k_nn, beam)
    jd, ji = want.query_topk(q, k_nn, beam)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    d_ours = ((q[:, None].astype(np.float64) - r[i].astype(np.float64)) ** 2).sum(-1)
    d_jax = ((q[:, None].astype(np.float64) - r[ji].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(d_ours, 1), np.sort(d_jax, 1), rtol=1e-5, atol=1e-9)


def test_beam_topk_duplicate_order_equals_jax():
    # Eight copies of one point: the k-NN lists them in candidate order, as
    # the JAX package's repeated argmin does (a stable sort, not topk's).
    rng = np.random.default_rng(3)
    r = rng.random((4096, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], np.float32)
    for w in (7, 1000, 2000, 3000, 3001, 3500, 4000, 4095):
        r[w] = target
    q = np.stack([target, target + np.float32(1e-3)])
    for family in ("kd", "octree"):
        got, want = _indices(family, r, 64)
        d2, idx, ok = got._topk_pass(q, 8, 8)
        j_d2, j_idx, j_ok = want._topk_pass(q, 8, 8)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(ok, j_ok)
        assert sorted(idx[0].tolist()) == [7, 1000, 2000, 3000, 3001, 3500, 4000, 4095]


def test_topk_pass_chunks_equal_one_call():
    # The port runs _topk_pass over 1024-row chunks on the device with one
    # download; the chunking changes no answer (the JAX package dispatched
    # once per chunk).
    q, r = make_dataset(3, 2100, 8192, seed=17)
    bi = KDTree.build(r).device_index("cpu")
    d2, idx, ok = bi._topk_pass(q, 4, 8)
    for lo in (0, 1024, 2048):
        d, i, o = bi._topk_pass(q[lo:lo + 1024], 4, 8)
        np.testing.assert_array_equal(d, d2[lo:lo + 1024])
        np.testing.assert_array_equal(i, idx[lo:lo + 1024])
        np.testing.assert_array_equal(o, ok[lo:lo + 1024])


def test_frontier_files_load_across_packages(tmp_path):
    # The port keeps the KD frontier's descent table under extra keys
    # (beam_desc_dim, beam_desc_thr); the JAX package drops it on save and
    # ignores the keys on load. Answers are equal every way round.
    q, r = _clustered_16d(19, 4096, 500)
    got, want = _indices("kd", r, 64)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    got.save(ours)
    want.save(theirs)
    with np.load(ours) as z:
        assert {"beam_desc_dim", "beam_desc_thr"} <= set(z.files)
    with np.load(theirs) as z:
        assert "beam_desc_dim" not in z.files
    a = pbeam.BeamIndex.load(ours, device="cpu")
    b = pbeam.BeamIndex.load(theirs, device="cpu")
    c = jbeam.BeamIndex.load(ours)
    np.testing.assert_array_equal(a.desc_dim, got.desc_dim)
    assert b.desc_dim is None and c.desc_dim is None
    for f in FIELDS:
        for x in (a, b):
            np.testing.assert_array_equal(getattr(x, f).numpy(), np.asarray(getattr(want, f)))
    want_flags = want.query_with_flags(q, 4)
    for x in (a, b, c):
        for w, g in zip(want_flags, x.query_with_flags(q, 4)):
            np.testing.assert_array_equal(g[want_flags[1]], w[want_flags[1]])
    st = a.stage_queries(q)
    assert st.perm is not None  # the loaded KD frontier still sorts by locality
    assert_exact(a.query_staged_with_coverage(st, beam=8, budget=8)[0], q, r)
