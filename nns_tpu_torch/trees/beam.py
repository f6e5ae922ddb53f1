"""Beam frontier search — the device tree query of v11 and v13, and the index
the v14 engine promotes to. Counterpart of ``nns_tpu/trees/beam.py``
without its MXU-ranked chunk scan.

Build (host, from an already-built KDTree/Octree):
  - FRONTIER: a maximal antichain of subtrees each owning <= cap points
    (oversized depth-limited octree leaves are chunked into several
    buckets);
  - per-bucket tight bounding boxes over the member points;
  - one dense (F, cap, k) point tensor on the device, padded by replicating
    the bucket's first member (real points keep every path exact for any
    data range), with a ``valid`` mask for the k-NN path;
  - the KD-tree's 2^T - 1 points stored above the frontier form an EXTRAS
    block scanned by every query.

Query, per chunk of at most ``_CHUNK_M`` staged queries (torch ops, one
download for the whole staged set):
  1. lb[m, F] = squared distance from each query to each bucket's box,
     accumulated per dimension;
  2. the ``beam`` nearest buckets and the (beam+1)-th bound, by
     ``torch.topk`` over keys that order equal bounds by bucket id (the
     certificate needs only the bound's value; the keys make the scanned
     buckets the JAX package's);
  3. gather the beam buckets' points, direct-form f32 distances, argmin
     (the first position among equal minima), plus the extras block;
  4. certificate: best * (1 + 1e-5) <= the (beam+1)-th bound; every
     unscanned point lies in a bucket at least that far. Uncertified rows
     retry at 4x the beam, then take the exact fused scan.

The chunk scan (``_chunk_scan_core``) scans one shared candidate set per
locality-sorted chunk, the ``budget`` buckets nearest to any of its
queries, on the v4 kernel (``kernels/fused.py`` ``fused_min_idx``), and
certifies against the nearest unscanned bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from nns_tpu_torch.kernels import layouts
from nns_tpu_torch.kernels.fused import FusedBruteForce, fused_min_idx
from nns_tpu_torch.kernels.topk import direct_d2, smallest

_CHUNK_M = 1024   # queries per chunk (bounds the per-query bucket gather)
_MAX_F = 65536    # bucket-count guard: cap doubles until the frontier fits
# Certificate margin: lb and the direct form are both f32 sums of <= 16
# squared terms (<= ~4 ulp relative each); 1e-5 relative dominates both.
_CERT_MARGIN = 1.0 + 1e-5
# Column multiple of the chunk scan's dim-major candidates: the v4 kernel's
# tensor copies need a 16-byte pitch.
_LANE = 128


def box_lower_bound(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(m, F) squared distances from (m, k) queries to the (F, k) boxes
    [lo, hi], accumulated per dimension (an empty bucket's box, lo = inf,
    hi = -inf, is at inf)."""
    lb = torch.zeros((q.shape[0], lo.shape[0]), dtype=torch.float32, device=q.device)
    for d in range(q.shape[1]):
        qd = q[:, d:d + 1]
        gap = torch.clamp_min(torch.maximum(lo[None, :, d] - qd, qd - hi[None, :, d]), 0.0)
        lb = lb + gap * gap
    return lb


def _select_buckets(lb: torch.Tensor, beam: int):
    """Per-query nearest-``beam`` bucket ids (m, nb) and the (beam+1)-th box
    bound (m,), the certificate threshold (inf when every bucket is
    selected). Among buckets at equal bounds the lower id is taken first,
    as the JAX package's repeated argmin takes them: the threshold does not
    depend on that order, but which buckets are scanned does."""
    m, f_total = lb.shape
    nb = min(beam, f_total)
    vals, bids = smallest(lb, min(beam + 1, f_total))
    thr = vals[:, nb] if f_total > nb else torch.full((m,), float("inf"), device=lb.device)
    return bids[:, :nb].long(), thr


def _beam_distances(q, lo, hi, pts, ids, extras, extras_ids, beam: int, valid=None):
    """Steps 1-3 of the module docstring: (d2 (m, nb * cap + E), their ids,
    the certificate threshold (m,)). With ``valid``, pad replicas are at
    inf."""
    m = q.shape[0]
    sel, thr = _select_buckets(box_lower_bound(q, lo, hi), beam)
    d2 = direct_d2(q, pts[sel])                          # (m, nb, cap, k) gather
    if valid is not None:
        d2 = torch.where(valid[sel], d2, float("inf"))
    d2 = d2.reshape(m, -1)
    flat_ids = ids[sel].reshape(m, -1)
    if extras.shape[0]:
        d2 = torch.cat([d2, direct_d2(q, extras[None])], dim=1)
        flat_ids = torch.cat([flat_ids, extras_ids[None, :].expand(m, -1)], dim=1)
    return d2, flat_ids, thr


def _beam_query_core(q, lo, hi, pts, ids, extras, extras_ids, beam: int):
    """q (m, k); lo/hi (F, k); pts (F, cap, k); ids (F, cap); extras (E, k).
    Returns (best_idx (m,) i32, certified (m,) bool). best == thr == 0
    certifies soundly: a zero-distance winner ties any unscanned
    duplicate."""
    d2, flat_ids, thr = _beam_distances(q, lo, hi, pts, ids, extras, extras_ids, beam)
    pos = d2.argmin(dim=1, keepdim=True)
    best = d2.gather(1, pos)[:, 0]
    return flat_ids.gather(1, pos)[:, 0].to(torch.int32), best * _CERT_MARGIN <= thr


def chunk_scan_candidates(q, lo, hi, pts, ids, extras, extras_ids, budget: int):
    """The chunk scan's ONE shared candidate set for a query chunk: the
    ``budget`` buckets nearest to any of its rows (min over the rows of lb)
    and the extras, gathered once, dim-major, padded to a 128-column pitch
    with replicas of candidate 0 (real points; the kernel scores only the
    first c columns). Returns (lb (m, F), the scanned bucket ids (b,), the
    dim-major candidates (k, c_pad), c, their ids (c,)) — the v4 kernel's
    inputs at the scan's shapes."""
    f_total, cap, k = pts.shape
    b = min(budget, f_total)
    lb = box_lower_bound(q, lo, hi)
    sel = smallest(lb.amin(dim=0, keepdim=True), b)[1][0].long()
    cand = pts[sel].reshape(b * cap, k)                  # ONE gather per chunk
    cand_ids = ids[sel].reshape(b * cap)
    if extras.shape[0]:
        cand = torch.cat([cand, extras])
        cand_ids = torch.cat([cand_ids, extras_ids])
    c = cand.shape[0]
    return lb, sel, layouts.to_dim_major(layouts.pad_refs(cand, _LANE)), c, cand_ids


def _chunk_scan_core(q, lo, hi, pts, ids, extras, extras_ids, budget: int):
    """Budget scan: ``chunk_scan_candidates``' shared set per query chunk
    instead of a per-query bucket gather, scanned by the v4 kernel.
    Certificate: winner_d2 * margin <= min lb over the buckets NOT scanned
    — sound for any query order; the locality sort at staging only makes
    it hold more often. Returns (idx (m,) i32, certified (m,) bool)."""
    lb, sel, cand_dm, c, cand_ids = chunk_scan_candidates(q, lo, hi, pts, ids, extras,
                                                          extras_ids, budget)
    best_d2, pos = fused_min_idx(q, cand_dm, c)
    scanned = torch.zeros(lb.shape[1], dtype=torch.bool, device=q.device)
    scanned[sel] = True
    unscanned_min = torch.where(scanned[None, :], float("inf"), lb).amin(dim=1)
    return cand_ids[pos.long()], best_d2 * _CERT_MARGIN <= unscanned_min


def _beam_topk(q, lo, hi, pts, ids, valid, extras, extras_ids, beam: int, k_nn: int):
    """Exact k-NN over the beam buckets: (d2 (m, k_nn) f32, ids (m, k_nn)
    i32, certified (m,) bool). Pad replicas are masked out by ``valid`` (a
    replica would duplicate its bucket's first point in the top-k). Among
    equal distances the lower candidate position comes first, the order the
    JAX package's repeated argmin gives."""
    d2, flat_ids, thr = _beam_distances(q, lo, hi, pts, ids, extras, extras_ids, beam, valid)
    m = q.shape[0]
    kk = min(k_nn, d2.shape[1])
    dists, pos = smallest(d2, kk)
    fids = flat_ids.gather(1, pos.long()).to(torch.int32)
    if kk < k_nn:
        dists = torch.cat([dists, torch.full((m, k_nn - kk), float("inf"), device=q.device)], 1)
        fids = torch.cat([fids, torch.zeros((m, k_nn - kk), dtype=torch.int32,
                                            device=q.device)], 1)
    # The k-th hit must beat every unscanned bucket's bound (an infinite
    # k-th distance means too few real candidates: uncertified).
    return dists, fids, dists[:, -1] * _CERT_MARGIN <= thr


class BeamStagedQueries:
    """A query set staged for BeamIndex.query_staged_with_flags: the host
    copy (retry/fallback slicing, ORIGINAL order) and the chunked device
    copy (C, step, k), uploaded once. ``perm`` (device order -> original
    row) is the locality sort applied at staging; None = identity."""

    __slots__ = ("q_np", "q_dev", "m", "perm")

    def __init__(self, q_np: np.ndarray, q_dev: torch.Tensor, m: int, perm=None):
        self.q_np = q_np
        self.q_dev = q_dev
        self.m = m
        self.perm = perm


@dataclasses.dataclass
class BeamIndex:
    """Device-resident frontier of one tree: query-many exact NN search."""

    refs: np.ndarray           # (n, k) original points (fallback scans use it)
    lo: torch.Tensor           # (F, k) bucket box lower corners
    hi: torch.Tensor           # (F, k)
    pts: torch.Tensor          # (F, cap, k)
    ids: torch.Tensor          # (F, cap) i32
    valid: torch.Tensor        # (F, cap) bool — False on pad-replica slots
    extras: torch.Tensor       # (E, k) — points stored above the frontier
    extras_ids: torch.Tensor   # (E,) i32
    # Optional exact re-answer hook for uncertified rows (q_bad -> idx).
    # None = the v4 fused scan over refs, staged once (_fallback_engine).
    exact_fallback: Any = None
    # Host descent table of the owning KD-tree's splitting planes — (F,)
    # dims + thresholds over the implicit-heap internal nodes above the
    # frontier, the staging locality key of the chunk scan. None (octree
    # frontiers) stages unsorted, which only lowers chunk-scan coverage.
    desc_dim: Any = None       # (F,) int numpy
    desc_thr: Any = None       # (F,) f32 numpy
    _fused: Any = dataclasses.field(default=None, init=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.lo.device

    @classmethod
    def from_groups(
        cls,
        refs: np.ndarray,
        grouped_ids: np.ndarray,   # point ids concatenated bucket-by-bucket
        counts: np.ndarray,        # (F,) members per bucket
        extras_ids: np.ndarray,    # ids stored above the frontier (may be empty)
        device="cuda",
    ) -> "BeamIndex":
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        f_total, k = len(counts), refs.shape[1]
        cap = max(8, layouts.round_up(int(counts.max()) if f_total else 1, 8))
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        # Pad every bucket by replicating its first member (point 0 for empty
        # buckets) — replicas are real points, so scans stay exact; they can
        # only tie the true NN, never beat it.
        first = np.zeros(f_total, dtype=np.int64)
        nonempty = counts > 0
        first[nonempty] = grouped_ids[starts[:-1][nonempty]]
        ids = np.broadcast_to(first[:, None], (f_total, cap)).astype(np.int32).copy()
        bucket_of = np.repeat(np.arange(f_total), counts)
        pos = np.arange(len(grouped_ids)) - np.repeat(starts[:-1], counts)
        ids[bucket_of, pos] = grouped_ids
        pts = refs[ids]                                    # (F, cap, k)
        valid = np.zeros((f_total, cap), dtype=bool)
        valid[bucket_of, pos] = True

        # Tight boxes from the member points. grouped_ids is dense, so
        # consecutive NONEMPTY starts bound exactly one bucket's rows.
        lo = np.full((f_total, k), np.inf, dtype=np.float32)
        hi = np.full((f_total, k), -np.inf, dtype=np.float32)
        if nonempty.any():
            gp = refs[grouped_ids]
            ne_starts = starts[:-1][nonempty]
            lo[nonempty] = np.minimum.reduceat(gp, ne_starts, axis=0)
            hi[nonempty] = np.maximum.reduceat(gp, ne_starts, axis=0)

        extras_ids = np.asarray(extras_ids, dtype=np.int32)
        extras = refs[extras_ids] if len(extras_ids) else np.zeros((0, k), np.float32)
        return cls._placed(refs, (lo, hi, pts, ids, valid, extras, extras_ids), device)

    @classmethod
    def _placed(cls, refs, arrays, device, **extra) -> "BeamIndex":
        return cls(refs, *(torch.as_tensor(np.ascontiguousarray(a), device=device)
                           for a in arrays), **extra)

    # -- query --------------------------------------------------------------

    def home_buckets(self, q: np.ndarray) -> np.ndarray:
        """Host descent to each query's home frontier bucket (the staging
        locality key). Requires the desc tables; vectorized over rows —
        log2(F) gather+compare passes."""
        m = q.shape[0]
        t = int(self.lo.shape[0]).bit_length() - 1
        s = np.ones(m, dtype=np.int64)
        rows = np.arange(m)
        for _ in range(t):
            d = self.desc_dim[s]
            s = 2 * s + (q[rows, d] > self.desc_thr[s])
        return (s - (1 << t)).astype(np.int64)

    def stage_queries(self, queries: np.ndarray, chunk_m: int | None = None
                      ) -> BeamStagedQueries:
        """Stage a query set on the device in chunks of at most ``chunk_m``
        (default _CHUNK_M) rows, uploaded once. When the frontier carries a
        descent table, queries are sorted by home bucket first — the
        locality the chunk scan's shared candidate set depends on; answers
        are unsorted back to caller order at decode."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = q.shape[0]
        perm = None
        q_sorted = q
        if self.desc_dim is not None and m > 1:
            perm = np.argsort(self.home_buckets(q), kind="stable")
            q_sorted = q[perm]
        step = min(chunk_m or _CHUNK_M, layouts.pow2_at_least(max(m, 8)))
        chunks = -(-m // step)
        pad = chunks * step - m
        if pad:
            # Replicate the LAST query instead of zero-padding: the chunk
            # scan's bucket score is a min over the chunk's rows, and a zero
            # row would drag the shared candidate set toward the origin.
            q_sorted = np.concatenate([q_sorted, np.repeat(q_sorted[-1:], pad, axis=0)])
        qdev = torch.as_tensor(q_sorted.reshape(chunks, step, q.shape[1]), device=self.device)
        return BeamStagedQueries(q, qdev, m, perm)

    @staticmethod
    def _decode(out: np.ndarray, st: BeamStagedQueries):
        """(C, 2, step) i32 drain output -> (idx, ok) in CALLER order."""
        idx = out[:, 0, :].reshape(-1)[: st.m].astype(np.int32)
        ok = out[:, 1, :].reshape(-1)[: st.m].astype(bool)
        if st.perm is not None:
            idx_o = np.empty_like(idx)
            ok_o = np.empty_like(ok)
            idx_o[st.perm] = idx
            ok_o[st.perm] = ok
            return idx_o, ok_o
        return idx, ok

    def _drain(self, st: BeamStagedQueries, core, arg: int):
        """Run ``core`` over every staged chunk on the device, then ONE
        download of the (C, 2, step) [idx | certified] table."""
        rows = []
        for qc in st.q_dev:
            idx, ok = core(qc, self.lo, self.hi, self.pts, self.ids, self.extras,
                           self.extras_ids, arg)
            rows.append(torch.stack([idx, ok.to(torch.int32)]))
        if not rows:  # no query: an empty table, as the JAX package's lax.map gives
            return self._decode(np.zeros((0, 2, st.q_dev.shape[1]), np.int32), st)
        return self._decode(torch.stack(rows).cpu().numpy(), st)

    def query_staged_with_flags(self, st: BeamStagedQueries, beam: int = 8):
        """(idx, certified) for a pre-staged query set by the per-query beam
        (``_beam_query_core``)."""
        return self._drain(st, _beam_query_core, beam)

    def query_staged_scan_with_flags(self, st: BeamStagedQueries, budget: int = 128):
        """(idx, certified) by the chunk scan: one shared ``budget``-bucket
        candidate set per locality-sorted chunk, scanned by the v4 kernel,
        plus the unscanned-bucket certificate (``_chunk_scan_core``)."""
        return self._drain(st, _chunk_scan_core, budget)

    def query_with_flags(self, queries: np.ndarray, beam: int = 8):
        """(idx, certified); certified=False rows need an exact fallback
        (query_exact does it)."""
        return self.query_staged_with_flags(self.stage_queries(queries), beam)

    def _fallback_engine(self) -> FusedBruteForce:
        """The exact fallback's engine over the refs, staged once."""
        if self._fused is None:
            self._fused = FusedBruteForce(self.refs, device=self.device)
        return self._fused

    def query_staged_with_coverage(self, st: BeamStagedQueries, beam: int = 8,
                                   budget: int | None = None) -> tuple[np.ndarray, float]:
        """Exact answers plus the certified fraction for a pre-staged query
        set: the base pass (the chunk scan when ``budget`` is set, else the
        per-query beam), then a 4x-wider beam for the uncertified tail, then
        the exact fallback for what is left (``exact_fallback``, else the v4
        kernel over the refs)."""
        if budget is not None:
            idx, ok = self.query_staged_scan_with_flags(st, budget)
        else:
            idx, ok = self.query_staged_with_flags(st, beam)
        bad = np.flatnonzero(~ok)
        if len(bad) and self.lo.shape[0] > 4 * beam:
            # A structurally hard tail (clustered data, box-boundary
            # queries): one wider-beam pass usually certifies most of it
            # for far less than the tail's full scans.
            ri, ro = self.query_with_flags(st.q_np[bad], beam * 4)
            idx[bad] = ri
            ok[bad] = ro
            bad = np.flatnonzero(~ok)
        cov = float(ok.mean()) if len(ok) else 1.0
        if len(bad):
            q_bad = st.q_np[bad]
            if self.exact_fallback is not None:
                idx[bad] = np.asarray(self.exact_fallback(q_bad)).astype(np.int32)
            else:
                idx[bad] = self._fallback_engine().fallback(q_bad).cpu().numpy()
        return idx, cov

    def query_with_coverage(self, queries: np.ndarray, beam: int = 8,
                            budget: int | None = None) -> tuple[np.ndarray, float]:
        """query_staged_with_coverage on a freshly staged query set."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        return self.query_staged_with_coverage(self.stage_queries(q), beam, budget)

    def query_exact(self, queries: np.ndarray, beam: int = 8) -> np.ndarray:
        return self.query_with_coverage(queries, beam)[0]

    def query(self, queries: np.ndarray) -> np.ndarray:
        return self.query_exact(queries)

    def _topk_pass(self, q: np.ndarray, k_nn: int, beam: int):
        """(d2, idx, certified) numpy of ``_beam_topk`` over all rows: one
        upload, chunks of _CHUNK_M rows on the device (bounding the bucket
        gather), one download."""
        q_dev = torch.as_tensor(q, device=self.device)
        parts = [_beam_topk(q_dev[lo:lo + _CHUNK_M], self.lo, self.hi, self.pts, self.ids,
                            self.valid, self.extras, self.extras_ids, beam, k_nn)
                 for lo in range(0, q.shape[0], _CHUNK_M)]
        d2, idx, ok = (torch.cat(p).cpu().numpy() for p in zip(*parts))
        return d2, idx, ok

    def query_topk(self, queries: np.ndarray, k_nn: int = 8, beam: int = 8):
        """Exact k-NN through the frontier: (dist2[m, k], idx[m, k])
        ascending. The k-th-distance certificate is harder to satisfy than
        1-NN's, so an uncertified tail retries at 4x beam before falling
        back to the exact chunked top-k scan."""
        from nns_tpu_torch.kernels.topk import nns_topk

        q = np.ascontiguousarray(queries, dtype=np.float32)
        k_nn = min(k_nn, self.refs.shape[0])
        d2, idx, ok = self._topk_pass(q, k_nn, beam)
        bad = np.flatnonzero(~ok)
        if len(bad) and self.lo.shape[0] > 4 * beam:
            rd, ri, ro = self._topk_pass(q[bad], k_nn, beam * 4)
            d2[bad] = rd
            idx[bad] = ri
            ok[bad] = ro
            bad = np.flatnonzero(~ok)
        if len(bad):
            d2[bad], idx[bad] = nns_topk(q[bad], self.refs, k_nn, device=self.device)
        return d2, idx

    # -- persistence -----------------------------------------------------------

    _FIELDS = ("lo", "hi", "pts", "ids", "valid", "extras", "extras_ids")

    def save(self, path: str) -> None:
        """The JAX package's npz keys, plus the descent table (``beam_desc_dim``,
        ``beam_desc_thr``) where the frontier has one: the JAX package drops
        it, and its ``load`` ignores the extra keys."""
        arrays = {f"beam_{f}": getattr(self, f).cpu().numpy() for f in self._FIELDS}
        if self.desc_dim is not None:
            arrays.update(beam_desc_dim=self.desc_dim, beam_desc_thr=self.desc_thr)
        np.savez_compressed(path, refs=self.refs, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "BeamIndex":
        with np.load(path) as z:
            desc = ({"desc_dim": z["beam_desc_dim"], "desc_thr": z["beam_desc_thr"]}
                    if "beam_desc_dim" in z else {})
            return cls._placed(z["refs"], [z[f"beam_{f}"] for f in cls._FIELDS], device,
                               **desc)


# ---------------------------------------------------------------------------
# Frontier extraction per tree family (host numpy, as the JAX package's)
# ---------------------------------------------------------------------------


def kd_beam_index(tree, cap_target: int = 512, device="cuda") -> BeamIndex:
    """Frontier of the implicit-heap KD-tree: all subtrees rooted at heap
    depth T (F = 2^T buckets, T chosen so buckets hold ~cap_target points);
    the 2^T - 1 median points stored at shallower nodes become extras."""
    node_point = np.asarray(tree.node_point)
    slots = np.flatnonzero(node_point >= 0).astype(np.int64)
    pids = node_point[slots].astype(np.int64)
    n = len(pids)
    t = 0
    while (1 << t) * cap_target < n and (1 << t) < _MAX_F:
        t += 1
    # Heap depth of each slot, exactly: slot s = mantissa * 2^(depth+1).
    depth = (np.frexp(slots.astype(np.float64))[1] - 1).astype(np.int64)
    is_extra = depth < t
    extras_ids = pids[is_extra]
    shift = depth[~is_extra] - t
    bucket = (slots[~is_extra] >> shift) - (1 << t)
    order = np.argsort(bucket, kind="stable")
    grouped = pids[~is_extra][order].astype(np.int32)
    counts = np.bincount(bucket, minlength=1 << t)
    bi = BeamIndex.from_groups(tree.refs, grouped, counts, extras_ids, device=device)
    # Descent table over the internal nodes above the frontier (heap slots
    # 1 .. 2^t - 1): the chunk scan's staging locality key. Empty slots keep
    # (dim 0, thr 0) — an arbitrary but deterministic grouping, which only
    # affects sort quality, never correctness.
    node_dim = np.asarray(tree.node_dim)
    desc_dim = np.zeros(1 << t, dtype=np.int64)
    desc_thr = np.zeros(1 << t, dtype=np.float32)
    internal = np.arange(1, 1 << t)
    have = internal[internal < len(node_point)]
    have = have[node_point[have] >= 0]
    desc_dim[have] = node_dim[have]
    desc_thr[have] = tree.refs[node_point[have], node_dim[have]]
    bi.desc_dim = desc_dim
    bi.desc_thr = desc_thr
    return bi


def octree_beam_index(tree, cap_target: int = 512, device="cuda") -> BeamIndex:
    """Frontier of the linearized octree: expand nodes while count > cap;
    depth-limited leaves larger than cap are chunked into several buckets
    (each chunk gets its own tight box). Octrees store points only at
    leaves, so there are no extras."""
    children, start, count = tree.children, tree.start, tree.count
    order = np.asarray(tree.order, dtype=np.int64)
    is_leaf = children.max(axis=1) < 0

    cap = cap_target
    while True:
        seg_start: list[int] = []
        seg_count: list[int] = []
        stack = [0]
        while stack:
            nid = stack.pop()
            c = int(count[nid])
            if c == 0:
                continue
            if c <= cap or is_leaf[nid]:
                s = int(start[nid])
                for off in range(0, c, cap):   # chunk oversized leaves
                    seg_start.append(s + off)
                    seg_count.append(min(cap, c - off))
            else:
                stack.extend(int(ch) for ch in children[nid] if ch >= 0)
        if len(seg_start) <= _MAX_F or cap >= len(order):
            break
        cap *= 2

    # Greedy merge of underfull neighbours: frontier ranges partition
    # `order`, so sorting by start gives spatially adjacent DFS neighbours;
    # merging consecutive ranges up to cap keeps boxes local while shrinking
    # F toward n/cap. Merged boxes come from their member points like any
    # other bucket — exactness is unaffected.
    so = np.argsort(np.asarray(seg_start, dtype=np.int64))
    s_sorted = np.asarray(seg_start, dtype=np.int64)[so]
    c_sorted = np.asarray(seg_count, dtype=np.int64)[so]
    m_start: list[int] = []
    m_count: list[int] = []
    for s, c in zip(s_sorted.tolist(), c_sorted.tolist()):
        if m_count and m_count[-1] + c <= cap:
            m_count[-1] += c
        else:
            m_start.append(s)
            m_count.append(c)
    s_arr = np.asarray(m_start, dtype=np.int64)
    c_arr = np.asarray(m_count, dtype=np.int64)
    total = int(c_arr.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(c_arr) - c_arr, c_arr)
    grouped = order[np.repeat(s_arr, c_arr) + offs].astype(np.int32)
    return BeamIndex.from_groups(tree.refs, grouped, c_arr, np.zeros(0, dtype=np.int32),
                                 device=device)
