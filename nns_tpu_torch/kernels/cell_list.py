"""Supercell (cell-list) engine — exact low-dim NN through a dense spatial
index. Counterpart of ``nns_tpu/kernels/cell_list.py``.

Build (host): partition the bounding box into D^3 equal supercells and, for
every supercell, precompute its HALO point set — all reference points within
``halo`` of the supercell box — as one dense dim-major (G, 3, R_max) tensor
padded with distance sentinels, plus the (G, R_max) global ids. The native
C++ counting-sort build (the JAX package's ``nns_cpu.cpp``) serves halos up
to W/2; wider halos use the numpy enumeration.

Query: bucket queries by supercell and scatter them into a dense
(G, QM, 3) tensor on the host; ``cell_scan`` (``csrc/cell_scan.cu``, one
block per supercell) finds each slot's nearest halo point and folds the
exactness certificate into the id's sign bit (id when best <= halo^2, -id-1
otherwise); the host unscatters. Rows the certificate cannot prove are
re-answered exactly by the fused brute force.

Ids travel as int32 end to end: the JAX package's hi/lo 12-bit f32 id split
was a workaround for its device transit and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels.fused import as_f32, fused_fallback
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL, pow2_at_least as _pow2_at_least

# Queries per supercell the CUDA kernel takes (kMaxQM in csrc/cell_scan.cu).
_KERNEL_MAX_QM = 2048
# Bound on the plain version's (groups, QM, R_max) f32 distance block.
_PLAIN_BLOCK = 1 << 26


def cell_scan_plain(dense_q: torch.Tensor, halo_dm: torch.Tensor,
                    halo_ids: torch.Tensor, halo2: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch supercell scan: per slot (min_d2 (G, QM) f32, signed
    global id (G, QM) i32). d2 accumulates ``d2 = 0; d2 = d2 + diff * diff``
    over x, y, z; the winner is the smallest global id among the slot's
    exact minima (a masked min, not argmin); the id is kept when
    min_d2 <= halo2 and stored as -id-1 otherwise."""
    g_total, qm, _ = dense_q.shape
    r_max = halo_dm.shape[2]
    out_d = torch.empty((g_total, qm), dtype=torch.float32, device=dense_q.device)
    out_i = torch.empty((g_total, qm), dtype=torch.int32, device=dense_q.device)
    chunk = max(1, _PLAIN_BLOCK // max(qm * r_max, 1))
    for lo in range(0, g_total, chunk):
        q = dense_q[lo:lo + chunk]
        h = halo_dm[lo:lo + chunk]
        d2 = torch.zeros((q.shape[0], qm, r_max), dtype=torch.float32, device=q.device)
        for d in range(3):
            diff = q[:, :, d:d + 1] - h[:, d:d + 1, :]
            d2 = d2 + diff * diff
        mn = d2.amin(dim=2)
        masked = torch.where(d2 == mn[:, :, None], halo_ids[lo:lo + chunk, None, :],
                             torch.iinfo(torch.int32).max)
        gid = masked.amin(dim=2)
        out_d[lo:lo + chunk] = mn
        out_i[lo:lo + chunk] = torch.where(mn <= halo2, gid, -gid - 1)
    return out_d, out_i


def _cell_scan_cuda(dense_q, halo_dm, halo_ids, halo2):
    g_total, qm, _ = dense_q.shape
    dev = dense_q.device
    out_d = torch.empty((g_total, qm), dtype=torch.float32, device=dev)
    out_i = torch.empty((g_total, qm), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_cell_scan(
            dense_q.data_ptr(), halo_dm.data_ptr(), halo_ids.data_ptr(),
            g_total, qm, halo_dm.shape[2], halo2, out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(lib, rc, "cell_scan")
    _cuda.LAUNCHES["cell_scan"] += 1
    return out_d, out_i


def cell_scan(dense_q: torch.Tensor, halo_dm: torch.Tensor,
              halo_ids: torch.Tensor, halo2: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """dense_q (G, QM, 3) f32, halo_dm (G, 3, R_max) f32, halo_ids
    (G, R_max) i32, halo2 the f32 certificate radius squared -> per slot
    (min_d2 (G, QM) f32, signed global id (G, QM) i32). CPU tensors take
    ``cell_scan_plain``; CUDA tensors launch the kernel (or raise
    RuntimeError if it cannot be built or launched)."""
    g_total, qm, k = dense_q.shape
    if (k != 3 or halo_dm.dim() != 3 or halo_dm.shape[:2] != (g_total, 3)
            or halo_ids.shape != (g_total, halo_dm.shape[2])):
        raise ValueError(
            f"shape mismatch: dense_q {tuple(dense_q.shape)}, halo_dm "
            f"{tuple(halo_dm.shape)}, halo_ids {tuple(halo_ids.shape)}")
    if (dense_q.dtype != torch.float32 or halo_dm.dtype != torch.float32
            or halo_ids.dtype != torch.int32):
        raise TypeError("cell_scan takes f32 queries/halo points and i32 ids")
    if not dense_q.device == halo_dm.device == halo_ids.device:
        raise ValueError("cell_scan inputs lie on different devices")
    if dense_q.device.type == "cpu":
        return cell_scan_plain(dense_q, halo_dm, halo_ids, halo2)
    if dense_q.device.type != "cuda":
        raise ValueError(f"unsupported device {dense_q.device}")
    if not 1 <= qm <= _KERNEL_MAX_QM:
        raise ValueError(f"QM={qm} outside the kernel's 1..{_KERNEL_MAX_QM}")
    return _cell_scan_cuda(dense_q.contiguous(), halo_dm.contiguous(),
                           halo_ids.contiguous(), halo2)


class CellListEngine:
    """Prepare-once/query-many exact NN for 3-D points; the index lives on
    ``device`` (other k route to the fused kernel, see nns_cell_list)."""

    def __init__(self, refs: np.ndarray, d_per_dim: int | None = None,
                 halo: float | None = None, max_candidates: int = 200_000,
                 device="cuda"):
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        n, k = refs.shape
        if k != 3:
            raise ValueError("CellListEngine requires 3-D points")
        if n >= 1 << 30:
            raise ValueError("CellListEngine supports n < 2^30 per device")
        self.refs = refs
        self.n = n

        mn = refs.min(axis=0)
        mx = refs.max(axis=0)
        extent = np.maximum(mx - mn, 1e-6)
        if d_per_dim is None:
            # ~350 points per supercell (the JAX package's choice; not yet
            # swept on the GPU).
            d_per_dim = max(1, min(24, round((n / 350.0) ** (1.0 / 3.0))))
        self.D = d_per_dim
        self.W = (extent / self.D).astype(np.float64)  # per-dim supercell width
        if halo is None:
            # halo = c * (V/n)^(1/3): P(NN > halo) = exp(-(4/3)pi c^3) per
            # uniform query; c = 1.5 gives ~7e-7.
            volume = float(np.prod(extent))
            halo = 1.5 * (volume / max(n, 1)) ** (1.0 / 3.0)
        # Membership enumeration spans ceil(2*halo/W) + 1 cells per dim, so
        # halo is capped at one cell width. A larger requested halo is
        # clamped — the certificate then rejects more queries (exact
        # fallback), never lies.
        self.halo = float(min(halo, float(self.W.min())))
        self.mn = mn.astype(np.float64)

        from nns_tpu_torch.native import native_cells_build

        native = None
        if self.halo <= float(self.W.min()) / 2.0:
            # The native counting-sort build enumerates the classic
            # {lo, hi} 8-corner memberships, valid only for halo <= W/2.
            native = native_cells_build(
                refs, self.D, self.halo, self.mn, self.W, max_candidates, PAD_SENTINEL
            )
        if native is not None:
            halo_dm_np, halo_ids, counts = native
            if halo_dm_np is None:
                raise ValueError(
                    f"supercell halo overflow (R_max={int(counts.max())}): data "
                    "too clustered for the cell-list engine — use the fused "
                    "kernel"
                )
            self.R_max = halo_dm_np.shape[2]
        else:
            halo_pts, halo_ids, counts = self._build_numpy_halos(refs, max_candidates)
            halo_dm_np = np.ascontiguousarray(np.swapaxes(halo_pts, 1, 2))
        self._place(halo_dm_np, halo_ids, device)
        self.avg_candidates = float(counts.mean())

    def _place(self, halo_dm_np: np.ndarray, halo_ids: np.ndarray, device) -> None:
        """Move the index onto ``device``: halo points and ids for the scan,
        the refs for the exact fallback."""
        self.device = torch.device(device)
        self.halo_dm = torch.as_tensor(halo_dm_np, device=self.device)
        self.halo_ids = halo_ids
        self.halo_ids_dev = torch.as_tensor(halo_ids, device=self.device)
        self.refs_dev = torch.as_tensor(self.refs, device=self.device)
        # The certificate radius squared, rounded to f32 like the scan's d2.
        self.halo2 = float(np.float32(self.halo) ** 2)

    # -- query ------------------------------------------------------------

    def _sentinel_risk(self, q: np.ndarray) -> np.ndarray | None:
        """Bool mask of queries close enough to the PAD_SENTINEL corner
        (coordinates 1e6 per dim) that a padded halo slot could win the scan
        AND pass the <= halo certificate — possible only when the data
        itself lives near 1e6. Such queries are forced uncertified on the
        host, so they take the exact fallback. None when no query is at
        risk (the common case)."""
        d2 = ((q.astype(np.float64) - PAD_SENTINEL) ** 2).sum(axis=1)
        risk = d2 <= (2.0 * self.halo) ** 2
        return risk if bool(risk.any()) else None

    def _group_of(self, q: np.ndarray) -> np.ndarray:
        g = np.floor((q.astype(np.float64) - self.mn) / self.W).astype(np.int64)
        g = np.clip(g, 0, self.D - 1)
        return (g[:, 0] * self.D + g[:, 1]) * self.D + g[:, 2]

    def _build_numpy_halos(self, refs: np.ndarray, max_candidates: int):
        """Vectorized numpy halo build (wide-halo levels, and the fallback
        when the native lib is unavailable): enumerate the cells whose box
        lies within ``halo`` of each point per dim, stable-sort by group,
        fill. Membership is per-dim (L-inf) and thus a superset of the L2
        ball — the certificate stays sound."""
        rel = refs.astype(np.float64) - self.mn
        lo = np.clip(np.floor((rel - self.halo) / self.W).astype(np.int64), 0, self.D - 1)
        hi = np.clip(np.floor((rel + self.halo) / self.W).astype(np.int64), 0, self.D - 1)
        span = (hi - lo).max(axis=0) + 1  # per-dim enumeration width
        pairs_pt: list[np.ndarray] = []
        pairs_gid: list[np.ndarray] = []
        for dx in range(int(span[0])):
            gx = lo[:, 0] + dx
            vx = gx <= hi[:, 0]
            for dy in range(int(span[1])):
                gy = lo[:, 1] + dy
                vy = gy <= hi[:, 1]
                for dz in range(int(span[2])):
                    gz = lo[:, 2] + dz
                    vz = gz <= hi[:, 2]
                    valid = vx & vy & vz
                    gid = (gx * self.D + gy) * self.D + gz
                    pairs_pt.append(np.flatnonzero(valid))
                    pairs_gid.append(gid[valid])
        pt = np.concatenate(pairs_pt)
        gid = np.concatenate(pairs_gid)
        order = np.argsort(gid, kind="stable")
        pt, gid = pt[order], gid[order]

        G = self.D ** 3
        counts = np.bincount(gid, minlength=G)
        r_max = int(counts.max()) if len(counts) else 1
        if r_max > max_candidates:
            raise ValueError(
                f"supercell halo overflow (R_max={r_max}): data too clustered "
                "for the cell-list engine — use the fused kernel"
            )
        # Round to 256 slots, not pow2: the scan pays R_max for every group.
        self.R_max = max(256, -(-r_max // 256) * 256)
        starts = np.concatenate([[0], np.cumsum(counts)])
        halo_pts = np.full((G, self.R_max, 3), PAD_SENTINEL, dtype=np.float32)
        halo_ids = np.zeros((G, self.R_max), dtype=np.int32)
        pos = np.arange(len(pt)) - starts[gid]
        halo_pts[gid, pos] = refs[pt]
        halo_ids[gid, pos] = pt.astype(np.int32)
        return halo_pts, halo_ids, counts

    def q_max_limit(self) -> int:
        """Largest supported queries-per-supercell for one batch (the JAX
        kernel's bound, which the CUDA kernel shares); batches beyond it go
        to the brute-force path."""
        return (1 << 20) // 512  # 2048

    def stage(self, queries: np.ndarray):
        """Host-side bucketing: sort queries by supercell, compute slot
        positions, pack into one (m, 5) f32 array [x, y, z, sid, pos].
        Returns (packed_np, order, q_max); q_max is None when the batch is
        too skewed for the dense kernel (caller must use the brute path)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != 3:
            raise ValueError(f"queries must be (m, 3); got {q.shape}")
        m = q.shape[0]
        from nns_tpu_torch.native import native_cells_stage

        native = native_cells_stage(q, self.D, self.mn, self.W)
        if native is not None:
            packed, order, raw_max = native
            q_max = _pow2_at_least(max(raw_max, 8))
            if q_max > self.q_max_limit():
                return None, order, None
            return packed, order, q_max
        sid = self._group_of(q)
        order = np.argsort(sid, kind="stable")
        sid_s = sid[order]
        counts = np.bincount(sid_s, minlength=self.D ** 3)
        q_max = _pow2_at_least(max(int(counts.max()), 8))
        if q_max > self.q_max_limit():
            return None, order, None
        pos = np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[sid_s]
        packed = np.empty((m, 5), dtype=np.float32)
        packed[:, :3] = q[order]
        packed[:, 3] = sid_s
        packed[:, 4] = pos
        return packed, order, q_max

    def _dense_scatter(self, packed: np.ndarray, q_max: int):
        """One staged (m, 5) pack -> (dense (G, q_max, 3) f32, flat winner
        slots (m,) i32) — the single home of the host dense-scatter."""
        sid = packed[:, 3].astype(np.int64)
        pos = packed[:, 4].astype(np.int64)
        dense = np.zeros((self.D ** 3, q_max, 3), np.float32)
        dense[sid, pos] = packed[:, :3]
        return dense, (sid * q_max + pos).astype(np.int32)

    def stage_queue_ragged(self, batches):
        """Ragged queue staging: each batch keeps its OWN pow2 q_max, so one
        skewed batch cannot inflate every other batch's dense tensor and
        winner table. Returns (denses [list of (G, qm_b, 3)], fslots [list
        of (m,) i32], orders), or (None, None, None) when any batch is too
        skewed for the dense kernel."""
        denses, fslots, orders = [], [], []
        for qb in batches:
            packed, order, q_max = self.stage(qb)
            if packed is None:
                return None, None, None
            dense, flat = self._dense_scatter(packed, q_max)
            denses.append(dense)
            fslots.append(flat)
            orders.append(order)
        return denses, fslots, orders

    def query_queue_staged(self, denses):
        """Device half of the queue path: one scan launch per staged batch,
        all on the current stream, no synchronization. ``denses`` is a
        sequence of (G, qm_b, 3) arrays (numpy or tensors); returns the
        tuple of (G, qm_b) i32 winner tables on the device — winner id per
        slot, certificate in the sign bit (see unscatter_queue)."""
        if not isinstance(denses, (tuple, list)):
            raise TypeError("query_queue_staged takes a sequence of per-batch dense arrays")
        return tuple(
            cell_scan(as_f32(d, self.device), self.halo_dm, self.halo_ids_dev, self.halo2)[1]
            for d in denses
        )

    @staticmethod
    def unscatter_queue(out_w: np.ndarray, fslots: np.ndarray,
                        order: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host half of the queue path for one batch: dense (G*QM,) signed
        winners + the batch's flat slots and staging order -> (idx, ok) in
        the caller's original query order."""
        got = np.asarray(out_w).reshape(-1)[fslots]  # (m,) signed, staged order
        m = len(order)
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        got = got[inv]
        ok = got >= 0
        idx = np.where(ok, got, -got - 1).astype(np.int32)
        return idx, ok

    def _exact_rows(self, queries: np.ndarray, idx: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Re-answer the uncertified rows (``ok`` False) with the exact fused
        scan, in place."""
        if not ok.all():
            bad = np.flatnonzero(~ok)
            q_bad = np.ascontiguousarray(queries, dtype=np.float32)[bad]
            idx[bad] = fused_fallback(q_bad, self.refs_dev, self.device).cpu().numpy()
        return idx

    def query_queue(self, batches, return_coverage: bool = False):
        """EXACT answers for several query batches: ragged staging, one scan
        launch per batch, ONE device-to-host copy (the only sync) for the
        whole queue, host unscatter, and the exact fused re-answer of every
        uncertified row. A queue with a batch too skewed for the dense
        kernel falls back to per-batch querying. With ``return_coverage``,
        also returns the per-batch certified fraction."""
        denses, fslots, orders = self.stage_queue_ragged(batches)
        if denses is None:
            pairs = [self.query_with_coverage(qb) for qb in batches]
            results = [idx for idx, _ in pairs]
            return (results, [cov for _, cov in pairs]) if return_coverage \
                else results
        rows = self.query_queue_staged(denses)
        sizes = [d.shape[0] * d.shape[1] for d in denses]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        flat = torch.cat([r.reshape(-1) for r in rows]).cpu().numpy()
        results = []
        covs = []
        for w, qb in enumerate(batches):
            idx, ok = self.unscatter_queue(flat[offs[w]:offs[w + 1]], fslots[w], orders[w])
            risk = self._sentinel_risk(np.asarray(qb, dtype=np.float32))
            if risk is not None:
                ok &= ~risk
            covs.append(float(ok.mean()) if len(ok) else 1.0)
            results.append(self._exact_rows(qb, idx, ok))
        return (results, covs) if return_coverage else results

    def query_with_flags_dist(self, queries: np.ndarray):
        """(idx, certified, best_d2) for one batch in the caller's order.
        best_d2 is the scan's f32 min over the halo candidates: it tracks
        the true NN distance only to f32 rounding (~1 ulp can land below the
        f64 truth), and is the distance to a sentinel slot when the halo set
        was empty. A batch too skewed for the kernel comes back all
        uncertified (best_d2 inf)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        packed, order, q_max = self.stage(q)
        m = len(order)
        if packed is None:
            return (np.zeros(m, dtype=np.int32), np.zeros(m, dtype=bool),
                    np.full(m, np.inf, dtype=np.float32))
        dense, flat = self._dense_scatter(packed, q_max)
        dmin, sgid = cell_scan(as_f32(dense, self.device), self.halo_dm,
                               self.halo_ids_dev, self.halo2)
        slots = torch.as_tensor(flat.astype(np.int64), device=self.device)
        sg = sgid.reshape(-1)[slots].cpu().numpy()
        d2 = dmin.reshape(-1)[slots].cpu().numpy()
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        sg, d2 = sg[inv], d2[inv]
        ok = sg >= 0
        idx = np.where(ok, sg, -sg - 1).astype(np.int32)
        risk = self._sentinel_risk(q)
        if risk is not None:
            ok &= ~risk  # sentinel-corner proximity: force the exact path
        return idx, ok, d2

    def query_with_flags(self, queries: np.ndarray):
        idx, ok, _ = self.query_with_flags_dist(queries)
        return idx, ok

    def query_with_coverage(self, queries: np.ndarray) -> tuple[np.ndarray, float]:
        """Exact answers plus the fraction certified by the index (callers
        can adapt engine choice when coverage is persistently poor)."""
        idx, ok = self.query_with_flags(queries)
        idx = self._exact_rows(queries, idx, ok)
        cov = float(ok.mean()) if len(ok) else 1.0
        return idx, cov

    def query(self, queries: np.ndarray) -> np.ndarray:
        return self.query_with_coverage(queries)[0]


def nns_cell_list(queries, refs, d_per_dim: int | None = None, device="cuda") -> np.ndarray:
    """One-shot wrapper; non-3-D or tiny reference sets route to the fused
    kernel (capability-dispatch contract, SURVEY.md §5)."""
    if refs.shape[1] != 3 or refs.shape[0] < 4096:
        return fused_fallback(queries, refs, device).cpu().numpy()
    try:
        eng = CellListEngine(np.asarray(refs), d_per_dim=d_per_dim, device=device)
    except ValueError:
        return fused_fallback(queries, refs, device).cpu().numpy()
    return eng.query(np.asarray(queries))
