"""v9 — split-bf16 expansion on the tensor cores, with a carried band
certificate and an exact refine. Counterpart of
``nns_tpu/kernels/mxu_expansion.py``.

1. Every coordinate is split into a bf16 (hi, mid, lo) triple that carries
   ~24 mantissa bits (``split_bf16x3``). The cross term ``q . r`` is the
   six products ``hh + hm + mh + hl + lh + mm``, one contraction of depth
   ``6 kp``: queries ``[qh qh qm qh ql qm]`` (``_cat_q``) against the ref
   splits stored once as ``[rh; rm; rl]`` (``_stack_r``).
2. Phase 1 (``phase1``, the kernels of ``csrc/expansion_phase1.cu``) scans
   every reference tile with bf16 tensor-core products accumulated in f32, forms
   ``e = |r|^2/2 - q.r`` and keeps per row the winning ``ts``-column
   subtile (``min1``, ``tid``), the runner-up outside it (``m2x``), and the
   tile-level top 3 (``t2v``, ``tid2``, ``t3v``) that feeds the band refine.
3. Phase 2 (``_phase2_chunk``) rescans each row's winning subtile in direct
   f32; ``min(in-subtile min2, m2x) > min1 + 2 delta`` certifies the row.
4. Uncertified rows take the band refine (``_band_refine_rows``: the top-2
   tiles in direct f32, certified by the third tile's minimum), and the rows
   it refuses the exact full scan (``_full_scan_rows``). The answer is the
   lowest-index f32 nearest neighbour on every row.

Padded reference columns carry ``r2h = +inf`` (their split coordinates are
zero), so they never win, whatever the data's range.

The error band (``_DELTA_REL_PER_K``), re-derived for Hopper tensor cores.
``delta`` must bound ``|e_computed - e_exact|`` for every point; with
``S = max|q|^2 + max|r|^2``:

- The six split products of two bf16 values are exact in f32 (8 x 8
  mantissa bits). The tensor core adds them in its own order and may
  truncate instead of rounding, so each addition errs by at most
  ``2^-23`` of the magnitudes it adds. Over the ``6 k`` nonzero products
  (the zero-padded dimensions add exact zeros) recursive summation errs by
  at most ``6 k 2^-23 sum|p|``, and ``sum|p| <= (1 + 2^-7) sum_d |q_d r_d|
  <= (1 + 2^-7) S / 2``: at most ``6.05 k 2^-24 S``.
- The dropped ``m.l``, ``l.m``, ``l.l`` terms and the residual of the lo
  split: about ``2^-26 S``. The f32 rounding of ``r2h``: ``2^-25 S``. The
  subtraction ``r2h - cross``: ``2^-24 S``. Together under ``1.6 2^-24 S``.

So ``|error| <= (6.05 k + 1.6) 2^-24 S``, which stays under the JAX
package's ``delta = 2^-21 k S = 8 k 2^-24 S`` for every k >= 1. The value
2^-21 therefore stands, but the margin at k = 16 is 128 / 98.4 = 1.3, not
the ~16 that round-to-nearest accumulation gave on the TPU. A wider delta
would only send more rows to the exact refine.

Deliberate differences from the JAX package, all without effect on the
answers: uncertified rows are found with ``torch.nonzero`` (no static
buckets, no sign-encoded overflow, no host re-answer); ids are int32 (no
hi/lo f32 packing); there is no per-dispatch row cap; and a failed kernel
launch raises instead of answering with the fused scan.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from nns_tpu_torch.kernels import _cuda, layouts
from nns_tpu_torch.kernels.fused import as_f32, fused_fallback, n_sm
from nns_tpu_torch.kernels.fused_ladder import fused_point_major_min_idx
from nns_tpu_torch.kernels.xla_bruteforce import full_fp32_matmul
from nns_tpu_torch.utils.spans import COUNTS, count_copy, span, spanned

_LANE = 128
_SUBLANE = 8

# Error bound on e = |r|^2/2 - q.r in units of (max|q|^2 + max|r|^2) per
# coordinate count k; the derivation is in the module docstring. k is
# folded in by the caller.
_DELTA_REL_PER_K = 2.0 ** -21

# Query rows per block of the wgmma kernels (kBM in csrc/expansion_phase1.cu)
# and their narrower chunk width, in ref columns.
_KERNEL_BM = 128
_KERNEL_BN = 64
# The wgmma kernels' ring stages (kStages) and contraction step; a
# resident query tile up to this many k16 steps per contraction block
# (kMaxResidentSteps), else slices of up to this many (kMaxSliceSteps); the
# instances compiled are those whose shared memory fits an H100 block
# (kInstanceSmem), in csrc/expansion_phase1.cu.
_WGMMA_STAGES = 2
_WGMMA_K = 16
_WGMMA_MAX_RESIDENT_STEPS = 6
_WGMMA_MAX_SLICE_STEPS = 3
_WGMMA_INSTANCE_SMEM = 232_448
# Split rows of rc feeding the six blocks of the contraction: [h, m, h, l, h, m].
_SPLIT_OF_BLOCK = (0, 1, 0, 2, 0, 1)
# Rows of a phase-2 or band-refine gather step: ~2^21 gathered points.
_GATHER_POINTS = 1 << 21


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo) bf16 triple with hi + mid + lo ~ x to ~24 bits. Each
    cast rounds to nearest even; both residuals are exact in f32."""
    hi = x.to(torch.bfloat16)
    rem = x - hi.float()
    mid = rem.to(torch.bfloat16)
    lo = (rem - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _cat_q(qh, qm, ql) -> torch.Tensor:
    """Query-side contraction layout: [qh qh qm qh ql qm]."""
    return torch.cat([qh, qh, qm, qh, ql, qm], dim=1)


def _stack_r(rh, rm, rl) -> torch.Tensor:
    """Reference-side layout: the three splits stored once as [rh; rm; rl]
    (3 kp rows); phase 1 reads the six-block partner of _cat_q from it."""
    return torch.cat([rh, rm, rl], dim=0)


def _check_phase1(qc, rc, r2h, tile_n, ts):
    m, kc = qc.shape
    if rc.dim() != 2 or kc % 6 or rc.shape[0] * 2 != kc:
        raise ValueError(f"shape mismatch: qc {tuple(qc.shape)}, rc {tuple(rc.shape)}")
    n_pad = rc.shape[1]
    if r2h.numel() != n_pad:
        raise ValueError(f"r2h has {r2h.numel()} columns, rc {n_pad}")
    if tile_n < 1 or ts < 1 or n_pad % tile_n or tile_n % ts:
        raise ValueError(f"tiles: n_pad={n_pad}, tile_n={tile_n}, ts={ts} must nest")
    if qc.dtype != torch.bfloat16 or rc.dtype != torch.bfloat16 or r2h.dtype != torch.float32:
        raise TypeError("phase1 takes bf16 qc and rc and f32 r2h")
    if not qc.device == rc.device == r2h.device:
        raise ValueError(f"qc on {qc.device}, rc on {rc.device}, r2h on {r2h.device}")
    return m, kc // 6, n_pad


def _empty_carries(m: int, device):
    f = torch.empty((4, m), dtype=torch.float32, device=device)
    i = torch.empty((2, m), dtype=torch.int32, device=device)
    return f, i


def _carries(f: torch.Tensor, i: torch.Tensor):
    """(min1, tid, m2x, t2v, tid2, t3v) from the (4, m) f32 and (2, m) i32
    outputs: f = [min1, m2x, t2v, t3v], i = [tid, tid2]."""
    return f[0], i[0], f[1], f[2], i[1], f[3]


def phase1_plain(qc: torch.Tensor, rc: torch.Tensor, r2h: torch.Tensor,
                 tile_n: int, ts: int):
    """Plain PyTorch phase 1: the sequential transliteration of the JAX
    ``_phase1_kernel``, one reference tile at a time. ``cross`` is an fp32
    matmul of the bf16 split values (each product exact in fp32, so only
    the order of the sums differs from the tensor cores), pinned to full
    fp32 so that TF32 cannot enter. Returns (min1, tid, m2x, t2v, tid2,
    t3v), each (m,): f32 values, i32 ids; tid counts ``ts``-wide subtiles,
    tid2 ``tile_n``-wide tiles."""
    m, kp, n_pad = _check_phase1(qc, rc, r2h, tile_n, ts)
    dev = qc.device
    ns = tile_n // ts
    rows = torch.cat([rc[s * kp:(s + 1) * kp] for s in _SPLIT_OF_BLOCK]).float()
    q = qc.float()
    r2 = r2h.reshape(-1)
    inf = torch.full((m,), float("inf"), device=dev)
    zero = torch.zeros((m,), dtype=torch.int32, device=dev)
    min1, tid, m2x, t2v, tid2, t3v = inf, zero, inf, inf, zero, inf
    scols = torch.arange(ns, dtype=torch.int32, device=dev)
    for j in range(n_pad // tile_n):
        lo = j * tile_n
        with full_fp32_matmul():
            cross = q @ rows[:, lo:lo + tile_n]
        e = r2[lo:lo + tile_n] - cross
        smin = e.view(m, ns, ts).amin(dim=2)
        tmin = smin.amin(dim=1)
        # Lowest subtile achieving tmin; its runner-up masks only that
        # POSITION, so an in-tile cross-subtile duplicate lands in smin2.
        sarg = torch.where(smin == tmin[:, None], scols, ns).amin(dim=1)
        smin2 = torch.where(scols == sarg[:, None], float("inf"), smin).amin(dim=1)
        stid = j * ns + sarg
        # Tile-level sorted top 3 from the pre-duel carry (c1 = min1).
        b1 = tmin < min1
        b2 = ~b1 & (tmin < t2v)
        t2v, tid2, t3v = (
            torch.where(b1, min1, torch.where(b2, tmin, t2v)),
            torch.where(b1, tid // ns, torch.where(b2, torch.full_like(tid2, j), tid2)),
            torch.where(b1 | b2, t2v, torch.minimum(t3v, tmin)),
        )
        # Strict < in ascending tile order keeps the lower subtile on ties.
        m2x = torch.where(b1, torch.minimum(min1, smin2), torch.minimum(m2x, tmin))
        min1, tid = torch.where(b1, tmin, min1), torch.where(b1, stid, tid)
    return min1, tid, m2x, t2v, tid2, t3v


def phase1_splits(m: int, n_tiles: int, slots: int) -> int:
    """Reference ranges S of the CUDA kernel's grid (whole tiles each): as
    many as fill the card's ``slots`` (resident blocks per SM times SMs)
    with (query tile, range) blocks in one wave, so no SM runs a block more
    than another; one range once the query tiles alone fill a wave."""
    q_tiles = -(-m // _KERNEL_BM)
    return max(1, min(slots // q_tiles, n_tiles))


def wgmma_chunk(ts: int) -> int:
    """Ref columns per chunk of the wgmma kernel: 128 where ts allows, else
    64 (wgmma_setup in csrc/expansion_phase1.cu)."""
    return 128 if ts % 128 == 0 else _KERNEL_BN


def wgmma_smem_bytes(kp16: int, bn: int) -> int:
    """Shared memory of the wgmma kernel with its query tile resident
    (wg_smem in csrc/expansion_phase1.cu): the (128, 6 kp16) bf16 query
    tile, kp16 = kp rounded up to 16, and a ring of stages, each ``bn``
    bf16 rows of ``rc_t`` (3 kp16 wide) and their f32 half-norms."""
    return _KERNEL_BM * 6 * kp16 * 2 + _WGMMA_STAGES * (bn * 3 * kp16 * 2 + bn * 4)


def _sliced_smem(ds: int, bn: int) -> int:
    """The sliced kernel's ring: stages of a (128, 6 ds) query slice, a
    (bn, 3 ds) rc_t slice and bn half-norms (wg_sliced_smem)."""
    return _WGMMA_STAGES * (_KERNEL_BM * 6 * ds * 2 + bn * 3 * ds * 2 + bn * 4)


def _qres_smem(kd: int, ds: int, bn: int) -> int:
    """The sliced kernel with its query tile resident (wg_qres_smem): the
    (128, 6 kd) query tile, then stages of a (bn, 3 ds) rc_t slice and bn
    half-norms."""
    return _KERNEL_BM * 6 * kd * 2 + _WGMMA_STAGES * (bn * 3 * ds * 2 + bn * 4)


@dataclass(frozen=True)
class Phase1Plan:
    """How the wgmma kernel runs phase 1 at kp: chunks of ``bn`` ref
    columns, the contraction in ``slices`` slices of ``ds`` dims (a multiple
    of 16, each of the six query blocks and three rc splits padded with
    zeros past kp), the (128, 6 slices ds) query tile resident in shared
    memory or (``query_resident`` False) restaged slice by slice with the
    rc slices, ``smem_bytes`` of shared memory. One slice is
    phase1_wgmma_kernel, more phase1_wgmma_sliced_kernel."""

    bn: int
    ds: int
    slices: int
    query_resident: bool
    smem_bytes: int


def phase1_plan(kp: int, ts: int, smem_optin: int) -> Phase1Plan | None:
    """The wgmma kernel's plan for kp and ts on a card whose blocks get
    ``smem_optin`` bytes of shared memory, or None where it has none (kp %
    8 != 0, ts % 64 != 0, or nothing fits). Chunks of 128 columns where ts
    % 128 == 0, then 64; the query tile resident (kp16 = kp rounded up to
    16, at most 96) for the first chunk width whose tile and ring fit; else
    the same with the rc splits in slices of 48, 32 or 16 dims (the widest
    that fits), for the first chunk width that has one; else query and rc
    slices together, the widest whose ring fits, for the first chunk width
    that has one. ``wgmma_setup`` in csrc/expansion_phase1.cu
    states the same rule (a GPU test holds the two together)."""
    if kp < _SUBLANE or kp % _SUBLANE or ts < _KERNEL_BN or ts % _KERNEL_BN:
        return None
    cap = min(smem_optin, _WGMMA_INSTANCE_SMEM)
    steps = -(-kp // _WGMMA_K)
    widths = (wgmma_chunk(ts), _KERNEL_BN)
    for bn in widths:
        if steps <= _WGMMA_MAX_RESIDENT_STEPS and wgmma_smem_bytes(16 * steps, bn) <= cap:
            return Phase1Plan(bn, 16 * steps, 1, True, wgmma_smem_bytes(16 * steps, bn))
    for bn in widths:
        for ds16 in range(_WGMMA_MAX_SLICE_STEPS, 0, -1):
            slices = -(-steps // ds16)
            smem = _qres_smem(16 * ds16 * slices, 16 * ds16, bn)
            if smem <= cap:
                return Phase1Plan(bn, 16 * ds16, slices, True, smem)
    for bn in widths:
        for ds16 in range(_WGMMA_MAX_SLICE_STEPS, 0, -1):
            if _sliced_smem(16 * ds16, bn) <= cap:
                return Phase1Plan(bn, 16 * ds16, -(-steps // ds16), False,
                                  _sliced_smem(16 * ds16, bn))
    return None


def _phase1_slots(lib, kp: int, dev, ts: int) -> int:
    """Resident blocks of the wgmma kernel per SM at kp and ts, times SMs."""
    per_sm = ctypes.c_int()
    rc = lib.nns_expansion_phase1_wgmma_blocks_per_sm(kp, ts, ctypes.byref(per_sm))
    _cuda.check(lib, rc, "expansion_phase1")
    return per_sm.value * n_sm(dev)


def _phase1_cuda(qc, rc_t, r2h, tile_n, ts):
    """Launch the wgmma kernel on its plan and the range merge. It reads
    ``rc_t``, the contiguous (n_pad, 3 kp) transpose of the split stack."""
    m, kp, n_pad = qc.shape[0], qc.shape[1] // 6, r2h.numel()
    if ts % _KERNEL_BN or kp % _SUBLANE:
        raise ValueError(f"expansion_phase1 needs ts % {_KERNEL_BN} == 0 and kp % "
                         f"{_SUBLANE} == 0, got ts={ts}, kp={kp}")
    if rc_t is None or tuple(rc_t.shape) != (n_pad, 3 * kp) \
            or rc_t.dtype != torch.bfloat16 or not rc_t.is_contiguous() \
            or rc_t.device != qc.device:
        raise ValueError(f"the wgmma kernel reads rc_t, the contiguous bf16 (n_pad, 3 kp) "
                         f"= {(n_pad, 3 * kp)} transpose of rc on {qc.device} "
                         f"(MXUExpansion keeps it)")
    if qc.data_ptr() % 16 or rc_t.data_ptr() % 16 or r2h.data_ptr() % 16:
        raise ValueError("expansion_phase1 needs qc, rc_t and r2h on 16-byte aligned "
                         "bases (16-byte cp.async)")
    lib = _cuda.library()
    dev = qc.device
    n_tiles = n_pad // tile_n
    with torch.cuda.device(dev):
        slots = _phase1_slots(lib, kp, dev, ts)
        per = -(-n_tiles // phase1_splits(m, n_tiles, slots))
        splits = -(-n_tiles // per)
        part_f = torch.empty((4, splits, m), dtype=torch.float32, device=dev)
        part_i = torch.empty((2, splits, m), dtype=torch.int32, device=dev)
        out_f, out_i = _empty_carries(m, dev)
        rc_ = lib.nns_expansion_phase1_wgmma(
            qc.data_ptr(), rc_t.data_ptr(), r2h.data_ptr(), m, kp, n_pad, tile_n, ts,
            per, splits, part_f.data_ptr(), part_i.data_ptr(), out_f.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc_, "expansion_phase1")
    _cuda.LAUNCHES["expansion_phase1"] += 1
    return _carries(out_f, out_i)


def phase1(qc: torch.Tensor, rc: torch.Tensor, r2h: torch.Tensor, tile_n: int, ts: int,
           rc_t: torch.Tensor | None = None):
    """Phase 1 of v9: (min1, tid, m2x, t2v, tid2, t3v), each (m,), for the
    (m, 6 kp) bf16 queries ``qc`` (``_cat_q`` layout) against the (3 kp,
    n_pad) bf16 split stack ``rc`` and the (n_pad,) or (1, n_pad) f32
    half-norms ``r2h``. CPU tensors take ``phase1_plain``; CUDA tensors
    launch the wgmma kernel of csrc/expansion_phase1.cu on the plan
    ``phase1_plan`` states (or raise: RuntimeError where the kernel has no
    plan or fails), counted in ``_cuda.LAUNCHES["expansion_phase1"]``. It
    reads ``rc_t``, the contiguous (n_pad, 3 kp) transpose of rc, which the
    caller must pass (``MXUExpansion.rc_t``); ``rc`` may then be any view
    of the same values."""
    m, kp, _ = _check_phase1(qc, rc, r2h, tile_n, ts)
    if qc.device.type == "cpu":
        return phase1_plain(qc, rc, r2h, tile_n, ts)
    if qc.device.type != "cuda":
        raise ValueError(f"unsupported device {qc.device}")
    if m == 0:
        return _carries(*_empty_carries(0, qc.device))
    return _phase1_cuda(qc.contiguous(), rc_t, r2h.contiguous(), tile_n, ts)


def _sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Direct f32 |q - r|^2 over the last axis, ``d2 = d2 + diff * diff``
    per dimension in ascending order (fused_min_idx_plain's arithmetic).
    ``q`` broadcasts against ``r``."""
    d2 = torch.zeros(torch.broadcast_shapes(q.shape, r.shape)[:-1],
                     dtype=torch.float32, device=r.device)
    for d in range(r.shape[-1]):
        diff = q[..., d] - r[..., d]
        d2 = d2 + diff * diff
    return d2


def _phase2_chunk(q, tid, m2x, refs_t, r2h_t, delta, ts):
    """Full-f32 rescan of each row's winning subtile. q (mc, kp) f32; tid
    (mc,) i32; m2x (mc,) f32; refs_t (n_sub, ts, kp) f32 zero-padded;
    r2h_t (n_sub, ts) (+inf on padded columns). Returns (idx, cert, min1)."""
    rsel = refs_t[tid.long()]                           # (mc, ts, kp)
    r2sel = r2h_t[tid.long()]                           # (mc, ts)
    cross = torch.zeros(rsel.shape[:2], dtype=torch.float32, device=q.device)
    for d in range(q.shape[1]):
        cross = cross + rsel[:, :, d] * q[:, None, d]
    ew = r2sel - cross
    wmin1 = ew.amin(dim=1)
    cols = torch.arange(ts, dtype=torch.int32, device=q.device)
    warg = torch.where(ew == wmin1[:, None], cols, ts).amin(dim=1)
    # In-subtile min2 masks only the argmin POSITION: in-subtile duplicates
    # are seen and fail the certificate.
    wmin2 = torch.where(cols == warg[:, None], float("inf"), ew).amin(dim=1)
    idx = tid * ts + warg
    cert = torch.minimum(wmin2, m2x) > wmin1 + 2.0 * delta
    return idx, cert, wmin1


def _pad_k(q: torch.Tensor, kp: int) -> torch.Tensor:
    return q if q.shape[1] == kp else torch.nn.functional.pad(q, (0, kp - q.shape[1]))


def _phase12(q, rc, rc_t, r2h, refs_t, r2h_t, delta, tile_n, ts):
    """k-pad + split + phase 1 + chunked phase 2 + certificate, for (m, kp)
    f32 queries ``q``. Returns per row (min1 f32, idx i32, cert bool) and
    the band feed (tid2 i32, t3v f32), each (m,)."""
    m, kp = q.shape
    qc = _cat_q(*split_bf16x3(q))
    _, tid, m2x, _, tid2, t3v = phase1(qc, rc, r2h, tile_n, ts, rc_t=rc_t)
    # Phase 2 in chunks of ~2^21 gathered points, for concatenated queues.
    mc = max(_SUBLANE, (_GATHER_POINTS // ts) // _SUBLANE * _SUBLANE)
    outs = [_phase2_chunk(q[lo:lo + mc], tid[lo:lo + mc], m2x[lo:lo + mc],
                          refs_t, r2h_t, delta, ts) for lo in range(0, m, mc)]
    if not outs:
        empty = torch.empty((0,), device=q.device)
        return empty, empty.int(), empty.bool(), tid2, t3v
    idx, cert, min1 = (torch.cat(parts) for parts in zip(*outs))
    return min1, idx, cert, tid2, t3v


def _band_refine_rows(q_bad, q2_bad, t12, t3, refs_t, r2h_t, delta, tile_n, n_total):
    """Band-limited refine of uncertified rows: a direct-f32 rescan of each
    row's top-2 tiles (winner's tile and phase 1's second-best), certified
    by the third-best tile minimum. Any point outside the two tiles has a
    true e >= t3 - delta, the gathered winner's is <= e_w + delta, so
    ``t3 > e_w + 2 delta`` proves no outside point can beat or tie it;
    inside, the scan is the contract's direct f32 with the lowest index
    on ties. Three tied tiles fail, as they must, and go to the full scan.

    q_bad (B, kp) f32; q2_bad (B,) |q|^2; t12 (B, 2) i32 tile ids; t3 (B,)
    f32; refs_t / r2h_t the phase-2 staging, viewed per tile. Returns
    (idx (B,) i32, ok (B,) bool)."""
    kp = refs_t.shape[2]
    refs_tiles = refs_t.reshape(-1, tile_n, kp)
    r2h_tiles = r2h_t.reshape(-1, tile_n)
    mc = max(_SUBLANE, (_GATHER_POINTS // (2 * tile_n)) // _SUBLANE * _SUBLANE)
    cols = torch.arange(tile_n, dtype=torch.int64, device=q_bad.device)
    idx, ok = [], []
    for lo in range(0, q_bad.shape[0], mc):
        tk = t12[lo:lo + mc].long()
        d2 = _sq_dist(q_bad[lo:lo + mc, None, None, :], refs_tiles[tk])  # (mc, 2, tile_n)
        d2 = torch.where(torch.isinf(r2h_tiles[tk]), float("inf"), d2)  # padding never wins
        d2f = d2.reshape(d2.shape[0], -1)
        idf = (tk[:, :, None] * tile_n + cols).reshape(d2.shape[0], -1)
        wmin = d2f.amin(dim=1)
        idx.append(torch.where(d2f == wmin[:, None], idf, n_total).amin(dim=1).to(torch.int32))
        e_w = 0.5 * wmin - 0.5 * q2_bad[lo:lo + mc]
        ok.append(t3[lo:lo + mc] > e_w + 2.0 * delta)
    return torch.cat(idx), torch.cat(ok)


def _full_scan_rows(qb, refs_t, n):
    """Tier-2 exact scan of the rows the band refine refused: direct f32
    over every reference point, lowest index on ties — what the v3 kernel
    computes, so it runs on the phase-2 staging viewed point-major
    (n_pad, kp), of which the first ``n`` rows are real. Returns idx (B,)."""
    return fused_point_major_min_idx(qb, refs_t.reshape(-1, refs_t.shape[2]), n)[1]


class StagedQueries:
    """A query set staged for MXUExpansion.query_staged: the host copy, the
    device copy (k-padded to kp) and the certificate band."""

    __slots__ = ("q_np", "q_dev", "delta")

    def __init__(self, q_np: np.ndarray, q_dev: torch.Tensor, delta: float):
        self.q_np = q_np
        self.q_dev = q_dev
        self.delta = delta


class MXUExpansion:
    """Prepare-once / query-many engine for v9. Staging, on ``device``: the
    bf16 split stack as the wgmma kernel reads it, ``rc_t`` (n_pad, 3 kp),
    with ``rc`` (3 kp, n_pad) a transposed view of it; the (1, n_pad) f32
    half-norms ``r2h`` (+inf past n); and for phase 2 the zero-padded f32
    refs ``refs_t`` (n_sub, ts, kp) with their half-norms ``r2h_t`` (n_sub,
    ts). The CUDA kernel picks its own query tile, so there is no
    ``tile_m``."""

    def __init__(self, refs, tile_n: int | None = None, tile_s: int | None = None,
                 device="cuda"):
        tile_n = 4096 if tile_n is None else tile_n
        refs = np.asarray(refs, dtype=np.float32)
        n, k = refs.shape
        if n >= 1 << 25:
            raise ValueError("MXUExpansion supports n < 2^25 (device staging)")
        if tile_n % _LANE:
            raise ValueError(f"tile_n={tile_n} must be a multiple of {_LANE}")
        kp = layouts.round_up(k, _SUBLANE)
        n_pad = layouts.round_up(n, max(tile_n, _LANE))
        tile_n = min(tile_n, n_pad)
        ts = 256 if tile_s is None else tile_s
        ts = ts if tile_n % ts == 0 else tile_n
        r = np.zeros((n_pad, kp), dtype=np.float32)
        r[:n, :k] = refs
        rh, rm, rl = split_bf16x3(torch.from_numpy(r))
        r2h = np.full((1, n_pad), np.inf, dtype=np.float32)
        r2h[0, :n] = (0.5 * (refs.astype(np.float64) ** 2).sum(axis=1)).astype(np.float32)
        n_sub = n_pad // ts
        self._place(refs, _stack_r(rh.t(), rm.t(), rl.t()).contiguous(), torch.from_numpy(r2h),
                    torch.from_numpy(r.reshape(n_sub, ts, kp)),
                    torch.from_numpy(np.ascontiguousarray(r2h.reshape(n_sub, ts))),
                    tile_n, ts, device)

    @classmethod
    def from_staged(cls, refs, rc, r2h, refs_t, r2h_t, tile_n: int, ts: int,
                    device="cuda") -> "MXUExpansion":
        """An engine over arrays already staged as ``__init__`` stages them
        (the JAX engine's, for one): ``refs`` (n, k) f32, ``rc`` (3 kp,
        n_pad) bf16, ``r2h`` (1, n_pad), ``refs_t`` (n_sub, ts, kp) and
        ``r2h_t`` (n_sub, ts) f32 tensors. Raises ValueError when the shapes
        do not nest."""
        refs = np.asarray(refs, dtype=np.float32)
        kp, n_pad = rc.shape[0] // 3, rc.shape[1]
        if (rc.shape[0] != 3 * kp or kp < refs.shape[1] or r2h.shape != (1, n_pad)
                or n_pad % tile_n or tile_n % ts
                or tuple(refs_t.shape) != (n_pad // ts, ts, kp)
                or tuple(r2h_t.shape) != tuple(refs_t.shape[:2])):
            raise ValueError(
                f"staged shapes rc {tuple(rc.shape)}, r2h {tuple(r2h.shape)}, refs_t "
                f"{tuple(refs_t.shape)}, r2h_t {tuple(r2h_t.shape)} do not match "
                f"k={refs.shape[1]}, tile_n={tile_n}, ts={ts}")
        eng = cls.__new__(cls)
        eng._place(refs, rc, r2h, refs_t, r2h_t, tile_n, ts, device)
        return eng

    def _place(self, refs, rc, r2h, refs_t, r2h_t, tile_n, ts, device):
        """Every attribute of the engine: the staged arrays moved to
        ``device``, and what follows from their shapes."""
        self.refs = refs
        self.n, self.k = refs.shape
        self.device = torch.device(device)
        self.tile_n, self.ts = int(tile_n), int(ts)
        self.kp = rc.shape[0] // 3
        self.rc_t = rc.to(self.device).t().contiguous()
        self.r2h = r2h.to(self.device)
        self.refs_t = refs_t.to(self.device)
        self.r2h_t = r2h_t.to(self.device)
        self._r2_max = 2.0 * float(r2h[0, : self.n].max()) if self.n else 0.0

    @property
    def rc(self) -> torch.Tensor:
        """The (3 kp, n_pad) bf16 split stack [rh; rm; rl]: a transposed view
        of ``rc_t`` (not contiguous, no copy)."""
        return self.rc_t.t()

    @spanned("nns.mxu.stage_queries")
    def stage_queries(self, queries) -> StagedQueries:
        """Stage a query set on the device and compute its band ``delta``
        on the host (the upload leaves the serving drain)."""
        q_np = np.asarray(queries, dtype=np.float32)
        m, k = q_np.shape
        if k != self.k:
            raise ValueError(f"dimension mismatch: queries k={k}, refs k={self.k}")
        q2_max = float((q_np.astype(np.float64) ** 2).sum(axis=1).max()) if m else 0.0
        delta = _DELTA_REL_PER_K * max(self.k, 1) * (q2_max + self._r2_max)
        count_copy("up", q_np.nbytes, self.device)
        return StagedQueries(q_np, _pad_k(as_f32(q_np, self.device), self.kp), float(delta))

    @spanned("nns.mxu.phase12")
    def _phase12_staged(self, st: StagedQueries):
        return _phase12(st.q_dev, self.rc, self.rc_t, self.r2h, self.refs_t, self.r2h_t,
                        st.delta, self.tile_n, self.ts)

    def query_min_idx_cert(self, queries):
        """(min1 f32, idx i32, cert bool) numpy arrays: phase 2's f32
        half-expansion of each row's winner, the winner, and whether the
        certificate proves it."""
        min1, idx, cert, _, _ = self._phase12_staged(self.stage_queries(queries))
        return min1.cpu().numpy(), idx.cpu().numpy(), cert.cpu().numpy()

    def _drain_staged(self, st: StagedQueries) -> torch.Tensor:
        """The serving drain on the device: phase 1 + 2, then the band
        refine of the uncertified rows and the full scan of the rows it
        refuses, found with torch.nonzero. Returns idx (m,) i32."""
        _, idx, cert, tid2, t3v = self._phase12_staged(st)
        with span("nns.mxu.certify"):
            bad = torch.nonzero(~cert).flatten()
        COUNTS["mxu.rows"] += idx.shape[0]
        COUNTS["mxu.certified_rows"] += idx.shape[0] - bad.numel()
        if bad.numel() == 0:
            return idx
        q = st.q_dev
        with span("nns.mxu.band_refine"):
            qb = q[bad]
            q2b = (qb * qb).sum(dim=1)
            t12 = torch.stack([idx[bad] // self.tile_n, tid2[bad]], dim=1)
            n_total = self.refs_t.shape[0] * self.ts
            ridx, rok = _band_refine_rows(qb, q2b, t12, t3v[bad], self.refs_t, self.r2h_t,
                                          st.delta, self.tile_n, n_total)
            idx[bad] = ridx
            bad2 = bad[~rok]
        if bad2.numel():
            with span("nns.mxu.full_scan"):
                idx[bad2] = _full_scan_rows(q[bad2], self.refs_t, self.n)
        return idx

    def query_staged(self, st: StagedQueries) -> np.ndarray:
        """Exact 1-NN indices (m,) i32 of a staged query set."""
        if st.q_np.shape[0] == 0:
            return np.zeros((0,), dtype=np.int32)
        idx = self._drain_staged(st)
        with span("nns.mxu.download"):
            out = idx.cpu().numpy()
        count_copy("down", out.nbytes, self.device)
        return out

    def query(self, queries) -> np.ndarray:
        """Exact 1-NN indices (m,) i32: every row certified, band-refined
        or fully scanned."""
        return self.query_staged(self.stage_queries(queries))


def nns_mxu_expansion(queries, refs, tile_n: int | None = None, device="cuda") -> np.ndarray:
    """v9 one-shot. k < 8 routes to the exact fused scan (v4), as the JAX
    package does: at low k the expansion gaps fall under any sound band."""
    if refs.shape[1] < 8:
        return fused_fallback(queries, refs, device=device).cpu().numpy()
    return MXUExpansion(refs, tile_n=tile_n, device=device).query(queries)
