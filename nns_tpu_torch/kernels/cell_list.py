"""Supercell (cell-list) engine — exact low-dim NN through a dense spatial
index. Counterpart of ``nns_tpu/kernels/cell_list.py``.

Build (host): partition the bounding box into D^3 equal supercells and, for
every supercell, precompute its HALO point set — all reference points within
``halo`` of the supercell box — as one dense dim-major (G, 3, R_max) tensor
padded with distance sentinels, plus the (G, R_max) global ids. The native
C++ counting-sort build (the JAX package's ``nns_cpu.cpp``) serves halos up
to W/2; wider halos use the numpy enumeration.

Query: the queries of a slot are scanned in a dense (G, QM, 3) table by
``cell_scan`` (``csrc/cell_scan.cu``: persistent blocks walk the
supercells, score each supercell's distinct slots once and stream its halo
through a bulk-copy ring), which finds each slot's nearest halo point and
folds the exactness certificate into the id's sign bit (id when best <=
halo^2, -id-1 otherwise); a gather takes each row's winner at its slot.
Rows the certificate cannot prove are re-answered exactly by the fused
brute force. The queue drain (``query_queue``) bins on the device: one
upload of the queue's raw rows, ``bin_queue`` (``csrc/cell_bin.cu``: each
row's supercell and slot, each batch's largest supercell), one small
download of those maxima, then per part of at most ``_QUEUE_SLOTS``
slots (``queue_parts``) ``place_queue`` into one table and a scan per
batch. On a CUDA device ``cell_answer`` (``csrc/cell_bin.cu``) then
decodes each part's rows, masks the sentinel corner and lists the
uncertified rows, which one fused call per queue re-answers; one download
of the counts, one of the (m,) answers. On a CPU device one gather per
part, one (m,) download and the host tail (``_answer_queue``). A single batch
(``query_submit``) is bucketed on the host (``stage``: the native sort)
into one (m, 5) f32 pack [x, y, z, sid, pos], uploaded and scattered on
the device (``_query_body``).

Ids travel as int32 end to end: the JAX package's hi/lo 12-bit f32 id split
was a workaround for its device transit and has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels.fused import FusedBruteForce, as_f32, fused_fallback
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL, non_finite_error
from nns_tpu_torch.kernels.layouts import pow2_at_least as _pow2_at_least
from nns_tpu_torch.kernels.topk import direct_d2, nns_topk, smallest
from nns_tpu_torch.utils.spans import COUNTS, count_copy, span, spanned

# Queries per supercell the CUDA kernel takes (kMaxQM in csrc/cell_scan.cu).
_KERNEL_MAX_QM = 2048
# Bound on the plain version's (groups, QM, R_max) f32 distance block.
_PLAIN_BLOCK = 1 << 26
# Bound on the k-NN path's (queries, R_max) distance block: 16M f32, as the
# JAX package bounds its per-group block.
_TOPK_BLOCK = 16 << 20
# _sentinel_risk's margin below its bound: four f32 ulps at PAD_SENTINEL.
_SENTINEL_MARGIN = 4.0 * float(np.spacing(np.float32(PAD_SENTINEL)))
# Slots of one part of the queue drain's dense table: 20 bytes a slot (the
# (slots, 3) f32 table, the scan's f32 minima and i32 winners), 160 MiB.
# A queue whose tables need more is placed, scanned and gathered part by
# part, so the drain's device memory does not grow with the queue.
_QUEUE_SLOTS = 1 << 23


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


def _launch_scan(lib, stream, q_ptr: int, halo_dm: torch.Tensor, halo_ids: torch.Tensor,
                 g_total: int, qm: int, halo2: float, d_ptr: int, i_ptr: int) -> None:
    """One ``nns_cell_scan`` launch on ``stream`` over the (g_total, qm, 3)
    table at ``q_ptr``, writing (g_total, qm) f32 / i32 at ``d_ptr`` /
    ``i_ptr``."""
    rc = lib.nns_cell_scan(q_ptr, halo_dm.data_ptr(), halo_ids.data_ptr(), g_total, qm,
                           halo_dm.shape[2], halo2, d_ptr, i_ptr, stream)
    _cuda.check(lib, rc, "cell_scan")
    _cuda.LAUNCHES["cell_scan"] += 1


def _cell_scan_cuda(dense_q, halo_dm, halo_ids, halo2):
    g_total, qm, _ = dense_q.shape
    dev = dense_q.device
    out_d = torch.empty((g_total, qm), dtype=torch.float32, device=dev)
    out_i = torch.empty((g_total, qm), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch_scan(_cuda.library(), torch.cuda.current_stream(dev).cuda_stream,
                     dense_q.data_ptr(), halo_dm, halo_ids, g_total, qm, halo2,
                     out_d.data_ptr(), out_i.data_ptr())
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


def _upload(rows, device) -> torch.Tensor:
    """``rows`` (numpy or a tensor) as an f32 tensor on ``device``. A numpy
    array bound for a CUDA device goes through a pinned staging copy, so the
    upload is queued on the current stream and the host does not wait for
    the work queued before it."""
    device = torch.device(device)
    if isinstance(rows, torch.Tensor) or device.type != "cuda":
        return as_f32(rows, device)
    return _to_device(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)), device)


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``. For a CUDA device the copy goes from
    pinned memory (``host`` is pinned first if it is not), queued on the
    current stream, and is counted into ``copy.bytes_up``."""
    if device.type != "cuda":
        return host.to(device)
    if not host.is_pinned():
        host = host.pin_memory()
    count_copy("up", host.nbytes, device)
    return host.to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array. A CUDA tensor comes down in one blocking copy
    into pinned memory from PyTorch's pinned-memory cache: a caller that
    keeps views of one download while the next runs (the queue drain hands
    back its answers uncopied) would otherwise make each download fault in
    fresh pageable pages. The block returns to the cache when its last view
    is dropped."""
    if t.device.type != "cuda":
        return t.numpy()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t).numpy()


def _upload_queue(queries: list[np.ndarray], device) -> tuple[torch.Tensor, torch.Tensor]:
    """A queue's (m, 3) f32 batches on ``device`` as their concatenation
    (rows, 3) f32 and the (batches + 1,) i32 row offsets. For a CUDA device
    both share one pinned buffer, filled in place, and one copy."""
    device = torch.device(device)
    offs = np.zeros(len(queries) + 1, dtype=np.int64)
    np.cumsum([len(q) for q in queries], out=offs[1:])
    rows = int(offs[-1])
    if rows >= 1 << 30:
        raise ValueError(f"a queue of {rows} rows: the drain takes fewer than 2^30")
    if device.type != "cuda":
        return (torch.from_numpy(np.concatenate(queries).reshape(rows, 3)).to(device),
                torch.from_numpy(offs.astype(np.int32)).to(device))
    host = torch.empty(3 * rows + len(offs), dtype=torch.float32, pin_memory=True)
    buf = host.numpy()
    np.concatenate(queries, out=buf[:3 * rows].reshape(rows, 3))
    buf[3 * rows:].view(np.int32)[:] = offs
    dev = _to_device(host, device)
    return dev[:3 * rows].view(rows, 3), dev[3 * rows:].view(torch.int32)


def _check_queue(rows: torch.Tensor, offs: torch.Tensor, *more: torch.Tensor) -> None:
    """A binned queue's tensors before their pointers reach a kernel: (m, 3)
    f32 rows, (batches + 1,) i32 offsets, on one device, contiguous."""
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 3:
        raise ValueError(f"queue rows must be (m, 3) f32; got {tuple(rows.shape)} {rows.dtype}")
    if offs.dtype != torch.int32 or offs.dim() != 1 or offs.shape[0] < 1:
        raise ValueError(f"queue offsets must be (batches + 1,) i32; got {offs.dtype}")
    for t in (rows, offs, *more):
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError("a queue's tensors must be contiguous and on one device")


def bin_queue_plain(rows: torch.Tensor, offs: torch.Tensor, d_per_dim: int, mn, w):
    """Plain PyTorch binning of a queue (``bin_queue``): float64 torch ops
    for the supercell ids (the host sort's expression), ``bincount`` for the
    counts and a stable sort for the slots, which follow the row order
    inside each (batch, supercell); ``isfinite`` for the non-finite rows."""
    dev = rows.device
    nb, groups = offs.shape[0] - 1, d_per_dim ** 3
    mn = torch.as_tensor(np.asarray(mn, dtype=np.float64), device=dev)
    w = torch.as_tensor(np.asarray(w, dtype=np.float64), device=dev)
    c = torch.floor((rows.double() - mn) / w)
    c = torch.fmin(torch.fmax(c, c.new_zeros(())), c.new_full((), d_per_dim - 1)).long()
    sid = (c[:, 0] * d_per_dim + c[:, 1]) * d_per_dim + c[:, 2]
    offs = offs.long()
    batch = torch.repeat_interleave(torch.arange(nb, device=dev), offs[1:] - offs[:-1])
    key = batch * groups + sid
    counts = torch.bincount(key, minlength=nb * groups)
    order = torch.argsort(key, stable=True)
    pos = torch.empty_like(key)
    pos[order] = torch.arange(len(key), device=dev) - (torch.cumsum(counts, 0) - counts)[key[order]]
    counts = counts.view(nb, groups).int()
    nonfinite = (~torch.isfinite(rows).all(1)).sum().view(1).int()
    return sid.int(), pos.int(), counts, torch.cat([counts.amax(1), nonfinite])


def bin_queue(rows: torch.Tensor, offs: torch.Tensor, max_rows: int, d_per_dim: int, mn, w):
    """Bin a queue's rows into supercells: rows (rows, 3) f32 and offs
    (batches + 1,) i32 on one device, max_rows the largest batch, the grid's
    D per dimension, its float64 origin ``mn`` and widths ``w`` (3,) ->
    (sid (rows,) i32, pos (rows,) i32: the row's slot in its (batch,
    supercell), counts (batches, D^3) i32, maxima (batches + 1,) i32: each
    batch's largest count, then the number of rows with a NaN or an
    infinity in any coordinate). sid and the counts equal the host sort's
    (``CellListEngine.stage``); slots are an order of the rows inside their
    supercell. A non-finite row is binned all the same (a NaN to
    supercell 0 per dimension, an infinity to the nearest end); the drain
    (``CellListEngine._bin``) raises ValueError on a count above 0 before
    any table is placed or scanned. CPU tensors take ``bin_queue_plain``;
    CUDA tensors launch ``csrc/cell_bin.cu``'s kernel (or raise
    RuntimeError)."""
    _check_queue(rows, offs)
    if rows.device.type == "cpu":
        return bin_queue_plain(rows, offs, d_per_dim, mn, w)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    dev, nb, groups = rows.device, offs.shape[0] - 1, d_per_dim ** 3
    sid_pos = torch.empty((2, rows.shape[0]), dtype=torch.int32, device=dev)
    state = torch.zeros(nb * groups + nb + 1, dtype=torch.int32, device=dev)
    geo = np.ascontiguousarray(np.concatenate([mn, w]), dtype=np.float64)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_cell_bin(rows.data_ptr(), offs.data_ptr(), nb, max_rows, d_per_dim,
                              geo.ctypes.data, sid_pos[0].data_ptr(), sid_pos[1].data_ptr(),
                              state.data_ptr(), state[nb * groups:].data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "cell_bin")
    _cuda.LAUNCHES["cell_bin"] += 1
    return sid_pos[0], sid_pos[1], state[:nb * groups].view(nb, groups), state[nb * groups:]


def place_queue_plain(rows, offs, sid, pos, plan, slots: int, slot):
    """Plain PyTorch ``place_queue``: an index-put of the rows of each
    batch with a table at their (offset, sid, pos)."""
    dev = rows.device
    lo, hi = int(offs[0]), int(offs[-1])
    offs = offs.long()
    batch = torch.repeat_interleave(torch.arange(offs.shape[0] - 1, device=dev),
                                    offs[1:] - offs[:-1])
    base, qm = plan[batch, 0], plan[batch, 1]
    keep = qm > 0
    at = torch.where(keep, base + sid[lo:hi].long() * qm + pos[lo:hi].long(), slots)
    table = torch.zeros((slots, 3), dtype=torch.float32, device=dev)
    table[at[keep]] = rows[lo:hi][keep]
    slot[lo:hi] = at
    return table


def place_queue(rows: torch.Tensor, offs: torch.Tensor, max_rows: int, sid: torch.Tensor,
                pos: torch.Tensor, plan: torch.Tensor, slots: int,
                slot: torch.Tensor) -> torch.Tensor:
    """Write the rows of a binned queue (``bin_queue``) into one dense
    table. ``offs`` is the queue's (batches + 1,) i32 offsets or a run of
    them (``offs[a:b + 1]``: batches a to b - 1 alone), plan (batches, 2)
    i64 on the rows' device holds each of those batches' first slot and
    its q_max (0 for a batch with no table), the table has ``slots`` slots.
    Writes into ``slot`` (rows,) i64, at each row of the run, the row's
    flat slot (``slots`` for the rows of a batch with no table), leaving
    the other rows' entries as they are, and returns the table (slots, 3)
    f32, zero where no row lands. CPU tensors take
    ``place_queue_plain``; CUDA tensors launch ``csrc/cell_bin.cu``'s
    kernel (or raise RuntimeError)."""
    n = rows.shape[0]
    _check_queue(rows, offs, sid, pos, plan, slot)
    if (sid.dtype != torch.int32 or pos.dtype != torch.int32 or plan.dtype != torch.int64
            or slot.dtype != torch.int64 or sid.shape != (n,) or pos.shape != (n,)
            or slot.shape != (n,) or plan.shape != (offs.shape[0] - 1, 2)):
        raise ValueError("place_queue takes (m,) i32 sid and pos, a (batches, 2) i64 plan "
                         "and an (m,) i64 slot")
    if rows.device.type == "cpu":
        return place_queue_plain(rows, offs, sid, pos, plan, slots, slot)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    dev = rows.device
    table = torch.zeros((slots, 3), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_cell_place(rows.data_ptr(), offs.data_ptr(), offs.shape[0] - 1, max_rows,
                                sid.data_ptr(), pos.data_ptr(), plan.data_ptr(), slots,
                                table.data_ptr(), slot.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "cell_place")
    _cuda.LAUNCHES["cell_place"] += 1
    return table


def cell_answer_plain(rows, offs, plan, win, slot, lim: float, idx, certified, bad,
                      cursor) -> None:
    """Plain PyTorch ``cell_answer``: the decode (``_unstage``'s) and the
    sentinel mask (``_sentinel_risk``'s f64 pass, in its order) in torch
    ops; the uncertified rows are appended in row order."""
    dev = rows.device
    lo, hi = int(offs[0]), int(offs[-1])
    offs = offs.long()
    batches = offs.shape[0] - 1
    batch = torch.repeat_interleave(torch.arange(batches, device=dev), offs[1:] - offs[:-1])
    tabled = plan[batch, 1] > 0
    sg = torch.where(tabled, win[torch.where(tabled, slot[lo:hi], 0)], -1)
    t = rows[lo:hi].double() - PAD_SENTINEL
    d2 = torch.zeros(hi - lo, dtype=torch.float64, device=dev)
    for d in range(3):
        d2 = d2 + t[:, d] * t[:, d]
    ok = (sg >= 0) & ~(d2 <= lim)
    idx[lo:hi] = sg ^ (sg >> 31)
    certified += torch.bincount(batch[ok], minlength=batches).int()
    listed = torch.nonzero(~ok).flatten().int() + lo
    n = int(cursor[0])
    bad[n:n + len(listed)] = listed
    cursor += len(listed)


def cell_answer(rows: torch.Tensor, offs: torch.Tensor, max_rows: int, plan: torch.Tensor,
                win: torch.Tensor, slot: torch.Tensor, lim: float, idx: torch.Tensor,
                certified: torch.Tensor, bad: torch.Tensor, cursor: torch.Tensor) -> None:
    """Answer the rows of a part of a binned queue after its scans, in the
    caller's order, as the host tail does per batch (``_unstage``,
    ``_sentinel_risk``). ``offs`` and ``plan`` are the part's run, as
    ``place_queue`` took them, ``win`` the part's signed winner per slot
    (``_scan_table``), ``slot`` (rows,) i64 as ``place_queue`` wrote it,
    ``lim`` the f64 (2 halo)^2. Writes into ``idx`` (rows,) i32, at each
    row of the run, the decoded winner (0 for the rows of a batch with no
    table); adds each batch's certified rows (a winner that its scan
    certified and no sentinel risk) into ``certified`` (batches,) i32;
    appends every other row's queue position to ``bad`` (rows,) i32 at
    ``cursor`` (1,) i32, which it advances. CPU tensors take
    ``cell_answer_plain``; CUDA tensors launch ``csrc/cell_bin.cu``'s
    kernel (or raise RuntimeError), whose list is in no fixed order."""
    n, batches = rows.shape[0], offs.shape[0] - 1
    _check_queue(rows, offs, plan, win, slot, idx, certified, bad, cursor)
    if (plan.dtype != torch.int64 or plan.shape != (batches, 2) or win.dtype != torch.int32
            or win.dim() != 1 or slot.dtype != torch.int64 or slot.shape != (n,)
            or any(t.dtype != torch.int32 for t in (idx, certified, bad, cursor))
            or idx.shape != (n,) or bad.shape != (n,) or certified.shape != (batches,)
            or cursor.shape != (1,)):
        raise ValueError("cell_answer takes a (batches, 2) i64 plan, (slots,) i32 winners, "
                         "an (m,) i64 slot and i32 outputs")
    if rows.device.type == "cpu":
        return cell_answer_plain(rows, offs, plan, win, slot, lim, idx, certified, bad, cursor)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    dev = rows.device
    geo = np.array([PAD_SENTINEL, lim], dtype=np.float64)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_cell_answer(rows.data_ptr(), offs.data_ptr(), batches, max_rows,
                                 plan.data_ptr(), win.data_ptr(), slot.data_ptr(),
                                 geo.ctypes.data, idx.data_ptr(), certified.data_ptr(),
                                 bad.data_ptr(), cursor.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "cell_answer")
    _cuda.LAUNCHES["cell_answer"] += 1


def queue_parts(q_max: np.ndarray, groups: int, budget: int
                ) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    """Cut a binned queue's tables into parts of at most ``budget`` slots:
    q_max (batches,) each batch's q_max (0: no table), ``groups`` slots
    per unit of q_max -> (plan (batches, 2) i64: each batch's first slot
    in its part and its q_max; parts [(first batch, end batch, slots)],
    in order, covering every batch with a table). Batches stay in queue
    order; a batch larger than the budget makes a part alone."""
    size = groups * np.asarray(q_max, dtype=np.int64)
    plan = np.zeros((len(size), 2), dtype=np.int64)
    plan[:, 1] = q_max
    parts, start, used = [], 0, 0
    for b, n in enumerate(size.tolist()):
        if used and used + n > budget:
            parts.append((start, b, used))
            start, used = b, 0
        plan[b, 0] = used
        used += n
    if used:
        parts.append((start, len(size), used))
    return plan, parts


def _scan_table(table: torch.Tensor, plan: np.ndarray, g_total: int, halo_dm: torch.Tensor,
                halo_ids: torch.Tensor, halo2: float) -> torch.Tensor:
    """``cell_scan`` of each batch's (g_total, q_max, 3) stretch of a
    drain's table (host ``plan`` (batches, 2): first slot, q_max; 0
    scans nothing), all on the current stream -> the signed winner of every
    slot, (slots + 1,) i32; the last entry is never written."""
    slots, dev = table.shape[0], table.device
    win = torch.empty(slots + 1, dtype=torch.int32, device=dev)
    batches = [(int(base), int(qm)) for base, qm in plan if qm]
    if dev.type == "cpu":
        for base, qm in batches:
            part = table[base:base + g_total * qm].view(g_total, qm, 3)
            win[base:base + g_total * qm] = cell_scan_plain(part, halo_dm, halo_ids,
                                                            halo2)[1].reshape(-1)
        return win
    dmin = torch.empty(slots, dtype=torch.float32, device=dev)
    lib, t_ptr, d_ptr, w_ptr = _cuda.library(), table.data_ptr(), dmin.data_ptr(), win.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for base, qm in batches:
            _launch_scan(lib, stream, t_ptr + 12 * base, halo_dm, halo_ids, g_total, qm, halo2,
                         d_ptr + 4 * base, w_ptr + 4 * base)
    return win


def _query_body(staged: torch.Tensor, halo_dm: torch.Tensor, halo_ids: torch.Tensor,
                halo2: float, q_max: int, g_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One staged batch on its device: the (m, 5) f32 pack [x, y, z, sid,
    pos] of ``CellListEngine.stage`` is scattered into the dense
    (g_total, q_max, 3) table (the (sid, pos) pairs are unique, so the put
    is deterministic), scanned by ``cell_scan``, and each row's winner is
    gathered at its (sid, pos). sid and pos are exact in f32 below 2^24.
    Returns, in staged order, the signed winner (m,) i32 (the id, or -id-1
    when the row is uncertified) and the f32 min d2 (m,)."""
    sid, pos = staged[:, 3:5].long().unbind(1)
    dense = torch.zeros((g_total, q_max, 3), dtype=torch.float32, device=staged.device)
    dense[sid, pos] = staged[:, :3]
    dmin, sgid = cell_scan(dense, halo_dm, halo_ids, halo2)
    return sgid[sid, pos], dmin[sid, pos]


def _device_query_topk(q_sorted: torch.Tensor, sid: torch.Tensor, halo_dm: torch.Tensor,
                       halo_ids: torch.Tensor, halo2: float, k_nn: int):
    """Exact k-NN of each staged query over its supercell's halo set (torch
    ops): (d2 (m, k_nn) f32 ascending, ids (m, k_nn) i32, certified (m,)
    bool). Distances are ``topk.direct_d2``'s over the gathered halos;
    among equal distances the lower halo slot comes first, as the JAX
    package's ``lax.top_k`` orders them. The certificate holds iff the k-th
    distance is within halo (no unscanned point can then belong to the true
    top-k, modulo exact ties); fewer halo slots than k_nn certify nothing."""
    m = q_sorted.shape[0]
    r_max = halo_dm.shape[2]
    kk = min(k_nn, r_max)
    dev = q_sorted.device
    d_out = torch.full((m, k_nn), float("inf"), dtype=torch.float32, device=dev)
    i_out = torch.zeros((m, k_nn), dtype=torch.int32, device=dev)
    rows = max(1, _TOPK_BLOCK // r_max)
    for lo in range(0, m, rows):
        g = sid[lo:lo + rows]
        d2 = direct_d2(q_sorted[lo:lo + rows], halo_dm[g].transpose(1, 2))
        dist, slot = smallest(d2, kk)
        d_out[lo:lo + rows, :kk] = dist
        i_out[lo:lo + rows, :kk] = halo_ids[g[:, None], slot.long()]
    ok = d_out[:, -1] <= halo2 if kk == k_nn else torch.zeros(m, dtype=torch.bool, device=dev)
    return d_out, i_out, ok


class CellToken(NamedTuple):
    """A submitted batch (``CellListEngine.query_submit``): its winners at
    the staged rows, still on the device ((2, m) i32: the signed winners and
    the bits of their f32 min d2; (1, m), the winners alone, from the
    sharded engine; None when the batch was too skewed for the scan), the
    staging order, the sentinel-risk mask and the queries."""

    winners: torch.Tensor | None
    order: np.ndarray
    risk: np.ndarray | None
    queries: np.ndarray


class BinnedQueue(NamedTuple):
    """A queue binned on its device (``CellListEngine._bin``): its rows and
    offsets as uploaded, each row's supercell and slot (``bin_queue``), the
    host's plan and parts of the tables (``queue_parts``; q_max 0: no
    table), the host's (batches + 1,) row offsets and which batches were
    too skewed for the scan."""

    rows: torch.Tensor
    offs: torch.Tensor
    sid: torch.Tensor
    pos: torch.Tensor
    plan: np.ndarray
    parts: list
    ends: np.ndarray
    skewed: np.ndarray


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
        """Move the index onto ``device``: halo points and ids for the scan.
        The exact fallback stages the refs (dim-major, padded) at its first
        call and keeps them (``_fallback_engine``)."""
        self.device = torch.device(device)
        self.halo_dm = torch.as_tensor(halo_dm_np, device=self.device)
        self.halo_ids = halo_ids
        self.halo_ids_dev = torch.as_tensor(halo_ids, device=self.device)
        self._fused = None
        # The certificate radius squared, rounded to f32 like the scan's d2.
        self.halo2 = float(np.float32(self.halo) ** 2)

    # -- query ------------------------------------------------------------

    def _sentinel_risk(self, q: np.ndarray) -> np.ndarray | None:
        """Bool mask of queries close enough to the PAD_SENTINEL corner
        (coordinates 1e6 per dim) that a padded halo slot could win the scan
        AND pass the <= halo certificate — possible only when the data
        itself lives near 1e6. Such queries are forced uncertified on the
        host, so they take the exact fallback (the drain on a CUDA device
        runs the same f64 pass on the card: ``cell_answer``). None when no
        query is at risk (the common case).

        A row at risk has every coordinate within 2 halo of PAD_SENTINEL, so
        when each row has one below PAD_SENTINEL - 2 halo (less a margin of
        four f32 ulps at 1e6, far above the f64 pass's rounding) the f64
        pass is skipped: it would find no row."""
        # Each row's smallest coordinate, column by column (numpy's min
        # over a 3-wide axis is far slower).
        low = np.minimum(np.minimum(q[:, 0], q[:, 1]), q[:, 2])
        if len(q) and float(low.max()) < PAD_SENTINEL - 2.0 * self.halo - _SENTINEL_MARGIN:
            return None
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

    @spanned("nns.cells.stage")
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

    def query_staged(self, packed, q_max: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Device half of one batch: a staged (m, 5) pack (numpy or a tensor)
        goes up in one copy and ``_query_body`` runs on the current stream,
        with no synchronization. Returns, on the device and in staged order,
        the signed winners (m,) i32 and the f32 min d2 (m,). They are the
        JAX package's packed (4, m) [idx_hi, idx_lo, ok, best_d2]: idx is
        the winner w when w >= 0 and -w-1 otherwise (hi << 12 | lo there),
        ok is w >= 0, best_d2 is the min d2."""
        return _query_body(_upload(packed, self.device), self.halo_dm, self.halo_ids_dev,
                           self.halo2, q_max, self.D ** 3)

    def _dense_scatter(self, packed: np.ndarray, q_max: int):
        """One staged (m, 5) pack -> (dense (G, q_max, 3) f32, flat winner
        slots (m,) i32): the host dense-scatter of ``stage_queue_ragged``.
        The serving paths scatter on the device (``_query_body``)."""
        sid = packed[:, 3].astype(np.int64)
        pos = packed[:, 4].astype(np.int64)
        dense = np.zeros((self.D ** 3, q_max, 3), np.float32)
        dense[sid, pos] = packed[:, :3]
        return dense, (sid * q_max + pos).astype(np.int32)

    def stage_queue_ragged(self, batches):
        """Host-staged queue (the JAX package's queue staging; no serving
        path of the port uses it): each batch keeps its OWN pow2 q_max and
        is scattered on the host into a dense table. Returns (denses [list
        of (G, qm_b, 3)], fslots [list of (m,) i32], orders), or (None,
        None, None) when any batch is too skewed for the dense kernel."""
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
        """Device half of the host-staged queue: one scan launch per dense
        batch, all on the current stream, no synchronization. ``denses`` is
        a sequence of (G, qm_b, 3) arrays (numpy or tensors); returns the
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
        """Host half of the host-staged queue for one batch: dense (G*QM,)
        signed winners + the batch's flat slots and staging order -> (idx,
        ok) in the caller's original query order."""
        got = np.asarray(out_w).reshape(-1)[fslots]  # (m,) signed, staged order
        m = len(order)
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        got = got[inv]
        ok = got >= 0
        idx = np.where(ok, got, -got - 1).astype(np.int32)
        return idx, ok

    @staticmethod
    def _unstage(signed: np.ndarray, order: np.ndarray | None,
                 risk: np.ndarray | None) -> tuple[np.ndarray, np.ndarray]:
        """Signed winners -> (idx, certified) in the caller's order:
        ``signed`` is in the host sort's staged order when ``order`` is
        given, else already in the caller's order (the device-binned
        drain). Rows near the sentinel corner (``risk``) are uncertified.
        Every host path that decodes signed winners decodes them here: the
        single batches, the sharded drain and the drain on a CPU device
        (``_answer_queue``). The drain on a CUDA device decodes on the card
        (``cell_answer``), which the tests hold bit-equal to this method
        and ``_sentinel_risk``. ``portbench/tests/test_portbench_run.py``
        plants its altered answer in this method and expects it to reach
        every v14 cell it runs on the CPU."""
        sg = signed
        if order is not None:
            sg = np.empty(len(order), dtype=np.int32)
            sg[order] = signed
        ok = sg >= 0
        idx = sg ^ (sg >> 31)  # sg where sg >= 0, ~sg = -sg - 1 elsewhere
        if risk is not None:
            ok &= ~risk  # sentinel-corner proximity: force the exact path
        return idx, ok

    def _exact_rows(self, queries: np.ndarray, idx: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Re-answer the uncertified rows (``ok`` False) with the exact fused
        scan, in place."""
        if not ok.all():
            with span("nns.cells.exact_rows"):
                bad = np.flatnonzero(~ok)
                q_bad = np.ascontiguousarray(queries, dtype=np.float32)[bad]
                count_copy("up", q_bad.nbytes, self.device)
                got = self._fallback_engine().fallback(q_bad).cpu().numpy()
                count_copy("down", got.nbytes, self.device)
                idx[bad] = got
            COUNTS["cells.exact_calls"] += 1
        return idx

    @staticmethod
    def _coverage(rows: int, certified: int) -> float:
        """The certified fraction of a batch's rows (1.0 for none), counted
        into ``cells.rows`` and ``cells.certified_rows``."""
        COUNTS["cells.rows"] += rows
        COUNTS["cells.certified_rows"] += certified
        return certified / rows if rows else 1.0

    def _fallback_engine(self) -> FusedBruteForce:
        """The exact fallback's engine over the refs, staged once."""
        if self._fused is None:
            self._fused = FusedBruteForce(self.refs, device=self.device)
        return self._fused

    def query_queue(self, batches, return_coverage: bool = False):
        """EXACT answers for several query batches, binned on the device
        (``_bin``): the queue's raw (m, 3) rows go up in one copy, each row
        gets its supercell and slot and each batch its largest supercell,
        whose maxima come down (the one wait before the answers), and the
        host cuts the tables into parts (``queue_parts``); per part
        ``place_queue`` fills one dense table and ``cell_scan`` runs once
        per batch on it (``_scan_parts``). On a CUDA device the card then
        answers the whole queue (``_answer_on_device``): ``cell_answer``
        per part, one small download of the certified counts, one exact
        fused scan for every uncertified row of the queue, one download of
        the answers. On a CPU device one gather takes each row's signed
        winner and the host answers each batch (``_answer_queue``). A batch
        too skewed for the dense kernel is re-answered whole by the exact
        scan. With ``return_coverage``, also returns the per-batch
        certified fraction. An empty queue returns [] (the JAX package
        raises ValueError there), as the v4 and v9 engines do."""
        if not batches:
            return ([], []) if return_coverage else []
        queries = [np.ascontiguousarray(qb, dtype=np.float32) for qb in batches]
        for q in queries:
            if q.ndim != 2 or q.shape[1] != 3:
                raise ValueError(f"queries must be (m, 3); got {q.shape}")
        binned = self._bin(queries)
        if binned.rows.device.type == "cuda":
            results, covs = self._answer_on_device(queries, binned)
            return (results, covs) if return_coverage else results
        return self._answer_queue(queries, self._signed_rows(binned), [None] * len(queries),
                                  return_coverage)

    def _bin(self, queries: list[np.ndarray]) -> BinnedQueue:
        """Upload a queue's rows and bin them on the device: one upload
        (``_upload_queue``), ``bin_queue``, one download of the per-batch
        maxima and the count of non-finite rows, which raises ValueError
        when above 0 (the drain's only finiteness check, before any table
        is placed); each batch's q_max as ``stage`` picks it, and the parts
        of the tables (``queue_parts``, at most ``_QUEUE_SLOTS`` slots
        each)."""
        sizes = np.array([len(q) for q in queries], dtype=np.int64)
        with span("nns.cells.bin"):
            rows, offs = _upload_queue(queries, self.device)
            sid, pos, _, maxima = bin_queue(rows, offs, int(sizes.max()), self.D, self.mn,
                                            self.W)
            raw = maxima.cpu().numpy()
            count_copy("down", raw.nbytes, self.device)
        COUNTS["cells.device_checked_rows"] += int(sizes.sum())
        if raw[-1]:
            raise non_finite_error("queries")
        raw = raw[:-1]
        q_max = np.array([_pow2_at_least(max(int(r), 8)) for r in raw], dtype=np.int64)
        skewed = q_max > self.q_max_limit()
        plan, parts = queue_parts(np.where(skewed | (sizes == 0), 0, q_max), self.D ** 3,
                                  _QUEUE_SLOTS)
        COUNTS["cells.device_staged_rows"] += int(sizes[~skewed].sum())
        ends = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=ends[1:])
        return BinnedQueue(rows, offs, sid, pos, plan, parts, ends, skewed)

    def _scan_parts(self, binned: BinnedQueue, answer) -> None:
        """Per part of a binned queue's tables: ``place_queue`` into one
        table, ``cell_scan`` per batch on it (``_scan_table``), then
        ``answer(a, b, plan, win, slot)`` over the part's batches a to
        b - 1 (their plan on the device, the part's signed winner per slot,
        each row's slot), all queued on the current stream. A queue with
        no table is one part with no table and no scan."""
        rows, plan = binned.rows, binned.plan
        max_rows = int(np.diff(binned.ends).max())
        plan_dev = _to_device(torch.from_numpy(plan), rows.device)
        slot = torch.empty(len(rows), dtype=torch.int64, device=rows.device)
        for a, b, slots in binned.parts or [(0, len(plan), 0)]:
            if slots:
                table = place_queue(rows, binned.offs[a:b + 1], max_rows, binned.sid,
                                    binned.pos, plan_dev[a:b], slots, slot)
                win = _scan_table(table, plan[a:b], self.D ** 3, self.halo_dm,
                                  self.halo_ids_dev, self.halo2)
            else:
                win = torch.zeros(1, dtype=torch.int32, device=rows.device)
            answer(a, b, plan_dev[a:b], win, slot)

    def _signed_rows(self, binned: BinnedQueue) -> list[np.ndarray | None]:
        """Each batch's signed winners in the caller's order (None for a
        batch too skewed for the scan): one gather per part and one
        download of the queue's winners, for the host tail."""
        ends, flat = binned.ends, np.zeros(0, dtype=np.int32)
        if binned.parts:
            with span("nns.cells.device"):
                signed = torch.empty(len(binned.rows), dtype=torch.int32,
                                     device=binned.rows.device)

                def gather(a, b, plan, win, slot):
                    lo, hi = int(ends[a]), int(ends[b])
                    torch.index_select(win, 0, slot[lo:hi], out=signed[lo:hi])

                self._scan_parts(binned, gather)
            with span("nns.cells.download"):
                flat = signed.cpu().numpy()
            count_copy("down", flat.nbytes, self.device)
        return [None if skew else flat[lo:hi]
                for skew, lo, hi in zip(binned.skewed, ends[:-1], ends[1:])]

    def _answer_on_device(self, queries, binned: BinnedQueue):
        """The CUDA drain's answers, on the device: ``cell_answer`` per part
        decodes every row, masks the sentinel corner, counts each batch's
        certified rows and lists the uncertified ones (every row of a batch
        with no table); one download of the counts and the list's length;
        one ``FusedBruteForce.fallback`` over the listed rows, gathered from
        the uploaded rows, its answers scattered into place; one download
        of the answers (``_to_host``). Returns (answers: int32 views of that
        one download, per-batch coverage) as ``_answer_queue`` does. On a
        CPU device it runs the plain twins (the tests' specification of
        this path)."""
        rows, ends, batches = binned.rows, binned.ends, len(queries)
        max_rows, lim = int(np.diff(ends).max()), (2.0 * self.halo) ** 2
        with span("nns.cells.device"):
            idx = torch.empty(len(rows), dtype=torch.int32, device=rows.device)
            bad = torch.empty(len(rows), dtype=torch.int32, device=rows.device)
            # Each batch's certified rows, then the length of the list.
            counts = torch.zeros(batches + 1, dtype=torch.int32, device=rows.device)
            self._scan_parts(binned, lambda a, b, plan, win, slot: cell_answer(
                rows, binned.offs[a:b + 1], max_rows, plan, win, slot, lim, idx, counts[a:b],
                bad, counts[batches:]))
        with span("nns.cells.download"):
            certified = counts.cpu().numpy()
        count_copy("down", certified.nbytes, self.device)
        listed = int(certified[batches])
        if listed:
            with span("nns.cells.exact_rows"):
                at = bad[:listed].long()
                idx.index_copy_(0, at, self._fallback_engine().fallback(rows.index_select(0, at)))
            COUNTS["cells.exact_calls"] += 1
        with span("nns.cells.download"):
            flat = _to_host(idx)
        count_copy("down", flat.nbytes, self.device)
        COUNTS["cells.device_answered_rows"] += len(flat)
        results = [flat[lo:hi] for lo, hi in zip(ends[:-1], ends[1:])]
        covs = [self._coverage(int(hi - lo), int(c))
                for lo, hi, c in zip(ends[:-1], ends[1:], certified[:batches])]
        return results, covs

    def _answer_queue(self, queries, signed, orders, return_coverage: bool):
        """The host tail of a queue drain, per batch: its signed winners
        ``signed[b]`` decoded (``_unstage``; in the host sort's order when
        ``orders[b]`` is given, else in the caller's), the sentinel mask,
        and every uncertified row re-answered with the exact fused scan. A
        batch whose ``signed[b]`` is None, too skewed for the scan, is
        re-answered whole. With ``return_coverage``, also the per-batch
        certified fraction. The sharded drain and the drain on a CPU device
        answer here; the drain on a CUDA device answers on the card
        (``_answer_on_device``)."""
        results, covs = [], []
        for q, sg, order in zip(queries, signed, orders):
            if sg is None:
                idx, ok = np.zeros(len(q), dtype=np.int32), np.zeros(len(q), dtype=bool)
            else:
                with span("nns.cells.unstage"):
                    idx, ok = self._unstage(sg, order, self._sentinel_risk(q))
            covs.append(self._coverage(len(ok), int(np.count_nonzero(ok))))
            results.append(self._exact_rows(q, idx, ok))
        return (results, covs) if return_coverage else results

    def query_submit(self, queries: np.ndarray) -> CellToken:
        """Asynchronous half of one batch: host staging, then
        ``query_staged`` (one upload, the scatter, scan and gather on the
        current stream), with no download. Several tokens may be in flight;
        ``query_collect`` or ``query_collect_dist`` downloads one."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        packed, order, q_max = self.stage(q)
        if packed is None:
            # Too skewed for the scan: collect gives every row uncertified.
            return CellToken(None, order, None, q)
        with span("nns.cells.device"):
            signed, d2 = self.query_staged(packed, q_max)
            winners = signed[None] if d2 is None else torch.stack([signed, d2.view(torch.int32)])
        with span("nns.cells.unstage"):
            risk = self._sentinel_risk(q)
        return CellToken(winners, order, risk, q)

    def _collect_d2(self, rows: np.ndarray, order: np.ndarray, idx: np.ndarray,
                    token: CellToken) -> np.ndarray:
        """best_d2 in the caller's order: the scan's f32 min."""
        d2 = np.empty(len(order), dtype=np.float32)
        d2[order] = rows[1].view(np.float32)
        return d2

    def query_collect_dist(self, token: CellToken):
        """(idx, certified, best_d2) of a submitted batch in the caller's
        order, from one (2, m) download. best_d2 is the scan's f32 min over
        the halo candidates: it tracks the true NN distance only to f32
        rounding (~1 ulp can land below the f64 truth), and is the distance
        to a sentinel slot when the halo set was empty. A batch too skewed
        for the kernel comes back all uncertified (best_d2 inf)."""
        m = len(token.order)
        if token.winners is None:
            return (np.zeros(m, dtype=np.int32), np.zeros(m, dtype=bool),
                    np.full(m, np.inf, dtype=np.float32))
        with span("nns.cells.download"):
            rows = token.winners.cpu().numpy()
        count_copy("down", rows.nbytes, self.device)
        with span("nns.cells.unstage"):
            idx, ok = self._unstage(rows[0], token.order, token.risk)
            return idx, ok, self._collect_d2(rows, token.order, idx, token)

    def query_collect(self, token: CellToken):
        idx, ok, _ = self.query_collect_dist(token)
        return idx, ok

    def query_with_flags_dist(self, queries: np.ndarray):
        """(idx, certified, best_d2) for one batch in the caller's order (see
        ``query_collect_dist``)."""
        return self.query_collect_dist(self.query_submit(queries))

    def query_with_flags(self, queries: np.ndarray):
        return self.query_collect(self.query_submit(queries))

    def query_with_coverage(self, queries: np.ndarray) -> tuple[np.ndarray, float]:
        """Exact answers plus the fraction certified by the index (callers
        can adapt engine choice when coverage is persistently poor)."""
        idx, ok = self.query_with_flags(queries)
        idx = self._exact_rows(queries, idx, ok)
        return idx, self._coverage(len(ok), int(np.count_nonzero(ok)))

    def query(self, queries: np.ndarray) -> np.ndarray:
        return self.query_with_coverage(queries)[0]

    def query_topk(self, queries: np.ndarray, k_nn: int = 8):
        """Exact k-NN through the supercell index: (dist2[m, k], idx[m, k])
        numpy, ascending. Queries whose k-th neighbour the certificate
        cannot prove (k-th dist > halo, fewer than k candidates, or near the
        sentinel corner) take the exact chunked top-k scan, and so does a
        batch too skewed for the dense staging."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = q.shape[0]
        k_nn = min(k_nn, self.n)  # nns_topk clamps the same way
        packed, order, q_max = self.stage(q)
        if packed is None:
            return nns_topk(q, self.refs, k_nn, device=self.device)
        d2, idx, ok = self._topk_staged(packed, k_nn)
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        d2, idx, ok = d2[inv], idx[inv], ok[inv]
        risk = self._sentinel_risk(q)
        if risk is not None:
            ok &= ~risk
        if not ok.all():
            bad = np.flatnonzero(~ok)
            d2[bad], idx[bad] = nns_topk(q[bad], self.refs, k_nn, device=self.device)
        return d2, idx

    def _topk_staged(self, packed: np.ndarray, k_nn: int):
        """``_device_query_topk`` of the staged rows -> numpy (d2, ids,
        certified) in staged order."""
        staged = torch.as_tensor(packed, device=self.device)
        return tuple(t.cpu().numpy() for t in _device_query_topk(
            staged[:, :3], staged[:, 3].long(), self.halo_dm, self.halo_ids_dev, self.halo2,
            k_nn))

    # -- persistence (the JAX package's npz keys) --------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            refs=self.refs,
            halo_pts=np.swapaxes(self._host_halo_dm(), 1, 2),
            halo_ids=self.halo_ids,
            meta=np.array([self.D, self.R_max], dtype=np.int64),
            geo=np.concatenate([self.mn, self.W, [self.halo]]).astype(np.float64),
        )

    def _host_halo_dm(self) -> np.ndarray:
        """The (G, 3, R_max) halo points on the host."""
        return self.halo_dm.cpu().numpy()

    @classmethod
    def load(cls, path: str, device="cuda") -> "CellListEngine":
        eng = cls.__new__(cls)
        eng._restore(path, device)
        return eng

    def _restore(self, path: str, device) -> None:
        """The index of a file that ``save`` (of either package) wrote,
        placed by ``_place``."""
        with np.load(path) as z:
            self.refs = z["refs"]
            self.n = self.refs.shape[0]
            self.D, self.R_max = (int(v) for v in z["meta"])
            geo = z["geo"]
            self.mn, self.W, self.halo = geo[0:3], geo[3:6], float(geo[6])
            halo_pts = z["halo_pts"]
            self.avg_candidates = float((halo_pts[..., 0] < PAD_SENTINEL).sum() / self.D ** 3)
            self._place(np.ascontiguousarray(np.swapaxes(halo_pts, 1, 2)), z["halo_ids"], device)


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
