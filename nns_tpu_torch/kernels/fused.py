"""v4 fused distance + argmin — the exact brute force and every engine's
exact fallback. Counterpart of ``nns_tpu/kernels/pallas_fused.py:44-224``
(the v4 analog; the v3, v5, v6 and v7 rungs are in ``fused_ladder.py`` and
share ``run_kernel`` and the plain version here).

``fused_min_idx`` dispatches on the device of the tensors it is given: CPU
tensors go to ``fused_min_idx_plain`` (plain PyTorch, same arithmetic
order), CUDA tensors launch ``csrc/fused_argmin.cu`` or raise. Tie-break:
the lowest reference index, in both.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from nns_tpu_torch.kernels import _cuda, layouts

_LANE = 128
# Stage columns of the CUDA kernel at most: one tensor-map box, which holds
# at most 256 elements along each dimension.
_TMA_BOX_COLS = 256
# Bound on the plain version's (chunk, n) f32 distance block: 64M elements
# (256 MB), so 10K x 1M fits on the card and small hosts alike.
_PLAIN_BLOCK = 1 << 26


def as_f32(x, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def prepare_refs(refs, tile_n: int = 2048, device="cuda"):
    """One-time reference staging for the prepare-once/query-many path:
    replica-pad n to a tile multiple and transpose to dim-major (k, n_pad)
    on ``device``. Returns (r_dm, tn)."""
    r = as_f32(refs, device)
    n = r.shape[0]
    tn = min(tile_n, layouts.round_up(n, _LANE))
    return layouts.to_dim_major(layouts.pad_refs(r, tn)), tn


def fused_min_idx_plain(queries: torch.Tensor, r_dm: torch.Tensor,
                        n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch v4: (min_d2 (m,) f32, idx (m,) i32) of each query over
    columns [0, n) of the dim-major refs. d2 accumulates as
    ``d2 = 0; d2 = d2 + diff * diff`` per dimension in ascending order, and
    the index is a masked min over the column ids (the lowest index among
    the exact minima) — the CUDA kernel's arithmetic, term for term."""
    m, k = queries.shape
    n = r_dm.shape[1] if n is None else n
    r = r_dm[:, :n]
    ids = torch.arange(n, dtype=torch.int32, device=r.device)
    out_d = torch.empty(m, dtype=torch.float32, device=r.device)
    out_i = torch.empty(m, dtype=torch.int32, device=r.device)
    chunk = max(1, _PLAIN_BLOCK // max(n, 1))
    for lo in range(0, m, chunk):
        q = queries[lo:lo + chunk]
        d2 = torch.zeros((q.shape[0], n), dtype=torch.float32, device=r.device)
        for d in range(k):
            diff = q[:, d:d + 1] - r[d:d + 1, :]
            d2 = d2 + diff * diff
        mn = d2.amin(dim=1)
        masked = torch.where(d2 == mn[:, None], ids, torch.iinfo(torch.int32).max)
        out_d[lo:lo + chunk] = mn
        out_i[lo:lo + chunk] = masked.amin(dim=1)
    return out_d, out_i


def fused_plan(m: int, k: int, smem_optin: int):
    """How csrc/fused_argmin.cu runs m k-dimensional queries on a card whose
    blocks get ``smem_optin`` bytes of shared memory: v5's ring plan
    (``fused_ladder.ring_plan("dim_major", ...)``: rows per thread, threads
    per row, dims per stage, stages) with stages of at most _TMA_BOX_COLS
    columns, one tensor-map box each, and the ring's mbarriers padded to 128
    bytes so that every stage starts 128-byte aligned for the tensor copies.
    Its shared memory does not grow with k past 16. Raises ValueError when
    nothing fits ``smem_optin``."""
    from nns_tpu_torch.kernels import fused_ladder  # it imports this module

    plan = fused_ladder.ring_plan("dim_major", m, k, smem_optin)
    cols = min(plan.cols, _TMA_BOX_COLS)
    smem = (-16 * plan.stages % 128
            + fused_ladder.ring_smem_bytes("dim_major", k, cols, plan.dims, plan.stages))
    if smem > smem_optin:
        raise ValueError(f"fused_argmin: k={k} leaves no plan within {smem_optin} bytes of "
                         "shared memory")
    return dataclasses.replace(plan, cols=cols, smem_bytes=smem)


@functools.lru_cache(maxsize=4096)
def fused_launch_shape(m: int, k: int, n: int, device_index: int):
    """(plan, ref ranges S) of the CUDA kernel for m k-dimensional queries
    over n columns on CUDA device ``device_index``: ``fused_plan``, and as
    many ranges as fill the plan's grid slots in one wave beside the query
    tiles (``fused_ladder.ring_splits``). Cached, so that a call asks the
    card nothing."""
    from nns_tpu_torch.kernels import fused_ladder

    plan = fused_plan(m, k, fused_ladder._smem_optin(device_index))
    slots = fused_ladder._ring_setup("fused_argmin", k, plan, device_index)
    return plan, fused_ladder.ring_splits(plan, m, n, slots)


def n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=256)
def _tensor_map(ptr: int, k: int, n: int, ld: int, cols: int, dims: int):
    """The kernel's tensor map (128 bytes) of the dim-major refs (k, ld) at
    device address ``ptr`` over columns [0, n), in boxes of ``cols`` x
    ``dims``. It holds only these numbers, so a later tensor at the same
    address and shape may share it. Raises RuntimeError where
    cuTensorMapEncodeTiled refuses the map."""
    lib = _cuda.library()
    buf = ctypes.create_string_buffer(128)
    _cuda.check(lib, lib.nns_fused_argmin_tensor_map(ptr, k, n, ld, cols, dims, buf),
                "fused_argmin tensor map")
    return buf


# The kernel's fold state per (device index, stream): 64-bit keys, all ones,
# and per-query-tile tickets, zero. Each launch leaves them as it found them,
# so launches on one stream share them; another stream gets its own.
_FOLD_STATE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _fold_state(dev, stream, m: int, tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream.cuda_stream)
    state = _FOLD_STATE.get(key)
    if state is not None:
        m, tiles = max(m, state[0].numel()), max(tiles, state[1].numel())
    if state is None or (state[0].numel(), state[1].numel()) != (m, tiles):
        state = (torch.full((layouts.pow2_at_least(m),), -1, dtype=torch.int64, device=dev),
                 torch.zeros(layouts.pow2_at_least(tiles), dtype=torch.int32, device=dev))
        _FOLD_STATE[key] = state
    return state


def _fused_min_idx_cuda(queries, r_dm, n):
    """Launch csrc/fused_argmin.cu on the current stream: one kernel, which
    folds its ref ranges' winners itself. The refs go in by tensor copies
    where their base and pitch are 16-byte aligned, else by the producer's
    plain loads. Raises RuntimeError on a CUDA error, else counts the
    launch. Returns (min_d2, idx), two rows of one allocation."""
    m, k = queries.shape
    dev = queries.device
    plan, splits = fused_launch_shape(m, k, n, dev.index)
    ld, ptr = r_dm.shape[1], r_dm.data_ptr()
    tmap = (_tensor_map(ptr, k, n, ld, plan.cols, plan.dims)
            if ld % 4 == 0 and ptr % 16 == 0 else None)
    stream = torch.cuda.current_stream(dev)
    keys = tickets = None
    if splits > 1:
        keys, tickets = (t.data_ptr() for t in _fold_state(dev, stream, m, plan.q_tiles(m)))
    out = torch.empty((2, m), dtype=torch.int32, device=dev)
    out_d, out_i = out[0].view(torch.float32), out[1]
    lib = _cuda.library()
    rc = lib.nns_fused_argmin(
        queries.data_ptr(), ptr, tmap, m, k, n, ld, splits, plan.q_rows, plan.threads_per_row,
        plan.cols, plan.dims, plan.stages, keys, tickets, out_d.data_ptr(), out_i.data_ptr(),
        dev.index, stream.cuda_stream)
    _cuda.check(lib, rc, "fused_argmin")
    _cuda.LAUNCHES["fused_argmin"] += 1
    return out_d, out_i


def partials(rows: int, cols: int | None, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Uninitialised (d2 f32, idx i32) winner tensors of shape (rows, cols),
    or (rows,) when cols is None, for a kernel to fill."""
    shape = (rows,) if cols is None else (rows, cols)
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def run_kernel(name: str, plain, launch, queries: torch.Tensor, refs: torch.Tensor,
               n: int | None = None, *, point_major: bool = False, **kw):
    """The shared front of the fused kernels' wrappers. Checks shapes, dtype
    and device of the (m, k) queries against the refs, dim-major (k, cols)
    or, with ``point_major``, (cols, k); ``n`` (default: all columns) is how
    many columns are real. CPU tensors go to ``plain(queries, refs, n,
    **kw)``; CUDA tensors to ``launch`` with the same arguments made
    contiguous, which launches the kernel (or raises RuntimeError) and
    counts it; any other device raises."""
    if queries.dim() != 2 or refs.dim() != 2:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, refs {tuple(refs.shape)}")
    k_r, cols = (refs.shape[1], refs.shape[0]) if point_major else refs.shape
    n = cols if n is None else n
    if queries.shape[1] != k_r:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, refs {tuple(refs.shape)}")
    if not 0 < n <= cols:
        raise ValueError(f"n={n} outside (0, {cols}]")
    if queries.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors")
    if queries.device != refs.device:
        raise ValueError(f"queries on {queries.device}, refs on {refs.device}")
    if queries.device.type == "cpu":
        return plain(queries, refs, n, **kw)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if queries.shape[0] == 0:
        return partials(0, None, queries.device)
    return launch(queries.contiguous(), refs.contiguous(), n, **kw)


def fused_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                  n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(min_d2 (m,) f32, idx (m,) i32): exact 1-NN of each (m, k) query over
    columns [0, n) of dim-major refs (k, n_pad) (default: all columns).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise RuntimeError if it cannot be built or launched)."""
    return run_kernel("fused_min_idx", fused_min_idx_plain, _fused_min_idx_cuda,
                      queries, r_dm, n)


def nns_fused(queries, refs, tile_n: int = 4096, device="cuda") -> torch.Tensor:
    """v4 one-shot: exact 1-NN indices (m,) i32 on ``device``."""
    return FusedBruteForce(refs, tile_n, device).query(queries)


def fused_fallback(queries, refs, device="cuda") -> torch.Tensor:
    """Exact full-scan fallback for certificate failures, one-shot:
    ``FusedBruteForce.fallback`` over refs staged for this call. ``refs``
    may already be a tensor on ``device`` (no host transfer then). An engine
    that falls back again and again keeps a FusedBruteForce instead."""
    return FusedBruteForce(refs, device=device).fallback(queries)


class FusedBruteForce:
    """Prepare-once / query-many engine over the fused kernel: the reference
    set is staged (padded, dim-major, on the device) a single time; each
    query batch runs only the kernel."""

    def __init__(self, refs, tile_n: int = 4096, device="cuda"):
        self.n = refs.shape[0]
        self.device = torch.device(device)
        self.r_dm, self.tile_n = prepare_refs(refs, tile_n, self.device)

    def query_min_idx(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        return fused_min_idx(as_f32(queries, self.device), self.r_dm, self.n)

    def query(self, queries) -> torch.Tensor:
        return self.query_min_idx(queries)[1]

    def fallback(self, queries) -> torch.Tensor:
        """Exact indices (m,) i32 of the rows of ``queries``, run at the
        query count padded to a power-of-two bucket (>= 8), the shapes the
        JAX package compiles for, and the tail sliced off."""
        q = as_f32(queries, self.device)
        m = q.shape[0]
        return self.query(layouts.pad_queries(q, layouts.pow2_at_least(max(m, 8))))[:m]
