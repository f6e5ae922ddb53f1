"""The v3, v5, v6 and v7 rungs of the fused brute-force ladder. Counterpart
of ``nns_tpu/kernels/pallas_fused.py:226-505``.

Each rung keeps the memory idea it stands for in the reference ladder, in a
CUDA kernel of its own under ``csrc/``:

- v3 ``fused_point_major``: refs kept point-major (n, k), unpadded, stages
  of whole points (one contiguous span each) through a producer/consumer
  ring of bulk copies, each point read by a warp as a broadcast;
- v5 ``fused_streaming``: dim-major ref tiles (in slices of at most 16 dims
  where k is not a template parameter) streamed through the same ring, one
  bulk copy per dimension row;
- v6 ``fused_queries_resident``: the query set resident on chip (each
  thread's rows in registers), a grid over ref ranges only, ref tiles (in
  slices of at most 16 dims where k is not a template parameter) through a
  bulk-copy ring, and the v4 fallback above the JAX package's 4 MB query
  budget;
- v7 ``two_level``: v5's ring, walked in segments cut at ``tile_n``
  boundaries, writes one winner per (table tile, row) to an (n_tiles, m)
  table, then a second reduce over the tiles.

Each ``*_min_idx`` wrapper returns (min_d2 (m,) f32, idx (m,) i32) and
dispatches on its tensors' device through ``fused.run_kernel``: CPU tensors
take the ``*_plain`` twin, CUDA tensors launch the kernel (or raise
RuntimeError) and add one to ``_cuda.LAUNCHES[<rung>]``. Every plain twin
accumulates ``d2 = d2 + diff * diff`` per dimension in ascending order and
keeps the lowest index among the exact minima, as the kernels do, so on the
card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from nns_tpu_torch.kernels import _cuda, layouts
from nns_tpu_torch.kernels.fused import (
    as_f32,
    fused_min_idx_plain,
    nns_fused,
    partials,
    prepare_refs,
    run_kernel,
)

# CUDA grids allow at most 65535 blocks along y (the ring kernels' ref ranges).
_MAX_GRID_Y = 65535


# ---------------------------------------------------------------------------
# v3 and v5: a producer/consumer ring of ref stages, query rows in registers
# ---------------------------------------------------------------------------


# The k that csrc/fused_streaming.cu and csrc/fused_point_major.cu take as a
# template parameter (4 or 1 query rows in each consumer thread's registers);
# every other k runs a sliced instance. A block has RING_CONSUMERS consumer
# threads and one producer warp.
RING_TEMPLATE_KS = (3, 16)
RING_ROWS_PER_THREAD = 4
RING_CONSUMERS = 256
RING_LAYOUTS = ("dim_major", "point_major")
_RING_STAGES = 4
_RING_MAX_DIMS = 16  # v5 sliced: dims per stage
_RING_GROUPS = 8     # v5 sliced: four-column groups carried across slices
# Stage columns (v5) or points (v3) at a template k, and the sliced v5's
# one-slice stage width; v3's sliced stages shrink as k grows.
_RING_COLS = {("dim_major", 3): 512, ("dim_major", 16): 256,
              ("point_major", 3): 1024, ("point_major", 16): 256}
_RING_SLICED_COLS = 256
_RING_PM_POINTS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
# v3 sliced: points per stage while their coordinates fit 16 KiB, so that
# two blocks of 4 stages share an SM; past k = 4096 one point, 4 stages or 2.
_RING_PM_STAGE_BYTES = 16384
# v3 sliced: 4 rows per thread (8-dim query chunks) up to this k, else 1.
_RING_PM_ROWS4_MAX_K = 8
# Threads sharing a query row below one tile of rows: 1 to 32, so a tile
# holds 256 down to 8 rows.
_RING_MAX_TPR = 32
_RING_KEYS = {"dim_major": "fused_streaming", "point_major": "fused_point_major"}


@dataclass(frozen=True)
class RingPlan:
    """How the v3 or v5 kernel runs m k-dimensional queries: each of the
    RING_CONSUMERS consumer threads holds ``q_rows`` query rows, which
    ``threads_per_row`` threads share (each its own columns), a stage of the
    ring holds ``dims`` of the k dimensions of ``cols`` ref columns (v5,
    dim-major) or ``cols`` whole points (v3, point-major: ``dims`` == k), the
    ring has ``stages`` stages, and a block takes ``smem_bytes`` of dynamic
    shared memory. With stride = RING_CONSUMERS // threads_per_row, query
    tile x holds rows x * rows_per_tile + q * stride + t % stride for q <
    q_rows and consumer thread t, which takes part t // stride of the
    columns."""

    q_rows: int
    threads_per_row: int
    cols: int
    dims: int
    stages: int
    smem_bytes: int

    @property
    def rows_per_tile(self) -> int:
        return RING_CONSUMERS * self.q_rows // self.threads_per_row

    def q_tiles(self, m: int) -> int:
        return -(-m // self.rows_per_tile)


def ring_smem_bytes(layout: str, k: int, cols: int, dims: int, stages: int) -> int:
    """The kernel's dynamic shared memory: 16 bytes of mbarriers per stage,
    then the stages, (dims, cols) floats dim-major or, point-major, cols * k
    floats and room for 0-3 floats of alignment in front, rounded up to 4."""
    stage = dims * cols if layout == "dim_major" else layouts.round_up(cols * k + 3, 4)
    return 16 * stages + 4 * stages * stage


def ring_plan(layout: str, m: int, k: int, smem_optin: int) -> RingPlan:
    """The v5 (``layout`` "dim_major") or v3 ("point_major") plan for m
    k-dimensional queries on a card whose blocks get ``smem_optin`` bytes of
    shared memory. At a template k, and for v3 up to k = 8: 4 rows per
    thread unless 1 leaves fewer idle rows; else one. Fewer than 256 rows
    fill one tile of the fewest rows (a power of two, at least 8) that holds
    them, the threads sharing each row. At any other k, v5 slices the
    contraction into the fewest slices of at most 16 dims, as equal as they
    come, with tiles of 32 columns per thread of a row (at most 256) when
    there are several, so its shared memory does not grow with k; v3 keeps
    whole points in a stage, the most (at most 256) whose coordinates fit
    16 KiB, else one, in 4 stages or else 2. Raises ValueError when nothing
    fits ``smem_optin``."""
    if layout not in RING_LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {RING_LAYOUTS}")
    four = k in RING_TEMPLATE_KS or (layout == "point_major" and k <= _RING_PM_ROWS4_MAX_K)
    q_rows, tpr = _ring_rows(m, four)
    if k in RING_TEMPLATE_KS:
        shapes = [(_RING_COLS[layout, k], k, _RING_STAGES)]
    elif layout == "dim_major":
        slices = -(-k // _RING_MAX_DIMS)
        cols = (_RING_SLICED_COLS if slices == 1
                else min(_RING_SLICED_COLS, 4 * _RING_GROUPS * tpr))
        shapes = [(cols, -(-k // slices), _RING_STAGES)]
    else:
        points = next((t for t in _RING_PM_POINTS if 4 * t * k <= _RING_PM_STAGE_BYTES), 1)
        shapes = [(points, k, stages) for stages in (_RING_STAGES, 2)]
    fits = [(cols, dims, stages, ring_smem_bytes(layout, k, cols, dims, stages))
            for cols, dims, stages in shapes]
    fits = [f for f in fits if f[3] <= smem_optin]
    if not fits:
        raise ValueError(f"{_RING_KEYS[layout]}: k={k} leaves no plan within {smem_optin} "
                         "bytes of shared memory")
    return RingPlan(q_rows, tpr, *fits[0])


def _ring_rows(m: int, four: bool) -> tuple[int, int]:
    """(rows per thread, threads per row) of a ring plan for m rows: 4 rows
    per thread where ``four`` and that scores no more rows (idle ones
    included), else 1; below one tile of rows, the fewest rows (a power of
    two, at least 8) that hold m, 2-32 threads sharing each."""
    q_rows = min((RING_ROWS_PER_THREAD, 1) if four else (1,),
                 key=lambda q: -(-m // (RING_CONSUMERS * q)) * RING_CONSUMERS * q)
    tpr = 1
    while q_rows == 1 and tpr < _RING_MAX_TPR and RING_CONSUMERS // (2 * tpr) >= m:
        tpr *= 2
    return q_rows, tpr


@functools.lru_cache(maxsize=None)
def _ring_setup(key: str, k: int, plan: RingPlan, device_index: int) -> int:
    """The plan's grid slots on the card. The C side refuses a plan it has
    no instance for, and its own shared-memory need must equal the plan's."""
    lib = _cuda.library()
    with torch.cuda.device(device_index):
        smem, slots = ctypes.c_longlong(), ctypes.c_int()
        rc = getattr(lib, f"nns_{key}_smem")(k, plan.q_rows, plan.threads_per_row, plan.cols,
                                              plan.dims, plan.stages, ctypes.byref(smem),
                                              ctypes.byref(slots))
    _cuda.check(lib, rc, key)
    if smem.value != plan.smem_bytes:
        raise RuntimeError(f"{key}: the kernel needs {smem.value} bytes of shared memory, "
                           f"the plan {plan.smem_bytes}")
    return slots.value


def ring_launch_shape(layout: str, m: int, k: int, device) -> tuple[RingPlan, int]:
    """(plan, grid slots) of the v5 or v3 kernel for m k-dimensional queries
    on CUDA ``device``."""
    index = _device_index(device)
    plan = ring_plan(layout, m, k, _smem_optin(index))
    return plan, _ring_setup(_RING_KEYS[layout], k, plan, index)


def ring_splits(plan: RingPlan, m: int, n: int, slots: int) -> int:
    """Ref ranges S: as many as fill the grid slots in one wave beside the
    query tiles, at most one per stage of columns."""
    return max(1, min(slots // plan.q_tiles(m), -(-n // plan.cols), _MAX_GRID_Y))


def _ring_cuda(layout, queries, refs, n):
    m, k = queries.shape
    dev = queries.device
    key = _RING_KEYS[layout]
    plan, slots = ring_launch_shape(layout, m, k, dev)
    splits = ring_splits(plan, m, n, slots)
    part_d, part_i = partials(splits, m, dev)
    out_d, out_i = partials(m, None, dev)
    pitch = (refs.shape[1],) if layout == "dim_major" else ()
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"nns_{key}")(
            queries.data_ptr(), refs.data_ptr(), m, k, n, *pitch, splits, plan.q_rows,
            plan.threads_per_row, plan.cols, plan.dims, plan.stages, part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, key)
    _cuda.LAUNCHES[key] += 1
    return out_d, out_i


def fused_point_major_plain(queries: torch.Tensor, r_pm: torch.Tensor,
                            n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch v3 over point-major refs (n, k): the v4 plain version on
    the dim-major view of the same memory."""
    return fused_min_idx_plain(queries, r_pm.t(), n)


def fused_point_major_min_idx(queries: torch.Tensor, r_pm: torch.Tensor,
                              n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each (m, k) query over rows [0, n) of the point-major
    refs (n_rows, k): csrc/fused_point_major.cu on CUDA tensors, one scan
    launch (as ``ring_plan`` says) and one merge."""
    return run_kernel("fused_point_major_min_idx", fused_point_major_plain,
                      functools.partial(_ring_cuda, "point_major"), queries, r_pm, n,
                      point_major=True)


def nns_fused_point_major(queries, refs, device="cuda") -> torch.Tensor:
    """v3 one-shot: exact 1-NN indices (m,) i32 on ``device``. The refs stay
    point-major and unpadded: the kernel stops at n."""
    r = as_f32(refs, device)
    return fused_point_major_min_idx(as_f32(queries, device), r)[1]


# Plain PyTorch v5: streaming changes where the refs wait, not the
# arithmetic, so its twin is the v4 plain version.
fused_streaming_plain = fused_min_idx_plain


def fused_streaming_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                            n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN over columns [0, n) of dim-major refs (k, ld):
    csrc/fused_streaming.cu on CUDA tensors, one scan launch (as
    ``ring_plan`` says) and one merge. A pitch that is not a multiple of 4
    floats, or a misaligned base, takes the kernel's plain-load path."""
    return run_kernel("fused_streaming_min_idx", fused_streaming_plain,
                      functools.partial(_ring_cuda, "dim_major"), queries, r_dm, n)


def nns_fused_streaming(queries, refs, tile_n: int = 4096, device="cuda") -> torch.Tensor:
    """v5 one-shot: exact 1-NN indices (m,) i32 on ``device``. The refs are
    replica-padded to a multiple of ``tile_n`` rounded up to 4 columns, so
    every dim-major row is 16-byte aligned for the bulk copies."""
    r_dm, _ = prepare_refs(refs, layouts.round_up(tile_n, 4), device)
    return fused_streaming_min_idx(as_f32(queries, device), r_dm, refs.shape[0])[1]


# ---------------------------------------------------------------------------
# v6: the query set resident on chip, a grid over ref ranges only
# ---------------------------------------------------------------------------


# Plain PyTorch v6: where the queries wait does not change the arithmetic,
# so its twin is the v4 plain version.
fused_queries_resident_plain = fused_min_idx_plain

# The k that csrc/fused_queries_resident.cu takes as a template parameter,
# with 4 or 1 query rows in each thread's registers and all k dims in each
# ring stage; every other k runs its sliced instance (one row per thread, at
# most _QRES_MAX_DIMS dims per stage, the rows' slice in shared memory and,
# with more than one slice, at most _QRES_GROUPS four-column groups per
# thread and tile). A row may be shared by 1-32 threads (each its own
# columns).
QRES_TEMPLATE_KS = (3, 16)
QRES_ROWS_PER_THREAD = 4
QRES_THREADS = 256
_QRES_STAGES = 2
_QRES_TILES = (256, 128, 64, 32, 16, 8, 4)  # ref columns per ring stage, preferred first
_QRES_TPR = (1, 2, 4, 8, 16, 32)
_QRES_MAX_DIMS = 16
_QRES_GROUPS = 8
# What a pass costs beyond its rows, counted in rows: its walk of the ref
# range and its barriers (a model constant of the plan, not a measurement).
_QRES_PASS_ROWS = 32


@dataclass(frozen=True)
class QresPlan:
    """How csrc/fused_queries_resident.cu runs m k-dimensional queries: each
    thread holds ``q_rows`` query rows, ``threads_per_row`` threads share
    one, a ring stage holds ``dims`` of the k dimensions of ``tile`` ref
    columns, and a block takes ``smem_bytes`` of dynamic shared memory. A
    block scores ``rows_per_pass`` rows per walk of its ref range; thread t
    holds rows pass * rows_per_pass + q * (256 // threads_per_row) + t //
    threads_per_row."""

    q_rows: int
    threads_per_row: int
    tile: int
    dims: int
    smem_bytes: int

    @property
    def rows_per_pass(self) -> int:
        return QRES_THREADS * self.q_rows // self.threads_per_row

    def passes(self, m: int) -> int:
        return -(-m // self.rows_per_pass)


def qres_smem_bytes(k: int, dims: int, tile: int, rows: int) -> int:
    """The kernel's dynamic shared memory: 16 bytes of barriers, the ring of
    (dims, tile) stages and, at a k that is not a template parameter, the
    pass's ``rows`` rows' slice as (dims, rows + 1)."""
    q_bytes = 0 if k in QRES_TEMPLATE_KS else 4 * dims * (rows + 1)
    return 16 + _QRES_STAGES * dims * tile * 4 + q_bytes


def qres_plan(m: int, k: int, smem_optin: int) -> QresPlan:
    """The plan for m k-dimensional queries on a card whose blocks get
    ``smem_optin`` bytes of shared memory: of the shapes that fit, the one
    with the least work, passes x (rows per pass + _QRES_PASS_ROWS), so that
    few rows leave few threads idle without many walks of the refs; then the
    fewest passes, then the widest tile. At a k that is not a template
    parameter the contraction goes in the fewest slices of at most 16 dims,
    as equal as they come, so every k fits; with more than one slice a tile
    is at most 32 columns per thread of a row. Raises ValueError when
    nothing fits ``smem_optin``."""
    slices = 1 if k in QRES_TEMPLATE_KS else -(-k // _QRES_MAX_DIMS)
    dims = -(-k // slices)
    shapes = [(1, tpr) for tpr in _QRES_TPR]
    if k in QRES_TEMPLATE_KS:
        shapes.insert(0, (QRES_ROWS_PER_THREAD, 1))
    best = None
    for q_rows, tpr in shapes:
        rows = QRES_THREADS * q_rows // tpr
        tiles = _QRES_TILES if slices == 1 else (min(_QRES_TILES[0], 4 * _QRES_GROUPS * tpr),)
        tile = next((t for t in tiles if qres_smem_bytes(k, dims, t, rows) <= smem_optin), None)
        if tile is None:
            continue
        plan = QresPlan(q_rows, tpr, tile, dims, qres_smem_bytes(k, dims, tile, rows))
        passes = plan.passes(m)
        key = (passes * (plan.rows_per_pass + _QRES_PASS_ROWS), passes, -tile)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"fused_queries_resident: k={k} leaves no plan within "
                         f"{smem_optin} bytes of shared memory")
    return best[1]


@functools.lru_cache(maxsize=None)
def _qres_setup(k: int, plan: QresPlan, device_index: int) -> int:
    """The plan's grid slots on the card. The C side refuses a plan it has
    no instance for, and its own shared-memory need must equal the plan's."""
    lib = _cuda.library()
    with torch.cuda.device(device_index):
        smem, slots = ctypes.c_longlong(), ctypes.c_int()
        rc = lib.nns_fused_queries_resident_smem(k, plan.q_rows, plan.threads_per_row, plan.tile,
                                                 plan.dims, ctypes.byref(smem),
                                                 ctypes.byref(slots))
    _cuda.check(lib, rc, "fused_queries_resident")
    if smem.value != plan.smem_bytes:
        raise RuntimeError(f"fused_queries_resident: the kernel needs {smem.value} bytes of "
                           f"shared memory, the plan {plan.smem_bytes}")
    return slots.value


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


@functools.lru_cache(maxsize=None)
def _smem_optin(device_index: int) -> int:
    with torch.cuda.device(device_index):
        return _cuda.smem_optin(_cuda.library())


def qres_launch_shape(m: int, k: int, device) -> tuple[QresPlan, int]:
    """(plan, grid slots) of m k-dimensional queries on CUDA ``device``."""
    index = _device_index(device)
    plan = qres_plan(m, k, _smem_optin(index))
    return plan, _qres_setup(k, plan, index)


def _fused_queries_resident_cuda(queries, r_dm, n):
    m, k = queries.shape
    dev = queries.device
    plan, slots = qres_launch_shape(m, k, dev)
    # Ref ranges of whole tiles only (no query axis), as many as fit at once.
    splits = max(1, min(slots, -(-n // plan.tile)))
    part_d, part_i = partials(splits, m, dev)
    out_d, out_i = partials(m, None, dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_fused_queries_resident(
            queries.data_ptr(), r_dm.data_ptr(), m, k, n, r_dm.shape[1], splits,
            plan.q_rows, plan.threads_per_row, plan.tile, plan.dims, part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "fused_queries_resident")
    _cuda.LAUNCHES["fused_queries_resident"] += 1
    return out_d, out_i


def fused_queries_resident_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                                   n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN over columns [0, n) of dim-major refs (k, ld):
    csrc/fused_queries_resident.cu on CUDA tensors, one scan launch (as
    ``qres_plan`` says) and one merge."""
    return run_kernel("fused_queries_resident_min_idx", fused_queries_resident_plain,
                      _fused_queries_resident_cuda, queries, r_dm, n)


def nns_fused_queries_resident(queries, refs, max_query_bytes: int = 4 << 20,
                               device="cuda") -> torch.Tensor:
    """v6 one-shot: exact 1-NN indices (m,) i32 on ``device``. A query set of
    more than ``max_query_bytes`` (m * k * 4) falls back to v4, as the JAX
    package does (reference: core.cu:546-550); below it, this kernel runs
    the whole query set in one launch."""
    m, k = queries.shape
    if m * max(k, 1) * 4 > max_query_bytes:
        return nns_fused(queries, refs, device=device)
    r_dm, _ = prepare_refs(refs, device=device)
    return fused_queries_resident_min_idx(as_f32(queries, device), r_dm, refs.shape[0])[1]


# ---------------------------------------------------------------------------
# v7: per-tile partial winners + second reduce
# ---------------------------------------------------------------------------


def _second_reduce(part_d: torch.Tensor, part_i: torch.Tensor):
    """Fold the (n_tiles, m) table over its tiles. torch.argmin returns the
    first minimum, so the lowest tile wins a tie, and the tile's own winner
    is already its lowest index: the global lowest-index rule."""
    win = torch.argmin(part_d, dim=0, keepdim=True)
    return part_d.gather(0, win)[0], part_i.gather(0, win)[0]


def two_level_table_plain(queries: torch.Tensor, r_dm: torch.Tensor, n: int,
                          tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (n_tiles, m) table of per-tile winners, tile t covering columns
    [t * tile_n, min(n, (t + 1) * tile_n))."""
    m = queries.shape[0]
    n_tiles = -(-n // tile_n)
    part_d, part_i = partials(n_tiles, m, queries.device)
    for t in range(n_tiles):
        lo = t * tile_n
        d, i = fused_min_idx_plain(queries, r_dm[:, lo:min(n, lo + tile_n)])
        part_d[t], part_i[t] = d, i + lo
    return part_d, part_i


def two_level_plain(queries: torch.Tensor, r_dm: torch.Tensor, n: int | None = None,
                    tile_n: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch v7: the per-tile table, then the second reduce."""
    n = r_dm.shape[1] if n is None else n
    return _second_reduce(*two_level_table_plain(queries, r_dm, n, tile_n))


# v7 at a k that is not a template one, up to this k: whole-k stages and 4
# rows per thread (csrc/two_level.cu kRunKMax), as at the template k.
TWO_LEVEL_ROWS4_MAX_K = 8


def two_level_plan(m: int, k: int, smem_optin: int) -> RingPlan:
    """The v7 plan for m k-dimensional queries on a card whose blocks get
    ``smem_optin`` bytes of shared memory: v5's dim-major ring stages
    (``ring_plan``'s "dim_major" plan: rows per thread, threads per row,
    stage columns, dims per stage, stages), which csrc/two_level.cu walks
    in segments cut at the table's tile boundaries; but up to k =
    TWO_LEVEL_ROWS4_MAX_K every k runs as the template k do, 4 rows per
    thread unless 1 leaves fewer idle rows, all k dims in a stage of 256
    columns. Its rows differ from v5's only where threads share them: the
    threads_per_row ADJACENT lanes t of a row hold row x * rows_per_tile +
    q * stride + t // threads_per_row and take part t % threads_per_row of
    the columns, so that they fold by shuffles at each boundary. Raises
    ValueError when nothing fits ``smem_optin``."""
    plan = ring_plan("dim_major", m, k, smem_optin)
    if k in RING_TEMPLATE_KS or k > TWO_LEVEL_ROWS4_MAX_K:
        return plan
    q_rows, tpr = _ring_rows(m, True)
    smem = ring_smem_bytes("dim_major", k, _RING_SLICED_COLS, k, _RING_STAGES)
    if smem > smem_optin:
        raise ValueError(f"two_level: k={k} leaves no plan within {smem_optin} bytes of "
                         "shared memory")
    return RingPlan(q_rows, tpr, _RING_SLICED_COLS, k, _RING_STAGES, smem)


def two_level_launch_shape(m: int, k: int, device) -> tuple[RingPlan, int]:
    """(plan, grid slots) of the v7 kernel for m k-dimensional queries on
    CUDA ``device``."""
    index = _device_index(device)
    plan = two_level_plan(m, k, _smem_optin(index))
    return plan, _ring_setup("two_level", k, plan, index)


def two_level_splits(plan: RingPlan, m: int, n_tiles: int, slots: int) -> int:
    """The most ref ranges of whole table tiles the kernel may cut
    ``n_tiles`` tiles into: as many as fill the grid slots in one wave
    beside the query tiles, at most one per tile. csrc/two_level.cu gives
    each range ceil(n_tiles / splits) tiles."""
    return max(1, min(slots // plan.q_tiles(m), n_tiles, _MAX_GRID_Y))


def _two_level_cuda(queries, r_dm, n, tile_n):
    m, k = queries.shape
    dev = queries.device
    n_tiles = -(-n // tile_n)
    plan, slots = two_level_launch_shape(m, k, dev)
    part_d, part_i = partials(n_tiles, m, dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_two_level(
            queries.data_ptr(), r_dm.data_ptr(), m, k, n, r_dm.shape[1], tile_n,
            two_level_splits(plan, m, n_tiles, slots), plan.q_rows, plan.threads_per_row,
            plan.cols, plan.dims, plan.stages, part_d.data_ptr(), part_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "two_level")
    _cuda.LAUNCHES["two_level"] += 1
    return _second_reduce(part_d, part_i)


def two_level_min_idx(queries: torch.Tensor, r_dm: torch.Tensor, n: int | None = None,
                      tile_n: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN over columns [0, n) of dim-major refs (k, ld), through an
    (n_tiles, m) table of ``tile_n``-column tiles: csrc/two_level.cu on CUDA
    tensors, the second reduce in torch ops."""
    if tile_n < 1:
        raise ValueError(f"tile_n={tile_n} must be positive")
    return run_kernel("two_level_min_idx", two_level_plain, _two_level_cuda,
                      queries, r_dm, n, tile_n=tile_n)


def nns_two_level(queries, refs, tile_n: int = 4096, device="cuda") -> torch.Tensor:
    """v7 one-shot: exact 1-NN indices (m,) i32 on ``device``."""
    r_dm, tn = prepare_refs(refs, tile_n, device)
    return two_level_min_idx(as_f32(queries, device), r_dm, refs.shape[0], tn)[1]
