"""The v3, v5, v6 and v7 rungs of the fused brute-force ladder. Counterpart
of ``nns_tpu/kernels/pallas_fused.py:226-505``.

Each rung keeps the memory idea it stands for in the reference ladder, in a
CUDA kernel of its own under ``csrc/``:

- v3 ``fused_point_major``: refs read point-major (n, k), uncoalesced;
- v5 ``fused_streaming``: ref tiles streamed through shared memory by
  double-buffered ``cp.async``;
- v6 ``fused_queries_resident``: the query set resident in ``__constant__``
  memory, a grid over ref ranges only, and the v4 fallback above the JAX
  package's 4 MB query budget;
- v7 ``two_level``: one partial winner per (query tile, ref tile) in an
  (n_tiles, m) table, then a second reduce over the tiles.

Each ``*_min_idx`` wrapper returns (min_d2 (m,) f32, idx (m,) i32) and
dispatches on its tensors' device through ``fused.run_kernel``: CPU tensors
take the ``*_plain`` twin, CUDA tensors launch the kernel (or raise
RuntimeError) and add one to ``_cuda.LAUNCHES[<rung>]``. Every plain twin
accumulates ``d2 = d2 + diff * diff`` per dimension in ascending order and
keeps the lowest index among the exact minima, as the kernels do, so on the
card the two agree bit for bit.
"""

from __future__ import annotations

import torch

from nns_tpu_torch.kernels import _cuda, layouts
from nns_tpu_torch.kernels.fused import (
    as_f32,
    fused_min_idx_plain,
    fused_splits,
    launch_split,
    n_sm,
    nns_fused,
    partials,
    prepare_refs,
    run_kernel,
)

# CUDA grids allow at most 65535 blocks along y (two_level's ref-tile axis).
_MAX_GRID_Y = 65535


# ---------------------------------------------------------------------------
# v3: point-major refs
# ---------------------------------------------------------------------------


def fused_point_major_plain(queries: torch.Tensor, r_pm: torch.Tensor,
                            n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch v3 over point-major refs (n, k): the v4 plain version on
    the dim-major view of the same memory."""
    return fused_min_idx_plain(queries, r_pm.t(), n)


def _fused_point_major_cuda(queries, r_pm, n):
    splits = fused_splits(queries.shape[0], n, n_sm(queries.device))
    return launch_split("fused_point_major", queries, r_pm, n, splits)


def fused_point_major_min_idx(queries: torch.Tensor, r_pm: torch.Tensor,
                              n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each (m, k) query over rows [0, n) of the point-major
    refs (n_rows, k): csrc/fused_point_major.cu on CUDA tensors."""
    return run_kernel("fused_point_major_min_idx", fused_point_major_plain,
                      _fused_point_major_cuda, queries, r_pm, n, point_major=True)


def nns_fused_point_major(queries, refs, device="cuda") -> torch.Tensor:
    """v3 one-shot: exact 1-NN indices (m,) i32 on ``device``. The refs stay
    point-major and unpadded: the kernel stops at n."""
    r = as_f32(refs, device)
    return fused_point_major_min_idx(as_f32(queries, device), r)[1]


# ---------------------------------------------------------------------------
# v5: ref tiles streamed through shared memory
# ---------------------------------------------------------------------------


# Plain PyTorch v5: streaming changes where the refs wait, not the
# arithmetic, so its twin is the v4 plain version.
fused_streaming_plain = fused_min_idx_plain


def _fused_streaming_cuda(queries, r_dm, n):
    if r_dm.shape[1] % 4 or r_dm.data_ptr() % 16:
        raise ValueError("fused_streaming needs dim-major refs with a row pitch of a "
                         "multiple of 4 floats on a 16-byte aligned base (16-byte cp.async)")
    splits = fused_splits(queries.shape[0], n, n_sm(queries.device))
    return launch_split("fused_streaming", queries, r_dm, n, splits, r_dm.shape[1])


def fused_streaming_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                            n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN over columns [0, n) of dim-major refs (k, ld):
    csrc/fused_streaming.cu on CUDA tensors, which needs ld % 4 == 0 (as
    ``prepare_refs`` pads) and raises ValueError otherwise."""
    return run_kernel("fused_streaming_min_idx", fused_streaming_plain,
                      _fused_streaming_cuda, queries, r_dm, n)


def nns_fused_streaming(queries, refs, tile_n: int = 4096, device="cuda") -> torch.Tensor:
    """v5 one-shot: exact 1-NN indices (m,) i32 on ``device``. The refs are
    replica-padded to a multiple of ``tile_n`` rounded up to 4 columns, so
    every 16-byte copy of a dim-major row is aligned."""
    r_dm, _ = prepare_refs(refs, layouts.round_up(tile_n, 4), device)
    return fused_streaming_min_idx(as_f32(queries, device), r_dm, refs.shape[0])[1]


# ---------------------------------------------------------------------------
# v6: whole query set resident in __constant__ memory
# ---------------------------------------------------------------------------


# Plain PyTorch v6: where the queries wait does not change the arithmetic,
# so its twin is the v4 plain version.
fused_queries_resident_plain = fused_min_idx_plain


def _fused_queries_resident_cuda(queries, r_dm, n):
    # Ref ranges only (no query axis): ~4 blocks per SM.
    splits = fused_splits(1, n, 2 * n_sm(queries.device))
    return launch_split("fused_queries_resident", queries, r_dm, n, splits, r_dm.shape[1])


def fused_queries_resident_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                                   n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN over columns [0, n) of dim-major refs (k, ld):
    csrc/fused_queries_resident.cu on CUDA tensors, one launch per 64 KB
    chunk of query rows. Launch it on one stream only (the constant bank is
    one per device)."""
    return run_kernel("fused_queries_resident_min_idx", fused_queries_resident_plain,
                      _fused_queries_resident_cuda, queries, r_dm, n)


def nns_fused_queries_resident(queries, refs, max_query_bytes: int = 4 << 20,
                               device="cuda") -> torch.Tensor:
    """v6 one-shot: exact 1-NN indices (m,) i32 on ``device``. A query set of
    more than ``max_query_bytes`` (m * k * 4) falls back to v4, as the JAX
    package does (reference: core.cu:546-550); below it, this kernel runs
    whatever its launches hold."""
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


def _two_level_cuda(queries, r_dm, n, tile_n):
    m, k = queries.shape
    dev = queries.device
    n_tiles = -(-n // tile_n)
    if n_tiles > _MAX_GRID_Y:
        raise ValueError(f"two_level: {n_tiles} ref tiles exceed the grid's {_MAX_GRID_Y}; "
                         "use a larger tile_n")
    part_d, part_i = partials(n_tiles, m, dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_two_level(
            queries.data_ptr(), r_dm.data_ptr(), m, k, n, r_dm.shape[1], tile_n,
            part_d.data_ptr(), part_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
