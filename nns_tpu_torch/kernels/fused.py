"""v4 fused distance + argmin — the exact brute force and every engine's
exact fallback. Counterpart of ``nns_tpu/kernels/pallas_fused.py:44-224``
(the v4 analog only).

``fused_min_idx`` dispatches on the device of the tensors it is given: CPU
tensors go to ``fused_min_idx_plain`` (plain PyTorch, same arithmetic
order), CUDA tensors launch ``csrc/fused_argmin.cu`` or raise. Tie-break:
the lowest reference index, in both.
"""

from __future__ import annotations

import numpy as np
import torch

from nns_tpu_torch.kernels import _cuda, layouts

_LANE = 128
# Queries per block of the CUDA kernel (kQT in csrc/fused_argmin.cu).
_KERNEL_QT = 16
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


def fused_splits(m: int, n: int, n_sm: int) -> int:
    """Ref ranges S of the CUDA kernel's grid: enough (query tile, range)
    blocks for ~2 per SM, and at least 1024 columns per range."""
    q_tiles = -(-m // _KERNEL_QT)
    return max(1, min(-(-2 * n_sm // q_tiles), -(-n // 1024)))


def _fused_min_idx_cuda(queries, r_dm, n):
    m, k = queries.shape
    dev = queries.device
    splits = fused_splits(m, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_d = torch.empty((splits, m), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, m), dtype=torch.int32, device=dev)
    out_d = torch.empty(m, dtype=torch.float32, device=dev)
    out_i = torch.empty(m, dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.nns_fused_argmin(
            queries.data_ptr(), r_dm.data_ptr(), m, k, n, r_dm.shape[1], splits,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(lib, rc, "fused_argmin")
    _cuda.LAUNCHES["fused_argmin"] += 1
    return out_d, out_i


def fused_min_idx(queries: torch.Tensor, r_dm: torch.Tensor,
                  n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(min_d2 (m,) f32, idx (m,) i32): exact 1-NN of each (m, k) query over
    columns [0, n) of dim-major refs (k, n_pad) (default: all columns).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise RuntimeError if it cannot be built or launched)."""
    n = r_dm.shape[1] if n is None else n
    if queries.dim() != 2 or r_dm.dim() != 2 or queries.shape[1] != r_dm.shape[0]:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, r_dm {tuple(r_dm.shape)}")
    if not 0 < n <= r_dm.shape[1]:
        raise ValueError(f"n={n} outside (0, {r_dm.shape[1]}]")
    if queries.dtype != torch.float32 or r_dm.dtype != torch.float32:
        raise TypeError("fused_min_idx takes float32 tensors")
    if queries.device != r_dm.device:
        raise ValueError(f"queries on {queries.device}, refs on {r_dm.device}")
    if queries.device.type == "cpu":
        return fused_min_idx_plain(queries, r_dm, n)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if queries.shape[0] == 0:
        return (torch.empty(0, dtype=torch.float32, device=queries.device),
                torch.empty(0, dtype=torch.int32, device=queries.device))
    return _fused_min_idx_cuda(queries.contiguous(), r_dm.contiguous(), n)


def nns_fused(queries, refs, tile_n: int = 4096, device="cuda") -> torch.Tensor:
    """v4 one-shot: exact 1-NN indices (m,) i32 on ``device``."""
    r_dm, _ = prepare_refs(refs, tile_n, device)
    return fused_min_idx(as_f32(queries, device), r_dm, refs.shape[0])[1]


def fused_fallback(queries, refs, device="cuda") -> torch.Tensor:
    """Exact full-scan fallback for certificate failures: the query count is
    padded to a power-of-two bucket (>= 8), the shapes the JAX package
    compiles for, and the tail sliced off. ``refs`` may already be a tensor
    on ``device`` (no host transfer then)."""
    q = as_f32(queries, device)
    m = q.shape[0]
    bucket = layouts.pow2_at_least(max(m, 8))
    q = layouts.pad_queries(q, bucket)
    return nns_fused(q, refs, device=device)[:m]


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

