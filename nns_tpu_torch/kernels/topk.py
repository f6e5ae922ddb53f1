"""Exact k-nearest-neighbours (top-k). Counterpart of
``nns_tpu/kernels/topk.py``.

``nns_topk`` scans the refs in chunks of ``chunk_n`` with direct-form f32
distances (``d2 = 0; d2 = d2 + diff * diff`` per dimension, no expansion)
and merges each chunk's best into a running top-k, so memory stays bounded
by the query block times ``chunk_n`` for any n. Results are sorted by
(distance, index): equal distances order by the lower reference index, as
the 1-NN tie-break does and as the JAX package's ``lexsort`` orders them.

The order is carried by one int64 key per candidate, the f32 distance's
bits above the index (d2 >= +0, so the bits order as the values do).
``torch.topk`` over unique keys then has no ties to break, where over the
distances alone it promises no order among equal values. The JAX package
pads the last chunk with points at 1e6, which can win for queries near
1e6; here the last chunk is simply shorter, so no phantom point exists.
"""

from __future__ import annotations

import numpy as np
import torch

from nns_tpu_torch.kernels.fused import as_f32

# Bound on one (query rows, chunk) f32 distance block: 64M elements.
_BLOCK = 1 << 26


def sort_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (d2 >= +0 f32, idx >= 0 < 2^31) pairs by d2,
    then idx."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(d2 f32, idx i32) of ``sort_keys``' keys."""
    return (keys >> 32).to(torch.int32).view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


def smallest(d2: torch.Tensor, kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kk smallest of each row of (rows, cols) d2 >= +0, ascending, the
    lower column first among equal distances: (d2 (rows, kk), columns
    (rows, kk) i32)."""
    cols = torch.arange(d2.shape[1], dtype=torch.int32, device=d2.device)
    keys = torch.topk(sort_keys(d2, cols), kk, dim=1, largest=False).values
    return split_keys(keys)


def direct_d2(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Direct-form squared distances of (m, k) queries to candidates
    (m or 1, ..., k), each query against its own row of ``cand`` (or all
    against the one shared row): (m, ...) f32. Every exact path of the
    package accumulates ``d2 = d2 + diff * diff`` over the dimensions in
    ascending order here, the order the JAX package's answers (and the
    certificate margins) are held to."""
    m = q.shape[0]
    lead = (m,) + (1,) * (cand.dim() - 2)
    d2 = torch.zeros((m,) + tuple(cand.shape[1:-1]), dtype=torch.float32, device=q.device)
    for d in range(q.shape[1]):
        diff = q[:, d].reshape(lead) - cand[..., d]
        d2 = d2 + diff * diff
    return d2


def _topk_scan(queries: torch.Tensor, refs: torch.Tensor, k_nn: int,
               chunk_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over ref chunks: each chunk's best min(k_nn, chunk_n)
    merged with the carried k_nn by (d2, idx). The carry starts at (inf, 0),
    as the JAX package's does."""
    m = queries.shape[0]
    n = refs.shape[0]
    dev = queries.device
    best = sort_keys(torch.full((m, k_nn), float("inf"), device=dev),
                     torch.zeros((m, k_nn), dtype=torch.int32, device=dev))
    rows = max(1, _BLOCK // chunk_n)
    for c0 in range(0, n, chunk_n):
        r = refs[c0:c0 + chunk_n]
        cols = torch.arange(c0, c0 + r.shape[0], dtype=torch.int32, device=dev)
        kk = min(k_nn, r.shape[0])
        for lo in range(0, m, rows):
            keys = sort_keys(direct_d2(queries[lo:lo + rows], r[None]), cols)
            cand = torch.topk(keys, kk, dim=1, largest=False).values
            best[lo:lo + rows] = torch.topk(torch.cat([best[lo:lo + rows], cand], dim=1),
                                            k_nn, dim=1, largest=False).values
    return split_keys(best)


def nns_topk(queries, refs, k_nn: int = 8, chunk_n: int = 65536, device="cuda"):
    """Exact k-NN on ``device``: (dist2[m, k_nn] f32, idx[m, k_nn] i32)
    numpy arrays, ascending distance, lowest index first among ties. k_nn is
    clamped to n. ``refs`` may already be a tensor on ``device``."""
    q = as_f32(np.atleast_2d(np.asarray(queries, dtype=np.float32)), device)
    r = as_f32(refs if isinstance(refs, torch.Tensor) else np.atleast_2d(refs), device)
    n = r.shape[0]
    k_nn = min(k_nn, n)
    d2, idx = _topk_scan(q, r, k_nn, min(chunk_n, max(n, k_nn)))
    return d2.cpu().numpy(), idx.cpu().numpy()
