"""Array layout helpers — the v4 AoS->SoA analog (core.cu:293-306), in torch.

Counterpart of ``nns_tpu/kernels/layouts.py``, with the same padding
contract: reference points (n) are padded by replicating the first real
point (exact for any data range; replicas sit at indices >= n and lose
every lowest-index tie-break). Queries (m) are zero-padded and the tail
results sliced off. PAD_SENTINEL is for empty candidate SLOTS in the cell
engine (certificate-guarded), never for reference-point coordinates.
"""

from __future__ import annotations

import torch

# A padded halo slot at (BIG, BIG, BIG) has distance >= BIG^2 to any real
# query in [0,1]^3 — never the argmin. Kept well below f32 max so squared
# values don't overflow to inf.
PAD_SENTINEL = 1e6


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def pad_refs(refs: torch.Tensor, n_mult: int) -> torch.Tensor:
    """Pad the point axis of (n, k) to a multiple of n_mult by replicating
    the first reference point (see the module docstring)."""
    n = refs.shape[0]
    np_ = round_up(n, n_mult)
    if np_ == n:
        return refs
    pad = refs[0].expand(np_ - n, refs.shape[1])
    return torch.cat([refs, pad], dim=0)


def pad_queries(queries: torch.Tensor, m_mult: int) -> torch.Tensor:
    """Zero-pad the query axis of (m, k) to a multiple of m_mult."""
    m = queries.shape[0]
    mp = round_up(m, m_mult)
    if mp == m:
        return queries
    return torch.nn.functional.pad(queries, (0, 0, 0, mp - m))


def to_dim_major(points: torch.Tensor) -> torch.Tensor:
    """(p, k) point-major -> contiguous (k, p) dim-major (mat_inv_kernel
    analog)."""
    return points.t().contiguous()
