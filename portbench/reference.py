"""The plain reference and the comparison that decides ``correct``.

Exact 1-NN in float64, direct form: for each query the least
``sum_d (q_d - r_d)^2`` over every ref, accumulated dimension by dimension
in ascending order from zero, in tiles of queries and refs that fit the
device. It takes the refs and queries the benchmark made and nothing the
program made.

The configurations state the guarantee (``configs/*.json``, "guarantee"):
recall@1 = 1.0 against float64 for float32 points, where the returned
point may lie within float32 arithmetic noise of the true minimum. A row
is a miss unless its returned index ``i`` is in range and

    d64(q, r_i) <= dmin64(q) * (1 + 2 (k + 3) 2^-24) + 1e-30,

the forward-error band of a k-term direct float32 sum: two points whose
true distances differ by less cannot be ranked by any float32 engine.

``control_min_idx`` is the control: the reference put in the program's
place one precision lower, TF32 (a float32 matrix product whose operands
keep 10 mantissa bits), in the expansion form ``|r|^2 - 2 q.r`` that such
a product computes. Its answers must miss.
"""

from __future__ import annotations

import numpy as np
import torch

# Elements of one (query tile, ref tile) float64 buffer: 2 GiB on a card,
# 32 MiB on a host.
_BUDGET = {"cuda": 1 << 28, "cpu": 1 << 22}


def band(k: int) -> float:
    """Relative distance band within which float32 cannot rank two points."""
    return 2.0 * (k + 3) * 2.0 ** -24


def _tiles(m: int, n: int, device: torch.device) -> tuple[int, int]:
    budget = _BUDGET.get(device.type, _BUDGET["cpu"])
    qt = max(1, min(m, 1024))
    return qt, max(1, min(n, budget // qt))


def nearest_d2(queries: np.ndarray, refs: np.ndarray, device) -> torch.Tensor:
    """(m,) float64: each query's least squared distance to any ref."""
    device = torch.device(device)
    q = torch.as_tensor(queries, device=device).to(torch.float64)
    rt = torch.as_tensor(refs, device=device).to(torch.float64).t().contiguous()
    (m, k), n = q.shape, rt.shape[1]
    qt, nt = _tiles(m, n, device)
    acc = torch.empty((qt, nt), dtype=torch.float64, device=device)
    buf = torch.empty_like(acc)
    out = torch.full((m,), float("inf"), dtype=torch.float64, device=device)
    for q0 in range(0, m, qt):
        qq = q[q0:q0 + qt]
        for n0 in range(0, n, nt):
            a = acc[:qq.shape[0], :min(nt, n - n0)]
            b = buf[:a.shape[0], :a.shape[1]]
            a.zero_()
            for d in range(k):
                torch.sub(qq[:, d:d + 1], rt[d, n0:n0 + a.shape[1]], out=b)
                b.mul_(b)
                a.add_(b)
            out[q0:q0 + qq.shape[0]] = torch.minimum(out[q0:q0 + qq.shape[0]], a.amin(dim=1))
    return out


def misses(queries: np.ndarray, refs: np.ndarray, idx: np.ndarray, device) -> int:
    """Rows of ``idx`` (the answers to ``queries``) that are no nearest
    neighbour under the configurations' guarantee (module docstring)."""
    device = torch.device(device)
    n, k = refs.shape
    idx_t = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)
    valid = (idx_t >= 0) & (idx_t < n)
    q = torch.as_tensor(queries, device=device).to(torch.float64)
    r = torch.as_tensor(refs, device=device)[idx_t.clamp(0, n - 1)].to(torch.float64)
    d_ret = torch.zeros(q.shape[0], dtype=torch.float64, device=device)
    for d in range(k):
        d_ret += (q[:, d] - r[:, d]) ** 2
    dmin = nearest_d2(queries, refs, device)
    hit = valid & (d_ret <= dmin * (1.0 + band(k)) + 1e-30)
    return int((~hit).sum())


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def control_min_idx(queries: np.ndarray, refs: np.ndarray, device) -> np.ndarray:
    """The control's answers: argmin over refs of ``|r|^2 - 2 q.r`` with the
    product's operands in TF32 and float32 accumulation; the lowest index
    among equal values."""
    device = torch.device(device)
    q = round_tf32(torch.as_tensor(queries, device=device, dtype=torch.float32))
    r32 = torch.as_tensor(refs, device=device, dtype=torch.float32)
    r = round_tf32(r32)
    r2 = (r32 * r32).sum(dim=1)
    m, n = q.shape[0], r.shape[0]
    qt, nt = _tiles(m, n, device)
    best = torch.full((m,), float("inf"), dtype=torch.float32, device=device)
    arg = torch.zeros((m,), dtype=torch.int64, device=device)
    for n0 in range(0, n, nt):
        for q0 in range(0, m, qt):
            s = r2[n0:n0 + nt] - 2.0 * (q[q0:q0 + qt] @ r[n0:n0 + nt].t())
            v, i = s.min(dim=1)
            better = v < best[q0:q0 + qt]
            best[q0:q0 + qt] = torch.where(better, v, best[q0:q0 + qt])
            arg[q0:q0 + qt] = torch.where(better, i + n0, arg[q0:q0 + qt])
    return arg.cpu().numpy()
