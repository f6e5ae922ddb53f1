"""v1 and v2 of the brute-force ladder, in torch ops. Counterpart of
``nns_tpu/kernels/xla_bruteforce.py``.

The JAX package computes both at the XLA level, outside any Pallas kernel,
so they have no hand-written kernel here either:

- ``nns_distance_matrix`` (v1) materialises the direct-f32 distance matrix
  and takes each row's argmin (lowest index on ties). It works in chunks of
  queries: at 10K x 1M one unchunked matrix and its temporaries would not
  fit in 80 GB.
- ``nns_expansion_matmul`` (v2) ranks by the expansion
  ``|r|^2 - 2 q.r`` through a full-fp32 matmul, re-ranks the L = 8 smallest
  with the exact direct formula, and falls back to v1 for each row whose
  candidate set carries no certificate.
"""

from __future__ import annotations

import contextlib

import torch

from nns_tpu_torch.kernels.fused import as_f32

# Elements of one (chunk, n) f32 matrix: 1 GiB, so the matrix and its two
# temporaries stay near 3 GiB on the card whatever m is.
_BLOCK = 1 << 28
_EPS = 1.1920929e-07  # float32 machine epsilon, 2**-23


def _chunk_rows(n: int) -> int:
    return max(1, _BLOCK // max(n, 1))


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matmuls in full IEEE fp32 inside the block, whatever the
    caller chose (``set_float32_matmul_precision("high")`` allows TF32 on
    the card, "medium" bf16 through oneDNN on the CPU), and restore the
    caller's setting afterwards. The setting is process-wide, so a matmul
    another thread runs meanwhile also sees full fp32."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _distance_matrix_idx(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    m, k = q.shape
    r_dm = r.t().contiguous()
    out = torch.empty(m, dtype=torch.int32, device=q.device)
    chunk = _chunk_rows(r.shape[0])
    for lo in range(0, m, chunk):
        qc = q[lo:lo + chunk]
        d2 = torch.zeros((qc.shape[0], r.shape[0]), dtype=torch.float32, device=q.device)
        for d in range(k):
            diff = qc[:, d:d + 1] - r_dm[d:d + 1, :]
            d2 += diff * diff
        out[lo:lo + chunk] = torch.argmin(d2, dim=1)  # first minimum: lowest index
    return out


def nns_distance_matrix(queries, refs, device="cuda") -> torch.Tensor:
    """v1: materialised distance matrix + row argmin, exact (direct f32).
    Indices (m,) i32 on ``device``."""
    return _distance_matrix_idx(as_f32(queries, device), as_f32(refs, device))


def _delta(k: int, scale: torch.Tensor) -> torch.Tensor:
    """Bound on |e_computed - e_exact| for every point of every query.

    e = |r|^2 - 2 q.r takes two dot products of length k and one subtraction.
    A float32 dot product summed in ANY order, FMA or not (so whatever tiling
    and split cuBLAS picks), errs by at most gamma_k * sum|a_i b_i|, with
    gamma_k = k u / (1 - k u) and u = 2**-24; the subtraction adds u |e|.
    With |r|^2 + 2|q||r| <= 2 (max|r|^2 + max|q|^2) = 2 scale:

        |error| <= (gamma_k + u (1 + gamma_k)) * 2 scale ~= (k + 1) eps scale,

    eps = 2u. At k <= 16 that is at most ~17 eps scale, inside the JAX
    package's delta = 32 eps scale, which therefore stands; for k > 30 the
    bound is larger and is used instead ((k + 2) eps scale, with slack for
    the gamma_k denominator). TF32 (u = 2**-11) would void it, hence
    ``full_fp32_matmul``."""
    return torch.tensor(max(32.0, k + 2.0) * _EPS, dtype=torch.float32,
                        device=scale.device) * scale


def _expansion_idx(q: torch.Tensor, r: torch.Tensor,
                   refine_l: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    m, k = q.shape
    n = r.shape[0]
    l = min(refine_l, n)
    r2 = (r * r).sum(dim=1)
    # |q|^2 is constant per row and cannot change a row's ranking: left out.
    delta = _delta(k, r2.max() + (q * q).sum(dim=1).max())
    best = torch.empty(m, dtype=torch.int32, device=q.device)
    cert = torch.empty(m, dtype=torch.bool, device=q.device)
    chunk = _chunk_rows(n)
    for lo in range(0, m, chunk):
        qc = q[lo:lo + chunk]
        with full_fp32_matmul():
            cross = torch.matmul(qc, r.t())
        e = r2[None, :] - 2.0 * cross
        del cross
        vals, cand = torch.topk(e, l, dim=1, largest=False, sorted=True)
        del e
        # Exact re-rank of the L candidates, direct f32 in ascending d.
        rc = r[cand]  # (c, l, k)
        d2 = torch.zeros(cand.shape, dtype=torch.float32, device=q.device)
        for d in range(k):
            diff = qc[:, None, d] - rc[:, :, d]
            d2 = d2 + diff * diff
        hit = d2 == d2.amin(dim=1, keepdim=True)
        best[lo:lo + chunk] = torch.where(hit, cand, n).amin(dim=1)
        # Certificate: the true NN's expansion value is at most
        # vals[:, 0] + 2 delta, so when even the L-th kept value is above
        # that band no excluded point can be the NN.
        cert[lo:lo + chunk] = vals[:, -1] > vals[:, 0] + 2.0 * delta
    return best, cert


def nns_expansion_matmul(queries, refs, device="cuda") -> torch.Tensor:
    """v2: full-fp32 expansion matmul + top-L exact refine; rows whose
    certificate fails (more than L points inside the rounding band:
    duplicate-heavy data) are answered again by the exact v1 scan. Indices
    (m,) i32 on ``device``."""
    q, r = as_f32(queries, device), as_f32(refs, device)
    idx, cert = _expansion_idx(q, r)
    bad = torch.nonzero(~cert).flatten()
    if bad.numel():
        idx[bad] = _distance_matrix_idx(q[bad], r)
    return idx
