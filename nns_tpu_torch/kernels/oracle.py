"""V0 analog: CPU linear scan, plus the float64 ground-truth oracle.

Reference: v0::cudaCall (core.cu:11-54) — triple loop over (m, n, k) with a
running argmin of squared L2 distance; the trivially-correct oracle and the
runtime fallback target of v8/v9/v10/v11/v12/v13.

A copy of ``nns_tpu/kernels/oracle.py`` (pinned equal by
tests/test_torch_host.py); only the native loader it calls is the port's.

Here the scan is vectorized numpy (with an optional native C++/OpenMP path,
see nns_tpu_torch/native) and there is a second, stricter artifact the reference
never had: a float64 oracle + recall checker used by the test suite and the
harness, closing the "no tests, outputs never compared" gap (SURVEY.md §4).

Numerics: inputs are float32. The f64 oracle accumulates (q_d - r_d)^2 in
float64, giving distances with ~1e-16 relative error — ground truth for any
f32-representable gap. ``recall_at_1`` counts a returned index as a hit iff
its f64 distance ties the f64 minimum within 1e-9 relative tolerance (exact
search admits any true argmin under ties).
"""

from __future__ import annotations

import numpy as np

# Query-chunk size bounding oracle memory at chunk * n float64.
_CHUNK = 128


def _dists_f64(q_chunk: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Exact-ish squared L2 distances, (chunk, n) float64, accumulated per-dim
    to avoid a (chunk, n, k) intermediate. Direct (q-r)^2 arithmetic (the
    expansion form would bound error at ~1e-12 relative — fine vs the 1e-9
    tie tolerance, but the oracle is the ground truth, so keep it sharp).
    One reused (chunk, n) scratch: fresh numpy temporaries per dim cost
    ~3 GB of allocator/page churn each at n=1M, which made a 512-query
    k=16 oracle check take minutes on a slow host."""
    q = q_chunk.astype(np.float64)
    r = refs.astype(np.float64)
    out = np.zeros((q.shape[0], r.shape[0]), dtype=np.float64)
    buf = np.empty_like(out)
    for d in range(q.shape[1]):
        np.subtract(q[:, d, None], r[None, :, d], out=buf)
        np.multiply(buf, buf, out=buf)
        out += buf
    return out


def nn_oracle_f64(queries: np.ndarray, refs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ground truth: (argmin_idx[m] int64, min_dist2[m] float64)."""
    m = queries.shape[0]
    n = refs.shape[0]
    # Bound the (chunk, n) f64 intermediate to ~1 GB: at 16M+ refs the
    # fixed 128-query chunk would allocate 17 GB and stall the host.
    chunk = max(1, min(_CHUNK, (1 << 27) // max(n, 1)))
    idx = np.empty(m, dtype=np.int64)
    dmin = np.empty(m, dtype=np.float64)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        d = _dists_f64(queries[lo:hi], refs)
        idx[lo:hi] = np.argmin(d, axis=1)
        dmin[lo:hi] = d[np.arange(hi - lo), idx[lo:hi]]
    return idx, dmin


def recall_at_1(
    returned_idx: np.ndarray,
    queries: np.ndarray,
    refs: np.ndarray,
    oracle_dmin: np.ndarray | None = None,
) -> float:
    """Fraction of queries whose returned point is a true nearest neighbor.

    Tie-tolerant: a hit iff d64(q, returned) <= d64_min * (1 + 1e-9) + 1e-30,
    so any member of an exact tie class counts (the reference's convention —
    its serial scans keep the lowest index, but exactness only requires *a*
    nearest neighbor).

    f32-degeneracy fallback: inputs are float32 and engines compute in
    float32, so the strongest claim any engine can make is "the returned
    point attains the minimal distance up to f32 ARITHMETIC noise". The
    direct form sums k terms ``(q_d - r_d)^2``, each with <= 2 roundings
    plus the accumulation chain — a standard forward-error bound of
    ``(k+3) * 2^-24`` relative per distance, so two candidates whose true
    distances differ by less than ``2 * (k+3) * 2^-24`` relative are not
    reliably rankable by ANY f32 engine. On scale-mixed data (e.g. a probe
    ~500 away from a 1e-4-wide cluster) thousands of points sit inside
    that band; a query missing the 1e-9 f64 test still counts as a hit iff
    its returned distance is within the band of the true minimum. On
    f32-sharp data (runner-up gap above the band) the fallback never fires
    and the checker stays as strict as before.
    """
    returned_idx = np.asarray(returned_idx)
    if oracle_dmin is None:
        _, oracle_dmin = nn_oracle_f64(queries, refs)
    q = queries.astype(np.float64)
    r = refs.astype(np.float64)[returned_idx]
    d_ret = np.sum((q - r) ** 2, axis=1)
    hits = d_ret <= oracle_dmin * (1.0 + 1e-9) + 1e-30
    if not hits.all():
        # f32-degenerate top: the returned distance sits within f32
        # arithmetic noise of the minimum -> no f32 engine could rank the
        # two, and the returned point IS an f32-minimal answer.
        band = 2.0 * (queries.shape[1] + 3) * 2.0 ** -24
        hits |= d_ret <= oracle_dmin * (1.0 + band)
    return float(np.mean(hits))


def linear_scan(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """v0: CPU linear scan in float32 (core.cu:11-54 analog), lowest-index
    tie-break. Uses the native C++/OpenMP scan when built, else numpy."""
    from nns_tpu_torch.native import native_linear_scan  # lazy: optional .so

    out = native_linear_scan(queries, refs)
    if out is not None:
        return out
    return _linear_scan_numpy(queries, refs)


def _linear_scan_numpy(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    m, k = queries.shape
    idx = np.empty(m, dtype=np.int32)
    refs32 = refs.astype(np.float32)
    for lo in range(0, m, _CHUNK):
        hi = min(lo + _CHUNK, m)
        q = queries[lo:hi].astype(np.float32)
        acc = np.zeros((hi - lo, refs.shape[0]), dtype=np.float32)
        for d in range(k):
            diff = q[:, d, None] - refs32[None, :, d]
            acc += diff * diff
        idx[lo:hi] = np.argmin(acc, axis=1).astype(np.int32)  # lowest index on ties
    return idx
