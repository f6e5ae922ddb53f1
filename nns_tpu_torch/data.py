"""Sample generation (reference analog: getRand/getSample, main.cu:10-35).

A copy of ``nns_tpu/data.py``: the same seed gives byte-equal arrays in
both packages (pinned by tests/test_torch_host.py).

The reference fills point sets with uniform [0, 1] floats from seeded libc
rand() (main.cu:10-22), reseeding before each version so every version sees
identical data (main.cu:64). We use a seeded numpy Generator: same contract
(deterministic, identical across versions for a given seed), better RNG.
"""

from __future__ import annotations

import numpy as np


def make_dataset(
    k: int,
    m: int,
    n: int,
    seed: int,
    clustered: bool = False,
    sigma: float = 0.01,
    n_clusters: int | None = None,
    anisotropy: float = 1.0,
    powerlaw: bool = False,
    query_box: tuple[float, float] = (0.0, 1.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Return (queries[m,k], refs[n,k]) float32.

    ``clustered=True`` draws reference points from a mixture of Gaussian
    blobs instead of uniform — the workload where spatial trees shine
    (BASELINE.md octree config: "1M clustered 3-D refs"). The blob shape is
    parameterizable (round-3 adaptation evidence used a single fixed
    shape — VERDICT r3 item 8):

    - ``sigma``: blob standard deviation (default 0.01, the round-3 shape).
    - ``n_clusters``: blob count (default ~sqrt(n)/4).
    - ``anisotropy``: per-axis sigma ratio; axis d gets
      sigma * anisotropy ** (d / max(k-1, 1)) — 1.0 keeps isotropic blobs,
      e.g. 20.0 stretches the last axis 20x (pancake/filament clusters).
    - ``powerlaw``: cluster populations follow a Zipf-like 1/rank law
      instead of uniform assignment — a few dense cores plus a long tail
      of sparse blobs (density-adaptive index stress).
    - ``query_box``: (lo, hi) of the uniform query draw; e.g. (-0.5, 1.5)
      puts most queries OUTSIDE the data box (out-of-distribution serving).

    Reference analog: getRand/getSample (main.cu:10-35) knows only the
    uniform case; the extensions exist to exercise this rebuild's adaptive
    machinery, not for parity.
    """
    rng = np.random.default_rng(seed)
    if clustered:
        nc = n_clusters if n_clusters is not None else max(1, int(np.sqrt(n) / 4))
        centers = rng.random((nc, k), dtype=np.float32)
        if powerlaw:
            w = 1.0 / np.arange(1, nc + 1)
            assign = rng.choice(nc, size=n, p=w / w.sum())
        else:
            assign = rng.integers(0, nc, size=n)
        sig = sigma * anisotropy ** (np.arange(k) / max(k - 1, 1))
        refs = centers[assign] + (
            rng.normal(0, 1.0, size=(n, k)) * sig
        ).astype(np.float32)
        refs = np.clip(refs, 0.0, 1.0).astype(np.float32)
    else:
        refs = rng.random((n, k), dtype=np.float32)
    lo, hi = query_box
    queries = (rng.random((m, k), dtype=np.float32) * (hi - lo) + lo).astype(
        np.float32
    )
    return queries, refs
