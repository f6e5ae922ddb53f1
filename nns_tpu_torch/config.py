"""Configuration: benchmark grid, seeds, engine tuning knobs.

A copy of ``nns_tpu/config.py`` (fields and defaults pinned equal by
tests/test_torch_host.py). The reference compiles its configuration in
(main.cu:38-54: the `samples[]` grid and `seed = 1000`); here the same
defaults are data. The tuning values were chosen for the JAX package and
have not been swept again on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# The reference's exact compiled-in workload grid: (k, m, n) triples
# (main.cu:38-51). k = dimensionality, m = #queries, n = #reference points.
REFERENCE_GRID: tuple[tuple[int, int, int], ...] = (
    (3, 1, 1024),
    (16, 1, 1024),
    (3, 1, 65536),
    (16, 1, 65536),
    (3, 1024, 1024),
    (16, 1024, 1024),
    (3, 1024, 65536),
    (16, 1024, 65536),
    (3, 1024, 1048576),
    (16, 1024, 1048576),
)

# Reference seeds srand(1000) before every version's run so all versions see
# identical data (main.cu:54, 64).
DEFAULT_SEED: int = 1000


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One harness run: which versions, over which grid, how timed.

    Defaults reproduce the reference protocol (main.cu:62-80): every version,
    the full grid, per-(version, config) wall-clock timing, identical seeded
    data for every version.
    """

    versions: Sequence[int] = tuple(range(15))  # ladder v0..v13 + v14 flagship
    grid: Sequence[tuple[int, int, int]] = REFERENCE_GRID
    seed: int = DEFAULT_SEED
    # Warm-up runs per callable before timing (reference analog: the static
    # WarmUP object running v9 ten times before main, core.cu:1900-1933).
    warmup_iters: int = 2
    # Timed repetitions; report the minimum (the reference times a single run).
    timing_iters: int = 3
    check_recall: bool = True
    # Reference-point distribution: uniform (the reference's rand() data,
    # main.cu:10-35) or clustered Gaussian mixtures; queries stay uniform
    # over the data box either way.
    clustered: bool = False
    # Extra make_dataset blob-shape knobs for clustered runs (sigma,
    # n_clusters, anisotropy, powerlaw); an immutable items-tuple so configs
    # stay hashable.
    cluster_shape: tuple = ()
    # Max queries to verify against the f64 oracle per config (full check when
    # m is small; subsample for huge m to bound oracle cost).
    recall_check_queries: int = 4096
    jsonl_path: str | None = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tuning knobs for the compute kernels.

    The reference hard-codes its analogs: BLOCK_DIM = 1024 (core.cu:139),
    texture height limit 65536 (core.cu:435), constant-memory 64 KB limit
    (core.cu:546), octree depth limit 9 (core.cu:1557), KD-tree k <= 16
    (core.cu:1148).
    """

    # Fused-kernel tile sizes (queries x reference points per tile). The
    # port's fused kernel picks its own CUDA tiles; tile_n still sets the
    # replica padding of the prepared dim-major refs.
    tile_m: int = 256
    tile_n: int = 4096
    # Dimensions are zero-padded to a multiple of this for alignment.
    k_pad_multiple: int = 8
    # Fallback thresholds (graceful-degradation contract, SURVEY.md §5):
    kd_max_k: int = 16        # KD-tree versions fall back to brute force above this.
    octree_k: int = 3         # Octree versions require exactly 3-D.
    octree_max_depth: int = 9  # Leaf when depth exceeds this (core.cu:1557 analog).
    # Whole-query-set-resident variant (v6 constant-memory analog) falls back
    # when m * k_padded * 4 bytes exceeds this budget.
    vmem_query_budget_bytes: int = 4 * 1024 * 1024
    # High-k workload adaptation (v9 -> KD beam frontier; not ported yet):
    # probe after this many queries over at least hk_promote_n_min refs,
    # promote at coverage >= hk_promote_cov, chunk-scan bucket budget.
    hk_probe_after: int = 2048
    hk_promote_cov: float = 0.9
    hk_promote_n_min: int = 1 << 17
    hk_scan_budget: int = 128


DEFAULT_ENGINE_CONFIG = EngineConfig()
