"""Uniform public API + the version registry. Counterpart of
``nns_tpu/api.py``.

Every version is a callable ``fn(queries[m,k] f32, refs[n,k] f32) ->
idx[m] i32`` plus a build/query split (``NNEngine``). The registry names all
15 versions of the JAX package; the port runs v4 (fused brute force) and
v14 (supercell index) so far, and the others raise NotImplementedError
naming the ROADMAP slice that ports them. Everything runs on an explicit
``device`` (default ``"cuda"``); nothing here probes for a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from nns_tpu_torch.config import DEFAULT_ENGINE_CONFIG, EngineConfig


def _as_idx(x: Any) -> np.ndarray:
    if hasattr(x, "cpu"):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int32)


def _check_finite(arr: np.ndarray, name: str) -> None:
    """NaN/inf coordinates silently poison distance comparisons; reject them
    at the API boundary."""
    if not np.isfinite(arr).all():
        raise ValueError(
            f"{name} contains non-finite values (NaN/inf); exact NN search "
            "is defined for finite float32 coordinates only"
        )


def _v4(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused import nns_fused

    return _as_idx(nns_fused(q, r, tile_n=cfg.tile_n, device=device))


def _v14(q, r, cfg, device):
    from nns_tpu_torch.kernels.cell_list import nns_cell_list

    return _as_idx(nns_cell_list(q, r, device=device))


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    num: int
    name: str
    family: str  # "cpu" | "bruteforce" | "sharded" | "tree"
    description: str
    fn: Callable[..., np.ndarray] | None = None  # None: not ported yet
    roadmap_slice: int | None = None  # ROADMAP queue 1 slice that ports it

    def require_ported(self) -> None:
        if self.fn is None:
            raise NotImplementedError(
                f"version {self.num} ({self.name}) is not ported to PyTorch "
                f"yet: ROADMAP.md queue 1, slice {self.roadmap_slice}"
            )

    def __call__(self, queries, refs, config: EngineConfig | None = None,
                 device="cuda") -> np.ndarray:
        self.require_ported()
        return self.fn(queries, refs, config or DEFAULT_ENGINE_CONFIG, device)


_SPECS = [
    VersionSpec(0, "cpu_scan", "cpu", "CPU linear scan (oracle; core.cu v0)", roadmap_slice=5),
    VersionSpec(1, "distance_matrix", "bruteforce", "materialized distance matrix + argmin (v1)", roadmap_slice=5),
    VersionSpec(2, "expansion_matmul", "bruteforce", "|q-r|^2 expansion matmul + argmin (v2, thrust analog)", roadmap_slice=5),
    VersionSpec(3, "fused_point_major", "bruteforce", "fused kernel, point-major refs (v3)", roadmap_slice=5),
    VersionSpec(4, "fused", "bruteforce", "fused CUDA kernel, dim-major refs — flagship brute force (v4, SoA analog)", fn=_v4),
    VersionSpec(5, "fused_streaming", "bruteforce", "fused kernel, refs streamed through shared memory (v5, texture analog)", roadmap_slice=5),
    VersionSpec(6, "fused_queries_resident", "bruteforce", "fused kernel, whole query set resident (v6, constant-memory analog)", roadmap_slice=5),
    VersionSpec(7, "two_level", "bruteforce", "per-tile partial winners + second reduce (v7, multi-block analog)", roadmap_slice=5),
    VersionSpec(8, "sharded", "sharded", "refs sharded over devices, argmin merge (v8, 4-GPU analog)", roadmap_slice=8),
    VersionSpec(9, "mxu_expansion", "bruteforce", "split-bf16 expansion + band certificate + exact refine (v9)", roadmap_slice=6),
    VersionSpec(10, "kdtree_host", "tree", "KD-tree host build + host query (v10)", roadmap_slice=7),
    VersionSpec(11, "kdtree_device", "tree", "KD-tree host build + beam frontier device query (v11)", roadmap_slice=7),
    VersionSpec(12, "octree_host", "tree", "octree host build + host query (v12)", roadmap_slice=7),
    VersionSpec(13, "octree_device", "tree", "octree host build + beam frontier device query (v13)", roadmap_slice=7),
    VersionSpec(14, "cells", "tree", "supercell dense spatial index, batched CUDA scan + exactness certificate (beyond-ladder flagship for 3-D)", fn=_v14),
]

REGISTRY: dict[int, VersionSpec] = {s.num: s for s in _SPECS}
_BY_NAME: dict[str, VersionSpec] = {s.name: s for s in _SPECS}


def get_version(version: int | str) -> VersionSpec:
    if isinstance(version, str) and version in _BY_NAME:
        return _BY_NAME[version]
    try:
        return REGISTRY[int(version)]
    except (KeyError, ValueError):
        raise KeyError(
            f"unknown version {version!r}; valid: 0..{max(REGISTRY)} or names {sorted(_BY_NAME)}"
        )


def list_versions() -> list[VersionSpec]:
    return list(_SPECS)


def nns(
    queries,
    refs,
    version: int | str = "auto",
    config: EngineConfig | None = None,
    device="cuda",
) -> np.ndarray:
    """Exact 1-NN: for each query, the index of its nearest reference point.

    ``version="auto"`` is the one-device brute force, v4 (no index build
    to amortize in a one-shot call; NNEngine picks the supercell index).
    """
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    refs = np.atleast_2d(np.asarray(refs, dtype=np.float32))
    if queries.shape[1] != refs.shape[1]:
        raise ValueError(
            f"dimension mismatch: queries k={queries.shape[1]}, refs k={refs.shape[1]}"
        )
    if refs.shape[0] == 0:
        raise ValueError("reference set is empty")
    _check_finite(queries, "queries")
    _check_finite(refs, "refs")
    spec = REGISTRY[4] if version == "auto" else get_version(version)
    return spec(queries, refs, config, device)


class NNEngine:
    """Build/query split: build stages the index (v14) or the dim-major refs
    (v4) on ``device`` once; query / query_many reuse it."""

    def __init__(self, version: int | str = "auto", config: EngineConfig | None = None,
                 device="cuda"):
        self.config = config or DEFAULT_ENGINE_CONFIG
        self.device = device
        self._auto = version == "auto"
        self.spec = None if self._auto else get_version(version)
        self._built: Any = None
        self._refs: np.ndarray | None = None
        self._cov_miss = 0
        self._cov_seen = 0
        # Times the coverage hysteresis asked for the beam index, which is
        # not ported yet: the cell engine keeps serving (exact through the
        # fused fallback) instead.
        self.promotions_deferred = 0

    def _note_coverage(self, cov: float, m: int, good_cov: float,
                       miss_frac: float) -> bool:
        """Batch-weighted certificate-coverage hysteresis. Accumulates
        coverage-weighted misses; returns True (and clears the history)
        once a sustained miss rate over a real query budget (>= 128 seen,
        > miss_frac missed) says the engine should switch. Well-covered
        batches DECAY the history by half rather than resetting it."""
        self._cov_miss += int(round((1.0 - cov) * m))
        self._cov_seen += m
        if cov >= good_cov:
            self._cov_miss //= 2
            self._cov_seen //= 2
            return False
        if self._cov_seen >= 128 and self._cov_miss > miss_frac * self._cov_seen:
            self._cov_miss = 0
            self._cov_seen = 0
            return True
        return False

    def build(self, refs) -> "NNEngine":
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.kernels.fused import FusedBruteForce

        refs = np.atleast_2d(np.asarray(refs, dtype=np.float32))
        _check_finite(refs, "refs")
        self._refs = refs
        self._cov_miss = 0  # fresh index: forget prior coverage history
        self._cov_seen = 0
        if self._auto:
            # Build/query semantics amortize index construction: the
            # supercell index for large 3-D sets, else the fused kernel.
            large_3d = refs.shape[1] == 3 and refs.shape[0] >= 65536
            self.spec = get_version(14 if large_3d else 4)
        self.spec.require_ported()
        if self.spec.num == 14 and refs.shape[1] == 3 and refs.shape[0] >= 4096:
            try:
                self._built = CellListEngine(refs, device=self.device)
            except ValueError:
                # Too clustered for the cell index: degrade ONCE at build
                # time to the staged fused engine.
                self._built = FusedBruteForce(refs, tile_n=self.config.tile_n, device=self.device)
        else:
            self._built = FusedBruteForce(refs, tile_n=self.config.tile_n, device=self.device)
        return self

    def _check_queries(self, queries) -> np.ndarray:
        if self._refs is None:
            raise RuntimeError("call build(refs) first")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self._refs.shape[1]:
            raise ValueError(
                f"dimension mismatch: queries k={queries.shape[1]}, "
                f"refs k={self._refs.shape[1]}"
            )
        _check_finite(queries, "queries")
        return queries

    def _note_cell_coverage(self, cov: float, m: int) -> None:
        """Feed the promotion hysteresis; a promotion it asks for is
        deferred (the beam index is not ported yet)."""
        if self._note_coverage(cov, m, good_cov=0.95, miss_frac=0.3):
            self.promotions_deferred += 1

    def query(self, queries) -> np.ndarray:
        from nns_tpu_torch.kernels.cell_list import CellListEngine

        queries = self._check_queries(queries)
        if isinstance(self._built, CellListEngine):
            idx, cov = self._built.query_with_coverage(queries)
            self._note_cell_coverage(cov, queries.shape[0])
            return _as_idx(idx)
        return _as_idx(self._built.query(queries))

    def query_many(self, batches) -> list[np.ndarray]:
        """Exact answers for several query batches: the supercell engine
        drains the whole queue with one scan launch per batch and one
        device-to-host copy (CellListEngine.query_queue); the fused engine
        answers the concatenated queue in one call."""
        from nns_tpu_torch.kernels.cell_list import CellListEngine

        batches = [self._check_queries(b) for b in batches]
        if isinstance(self._built, CellListEngine):
            results, covs = self._built.query_queue(batches, return_coverage=True)
            for qb, cov in zip(batches, covs):
                self._note_cell_coverage(cov, qb.shape[0])
            return [_as_idx(i) for i in results]
        if not batches:
            return []
        idx = self.query(np.concatenate(batches, axis=0))
        offs = np.cumsum([b.shape[0] for b in batches])[:-1]
        return [_as_idx(part) for part in np.split(idx, offs)]
