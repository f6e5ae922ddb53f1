"""Uniform public API + the version registry. Counterpart of
``nns_tpu/api.py``.

Every version is a callable ``fn(queries[m,k] f32, refs[n,k] f32) ->
idx[m] i32`` plus a build/query split (``NNEngine``), which tree versions
use to report build time apart from query time. The registry names all 15
versions of the JAX package, and the port runs every one. Everything runs
on an explicit ``device`` (default ``"cuda"``). v0, v10 and v12 query on
the host and never touch ``device``. The multi-device choices (v8, the
sharded supercell index) follow how many distinct devices of ``device``'s
type ``parallel.mesh.make_mesh`` finds: ``torch.cuda.device_count()``
CUDA devices, one CPU.

The capability-fallback contract of the JAX package holds: the KD-tree
versions (v10/v11) fall back to the linear scan for k > 16, the octree
versions (v12/v13) for k != 3 (v11 and v13 on the fused device kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from nns_tpu_torch.config import DEFAULT_ENGINE_CONFIG, EngineConfig
from nns_tpu_torch.kernels.layouts import non_finite_error
from nns_tpu_torch.utils.spans import span, spanned


def _as_idx(x: Any) -> np.ndarray:
    if hasattr(x, "cpu"):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int32)


def _check_finite(arr: np.ndarray, name: str) -> None:
    """NaN/inf coordinates silently poison distance comparisons; reject them
    at the API boundary."""
    if not np.isfinite(arr).all():
        raise non_finite_error(name)


# Version adapters, as nns_tpu/api.py:49-98. ``r`` is the numpy refs, or
# (NNEngine.query) the refs tensor that NNEngine.build staged on ``device``.


def _v0(q, r, cfg, device):
    from nns_tpu_torch.kernels.oracle import linear_scan

    return linear_scan(np.asarray(q), np.asarray(r))


def _v1(q, r, cfg, device):
    from nns_tpu_torch.kernels.xla_bruteforce import nns_distance_matrix

    return _as_idx(nns_distance_matrix(q, r, device=device))


def _v2(q, r, cfg, device):
    from nns_tpu_torch.kernels.xla_bruteforce import nns_expansion_matmul

    return _as_idx(nns_expansion_matmul(q, r, device=device))


def _v3(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused_ladder import nns_fused_point_major

    return _as_idx(nns_fused_point_major(q, r, device=device))


def _v4(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused import nns_fused

    return _as_idx(nns_fused(q, r, tile_n=cfg.tile_n, device=device))


def _v5(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused_ladder import nns_fused_streaming

    return _as_idx(nns_fused_streaming(q, r, tile_n=cfg.tile_n, device=device))


def _v6(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused_ladder import nns_fused_queries_resident

    return _as_idx(nns_fused_queries_resident(
        q, r, max_query_bytes=cfg.vmem_query_budget_bytes, device=device))


def _v7(q, r, cfg, device):
    from nns_tpu_torch.kernels.fused_ladder import nns_two_level

    return _as_idx(nns_two_level(q, r, tile_n=cfg.tile_n, device=device))


def _v8(q, r, cfg, device):
    from nns_tpu_torch.parallel.sharded import nns_sharded

    return _as_idx(nns_sharded(q, r, device=device))


def _v9(q, r, cfg, device):
    from nns_tpu_torch.kernels.mxu_expansion import nns_mxu_expansion

    return _as_idx(nns_mxu_expansion(q, r, device=device))


def _v10(q, r, cfg, device):
    from nns_tpu_torch.trees.kdtree import nns_kdtree_host

    return _as_idx(nns_kdtree_host(q, r, max_k=cfg.kd_max_k))


def _v11(q, r, cfg, device):
    from nns_tpu_torch.trees.kdtree_device import nns_kdtree_device

    return _as_idx(nns_kdtree_device(q, r, max_k=cfg.kd_max_k, device=device))


def _v12(q, r, cfg, device):
    from nns_tpu_torch.trees.octree import nns_octree_host

    return _as_idx(nns_octree_host(q, r, max_depth=cfg.octree_max_depth))


def _v13(q, r, cfg, device):
    from nns_tpu_torch.trees.octree_device import nns_octree_device

    return _as_idx(nns_octree_device(q, r, max_depth=cfg.octree_max_depth, device=device))


def _v14(q, r, cfg, device):
    from nns_tpu_torch.kernels.cell_list import nns_cell_list

    return _as_idx(nns_cell_list(q, r, device=device))


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    num: int
    name: str
    family: str  # "cpu" | "bruteforce" | "sharded" | "tree"
    description: str
    fn: Callable[..., np.ndarray]

    def __call__(self, queries, refs, config: EngineConfig | None = None,
                 device="cuda") -> np.ndarray:
        return self.fn(queries, refs, config or DEFAULT_ENGINE_CONFIG, device)


_SPECS = [
    VersionSpec(0, "cpu_scan", "cpu", "CPU linear scan (oracle; core.cu v0)", fn=_v0),
    VersionSpec(1, "distance_matrix", "bruteforce", "materialized distance matrix + argmin (v1)", fn=_v1),
    VersionSpec(2, "expansion_matmul", "bruteforce", "|q-r|^2 full-fp32 expansion matmul + exact refine (v2, thrust analog)", fn=_v2),
    VersionSpec(3, "fused_point_major", "bruteforce", "fused CUDA kernel, point-major refs (v3)", fn=_v3),
    VersionSpec(4, "fused", "bruteforce", "fused CUDA kernel, dim-major refs — flagship brute force (v4, SoA analog)", fn=_v4),
    VersionSpec(5, "fused_streaming", "bruteforce", "fused CUDA kernel, ref tiles streamed through a shared-memory ring of bulk copies (v5, texture analog)", fn=_v5),
    VersionSpec(6, "fused_queries_resident", "bruteforce", "fused CUDA kernel, query set resident on chip, grid over ref ranges only (v6, constant-memory analog)", fn=_v6),
    VersionSpec(7, "two_level", "bruteforce", "per-tile partial winners + second reduce (v7, multi-block analog)", fn=_v7),
    VersionSpec(8, "sharded", "sharded", "refs sharded over devices, argmin merge (v8, 4-GPU analog)", fn=_v8),
    VersionSpec(9, "mxu_expansion", "bruteforce", "split-bf16 expansion + band certificate + exact refine (v9)", fn=_v9),
    VersionSpec(10, "kdtree_host", "tree", "KD-tree host build + host query (v10)", fn=_v10),
    VersionSpec(11, "kdtree_device", "tree", "KD-tree host build + beam frontier device query (v11)", fn=_v11),
    VersionSpec(12, "octree_host", "tree", "octree host build + host query (v12)", fn=_v12),
    VersionSpec(13, "octree_device", "tree", "octree host build + beam frontier device query (v13)", fn=_v13),
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


def _multi_device(device) -> bool:
    """Whether ``device``'s type has more than one distinct device (read at
    call time, so that tests can hand the API a mesh of their own)."""
    from nns_tpu_torch.parallel import mesh

    return mesh.make_mesh(device=device).size > 1


def nns(
    queries,
    refs,
    version: int | str = "auto",
    config: EngineConfig | None = None,
    device="cuda",
) -> np.ndarray:
    """Exact 1-NN: for each query, the index of its nearest reference point.

    ``version="auto"`` is a brute force (no index build to amortize in a
    one-shot call; NNEngine picks the supercell index): v8 over every
    distinct device of ``device``'s type when there are several, else v4.
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
    if version == "auto":
        spec = REGISTRY[8] if _multi_device(device) else REGISTRY[4]
    else:
        spec = get_version(version)
    return spec(queries, refs, config, device)


class NNEngine:
    """Build/query split: build stages the index (v14, and the beam frontier
    it may promote to; with "auto" on several devices, the sharded index),
    the tree (v10-v13, v11 and v13 with their beam frontier on ``device``),
    the split-bf16 expansion engine (v9, k >= 8, and the KD beam index its
    high-k ladder may promote to), the dim-major refs (v4, and v11/v13 past
    their trees' k; v8 once per shard of ``best_mesh``), or the refs
    themselves (v1-v3, v5-v7, v9 at k < 8) once; query / query_many reuse
    them. v0 stages nothing: it scans on the host. Tree and index engines
    also ``save`` and ``load``, in the JAX package's file formats."""

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
        # High-k (v9) adaptation state, see _query_high_k.
        self._hk_seen = 0
        self._hk_probed = False
        self._hk_beam = 8
        self._hk_budget: int | None = None  # chunk-scan bucket budget
        self._hk_mxu: Any = None
        self._hk_recent: np.ndarray | None = None

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

    def _promote_to_beam(self) -> None:
        """v14's workload adaptation, step 1: the octree beam index, whose
        buckets follow the data's density (nns_tpu/api.py:283-288)."""
        from nns_tpu_torch.trees.octree import Octree

        with span("nns.api.promote"):
            self._built = Octree.build(
                self._refs, max_depth=self.config.octree_max_depth
            ).device_index(self.device)

    def _fused_engine(self):
        """The v4 engine over the refs, staged once on ``device``."""
        from nns_tpu_torch.kernels.fused import FusedBruteForce

        return FusedBruteForce(self._refs, tile_n=self.config.tile_n, device=self.device)

    @spanned("nns.api.build")
    def build(self, refs) -> "NNEngine":
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.kernels.fused import FusedBruteForce, as_f32
        from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion
        from nns_tpu_torch.parallel import mesh
        from nns_tpu_torch.parallel.sharded import ShardedBruteForce
        from nns_tpu_torch.parallel.sharded_cells import ShardedCellEngine
        from nns_tpu_torch.trees.kdtree import KDTree
        from nns_tpu_torch.trees.octree import Octree

        refs = np.atleast_2d(np.asarray(refs, dtype=np.float32))
        _check_finite(refs, "refs")
        self._refs = refs
        self._cov_miss = 0  # fresh index: forget prior coverage history
        self._cov_seen = 0
        self._hk_seen = 0  # fresh index: re-arm the high-k probe
        self._hk_probed = False
        self._hk_beam = 8
        self._hk_budget = None
        self._hk_mxu = None
        self._hk_recent = None
        multi = self._auto and _multi_device(self.device)
        if self._auto:
            # Build/query semantics amortize index construction: the
            # supercell index for large 3-D sets (sharded over the devices
            # when there are several), v8 for other shapes on several
            # devices, the expansion engine for high-k sets, else the fused
            # kernel (nns_tpu/api.py:466-479).
            if refs.shape[1] == 3 and refs.shape[0] >= 65536:
                self.spec = get_version(14)
            elif multi:
                self.spec = get_version(8)
            else:
                self.spec = get_version(9 if refs.shape[1] >= 8 else 4)
        num, k, cfg = self.spec.num, refs.shape[1], self.config
        if num == 14 and k == 3 and refs.shape[0] >= 4096:
            try:
                if multi:
                    # Auto only: explicit v14 stays the single-device rung,
                    # as in the JAX package. The sharded index never
                    # promotes (its beam and fused rungs are single-device).
                    self._built = ShardedCellEngine(refs, mesh.make_mesh(device=self.device))
                else:
                    self._built = CellListEngine(refs, device=self.device)
            except ValueError:
                # Too clustered for the cell index: degrade ONCE at build
                # time to the staged fused engine.
                self._built = self._fused_engine()
        elif (num in (4, 14) or (num == 11 and 6 < k <= cfg.kd_max_k)
              or (num == 13 and k != cfg.octree_k)):
            # v11 past 6 dims and v13 off the octree's k answer by the fused
            # device scan, staged once here (nns_tpu/api.py:517-539).
            self._built = self._fused_engine()
        elif num in (10, 11) and k <= cfg.kd_max_k:
            self._built = KDTree.build(refs)
            if num == 11:
                self._built.device_index(self.device)  # stage the beam frontier now
        elif num in (12, 13) and k == cfg.octree_k:
            self._built = Octree.build(refs, max_depth=cfg.octree_max_depth)
            if num == 13:
                self._built.device_index(self.device)
        elif num == 8:
            # The refs staged once per shard; one device stages v4's engine.
            shards = mesh.best_mesh(refs.shape[0], device=self.device)
            self._built = (self._fused_engine() if shards.size == 1
                           else ShardedBruteForce(refs, shards))
        elif num == 9 and k >= 8:
            # Sets past the staging bound (n >= 2^25) degrade once, at build
            # time, to the staged fused engine.
            try:
                self._built = MXUExpansion(refs, device=self.device)
            except ValueError:
                self._built = FusedBruteForce(refs, device=self.device)
        elif num in (0, 10, 11, 12):
            # v0, and the trees past their k: host scans read the numpy refs.
            self._built = None
        else:
            # v1-v3, v5-v7 and v9 at k < 8: the refs go to the device once
            # (JAX's device_put, nns_tpu/api.py:561-565); each query runs the
            # version's own function on them.
            self._built = as_f32(refs, self.device)
        return self

    def _as_queries(self, queries) -> np.ndarray:
        """The queries as an f32 (m, k) array, after the build and dimension
        checks."""
        if self._refs is None:
            raise RuntimeError("call build(refs) first")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self._refs.shape[1]:
            raise ValueError(
                f"dimension mismatch: queries k={queries.shape[1]}, "
                f"refs k={self._refs.shape[1]}"
            )
        return queries

    def _check_queries(self, queries) -> np.ndarray:
        """``_as_queries`` and the host's finiteness pass."""
        queries = self._as_queries(queries)
        _check_finite(queries, "queries")
        return queries

    def _note_cell_coverage(self, cov: float, m: int) -> bool:
        """Feed v14's promotion hysteresis: True once the fixed-halo
        certificate persistently misses the query distribution (e.g.
        sparse-region queries over clustered refs). A single stray outlier
        batch never triggers the octree build, a synchronous stall."""
        return self._note_coverage(cov, m, good_cov=0.95, miss_frac=0.3)

    # -- v9's high-k adaptation ladder (nns_tpu/api.py:290-429) -------------

    def _hk_fallback(self, q_bad: np.ndarray) -> np.ndarray:
        """Exact re-answer of beam-uncertified rows by the retained engine
        (the expansion engine, whose own uncertified rows take the v3 full
        scan). The JAX package pads the rows to a power-of-two bucket to
        bound its compiles; the answers are the same without."""
        return _as_idx(self._hk_mxu.query(q_bad))

    def _query_high_k(self, queries: np.ndarray) -> np.ndarray:
        """v9's serving path with its workload ladder. The expansion engine
        scans every ref, the right engine for uniform high-k data; on
        clustered data a KD beam-frontier index prunes the scanned set. After
        enough query volume the engine probes the beam's certificate coverage
        on live queries and promotes when it prunes well; sustained coverage
        misses demote the chunk scan to the per-query beam, then the beam to
        the retained expansion engine. Every rung is exact: beam-uncertified
        rows are re-answered by the retained engine (``_hk_fallback``)."""
        from nns_tpu_torch.trees.beam import BeamIndex

        if isinstance(self._built, BeamIndex):
            idx, cov = self._built.query_with_coverage(
                queries, beam=self._hk_beam, budget=self._hk_budget)
            if self._note_coverage(cov, queries.shape[0], good_cov=0.5, miss_frac=0.7):
                with span("nns.api.promote"):
                    if self._hk_budget is not None:
                        # The scan rung's chunk locality failed on the live
                        # stream (its probe certified per-query beam-16
                        # coverage only): the per-query beam gets a fresh
                        # hysteresis window before the index is given up.
                        self._hk_budget = None
                    else:
                        # Only the probe promotes, and it keeps the engine it
                        # replaced.
                        self._built = self._hk_mxu
            return _as_idx(idx)
        idx = _as_idx(self._built.query(queries))
        self._maybe_promote_high_k(queries)
        return idx

    def _maybe_promote_high_k(self, queries: np.ndarray) -> None:
        """The one-time probe, after hk_probe_after queries over at least
        hk_promote_n_min refs of k <= kd_max_k: build the KD beam index and
        measure its certificate coverage on the most recent <= 512 live
        queries. Rung 1, the chunk scan, when per-query beam-16 base coverage
        reaches hk_promote_cov on a frontier of at least 64 buckets (the
        probe window spans the whole workload's buckets, so the scan itself
        cannot be probed: beam-16 base coverage predicts it); rung 2, the
        smallest beam in (4, 8, 16) whose base pass covers; then a beam of 4
        or 8 that covers only with its 4x retry; else the engine stays. The
        probe runs once per ``build`` and never again (as in the JAX
        package)."""
        cfg = self.config
        n, k = self._refs.shape
        if self._hk_probed or n < cfg.hk_promote_n_min or k > cfg.kd_max_k:
            return
        self._hk_seen += queries.shape[0]
        # Rolling window of the most recent <= 512 live queries, so that a
        # small triggering batch still probes on a representative sample.
        recent = queries[-512:]
        if self._hk_recent is not None and len(recent) < 512:
            recent = np.concatenate([self._hk_recent[-(512 - len(recent)):], recent], axis=0)
        self._hk_recent = recent
        if self._hk_seen < cfg.hk_probe_after:
            return
        self._hk_probed = True
        self._hk_recent = None
        with span("nns.api.promote"):
            self._probe_high_k(recent)

    def _probe_high_k(self, recent: np.ndarray) -> None:
        """The probe's rungs over the ``recent`` live queries (see
        ``_maybe_promote_high_k``)."""
        from nns_tpu_torch.trees.kdtree import KDTree

        cfg = self.config
        bi = KDTree.build(self._refs).device_index(self.device)
        f_total = bi.lo.shape[0]

        def _promote(beam: int, budget: int | None = None) -> None:
            self._hk_mxu = self._built
            bi.exact_fallback = self._hk_fallback
            self._hk_beam = beam
            self._hk_budget = budget
            self._built = bi

        scan_ready = bi.desc_dim is not None and f_total >= 4 * 16
        if scan_ready:
            _, ok = bi.query_with_flags(recent, beam=16)
            if float(ok.mean()) >= cfg.hk_promote_cov:
                return _promote(16, budget=min(cfg.hk_scan_budget, f_total // 2))
        else:
            # Rung 2 (not tried past a beam-16 probe that missed: base
            # coverage is monotone in the beam).
            for beam in (4, 8, 16):
                if f_total < 4 * beam:
                    break  # the beam would cover >= 1/4 of the frontier
                _, ok = bi.query_with_flags(recent, beam=beam)
                if float(ok.mean()) >= cfg.hk_promote_cov:
                    return _promote(beam)
        # No base pass covers: a beam that covers with its 4x retry.
        for beam in (4, 8):
            _, ok = bi.query_with_flags(recent, beam=beam)
            bad = np.flatnonzero(~ok)
            if len(bad) and f_total > 4 * beam:
                _, ro = bi.query_with_flags(recent[bad], beam=beam * 4)
                ok[bad] = ro
            if float(ok.mean()) >= cfg.hk_promote_cov:
                return _promote(beam)

    @spanned("nns.api.query")
    def query(self, queries) -> np.ndarray:
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.kernels.fused import FusedBruteForce
        from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion
        from nns_tpu_torch.parallel.sharded import ShardedBruteForce
        from nns_tpu_torch.trees.beam import BeamIndex
        from nns_tpu_torch.trees.kdtree import KDTree
        from nns_tpu_torch.trees.octree import Octree

        queries = self._check_queries(queries)
        built, m = self._built, queries.shape[0]
        if self.spec.num == 9 and isinstance(built, (BeamIndex, FusedBruteForce, MXUExpansion)):
            return self._query_high_k(queries)
        if isinstance(built, CellListEngine):
            idx, cov = built.query_with_coverage(queries)
            # By exact type: the sharded index (a subclass) never promotes.
            if self._note_cell_coverage(cov, m) and type(built) is CellListEngine:
                self._promote_to_beam()
            return _as_idx(idx)
        if isinstance(built, BeamIndex):
            idx, cov = built.query_with_coverage(queries)
            # Step 2: if even the beam index's coverage stays poor, its
            # passes are pure overhead on the exact scan — demote to the
            # staged fused engine (nns_tpu/api.py:605-619).
            if self._note_coverage(cov, m, good_cov=0.5, miss_frac=0.7):
                with span("nns.api.promote"):
                    self._built = self._fused_engine()
            return _as_idx(idx)
        if isinstance(built, (KDTree, Octree)):
            if self.spec.num in (10, 12):
                return _as_idx(built.query_host(queries))
            return _as_idx(built.query_device(queries, self.device))
        if isinstance(built, (FusedBruteForce, ShardedBruteForce)):
            return _as_idx(built.query(queries))
        # The version's own function (nns_tpu/api.py:637), on the staged refs.
        refs = self._refs if built is None else built
        return self.spec(queries, refs, self.config, self.device)

    @spanned("nns.api.query_many")
    def query_many(self, batches) -> list[np.ndarray]:
        """Exact answers for several query batches: the supercell engine
        drains the whole queue with one scan launch per batch and one
        device-to-host copy (CellListEngine.query_queue) and feeds the
        promotion hysteresis after the drain (the sharded index drains the
        same way and never promotes); the beam, fused, v8 and v9 expansion
        engines answer the concatenated queue in one call; the
        other versions answer batch by batch (nns_tpu/api.py:639-692).
        The single-device supercell drain checks the queue's finiteness on
        its device, in the pass that bins it, and its int32 answers come
        back as the drain made them: no host pass over the coordinates and
        no copy of the answers."""
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.kernels.fused import FusedBruteForce
        from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion
        from nns_tpu_torch.parallel.sharded import ShardedBruteForce
        from nns_tpu_torch.trees.beam import BeamIndex

        # By exact type: the sharded index (a subclass) stages on the host.
        drained_on_device = type(self._built) is CellListEngine
        check = self._as_queries if drained_on_device else self._check_queries
        batches = [check(b) for b in batches]
        if isinstance(self._built, CellListEngine):
            results, covs = self._built.query_queue(batches, return_coverage=True)
            # The answers of this queue are already exact; the next queue
            # gets the beam index.
            promote = False
            for qb, cov in zip(batches, covs):
                promote |= self._note_cell_coverage(cov, qb.shape[0])
            if promote and drained_on_device:
                self._promote_to_beam()
            if drained_on_device:
                return results  # the drain's int32 answers, uncopied
            return [_as_idx(i) for i in results]
        if (not isinstance(self._built, (BeamIndex, FusedBruteForce, MXUExpansion,
                                         ShardedBruteForce)) or not batches):
            return [self.query(b) for b in batches]
        idx = self.query(np.concatenate(batches, axis=0))
        offs = np.cumsum([b.shape[0] for b in batches])[:-1]
        return [_as_idx(part) for part in np.split(idx, offs)]

    def query_topk(self, queries, k_nn: int = 8):
        """Exact k-NN: (dist2[m, k], idx[m, k]) ascending, the lower index
        first among equal distances. The built supercell or beam index
        answers (certificate-gated); every other engine takes the exact
        chunked top-k scan on ``device``."""
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.kernels.topk import nns_topk
        from nns_tpu_torch.trees.beam import BeamIndex

        queries = self._check_queries(queries)
        if isinstance(self._built, (CellListEngine, BeamIndex)):
            return self._built.query_topk(queries, k_nn)
        return nns_topk(queries, self._refs, k_nn, device=self.device)

    def save(self, path: str) -> None:
        """The built tree or index (v10-v14), in the JAX package's npz
        format; brute-force engines (v9 included, as in the JAX package)
        are refused."""
        if self.spec is None or self.spec.family != "tree" or self._built is None:
            raise ValueError("save() supports built tree/index engines only")
        if not hasattr(self._built, "save"):
            raise ValueError(
                f"the built {type(self._built).__name__} engine is not serializable"
            )
        self._built.save(path)

    @classmethod
    def load(cls, path: str, version: int | str, config: EngineConfig | None = None,
             device="cuda") -> "NNEngine":
        """An engine over a file that ``save`` (of either package) wrote."""
        from nns_tpu_torch.kernels.cell_list import CellListEngine
        from nns_tpu_torch.trees.beam import BeamIndex
        from nns_tpu_torch.trees.kdtree import KDTree
        from nns_tpu_torch.trees.octree import Octree

        eng = cls(version, config, device)
        if eng.spec is None:
            raise ValueError("load() needs an explicit version, not 'auto'")
        num = eng.spec.num
        if num in (10, 11):
            eng._built = KDTree.load(path)
        elif num in (12, 13):
            eng._built = Octree.load(path)
        elif num == 14:
            # Two on-disk forms: the supercell halo tensor, or the beam
            # frontier a clustered workload promoted to.
            with np.load(path) as z:
                is_beam = "beam_pts" in z
            eng._built = (BeamIndex if is_beam else CellListEngine).load(path, device=device)
        else:
            raise ValueError("load() supports tree/index versions (10-14) only")
        eng._refs = eng._built.refs
        return eng
