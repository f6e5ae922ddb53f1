"""Benchmark harness — the main.cu analog (main.cu:62-139). Counterpart of
``nns_tpu/harness.py``.

Every requested version runs over the seeded (k, m, n) config grid with
identical data per version (main.cu:54, 64), one record per (version,
config) (main.cu:76):

- every run's answers are scored against the f64 oracle (recall@1 must be
  1.0) on up to ``recall_check_queries`` queries;
- build time (tree construction, device staging) and query time are
  timed apart for every version, on the host clock; each timed region ends
  in a host copy (the answers) or a device synchronize (the build);
- an untimed build and ``warmup_iters`` queries first (kernel builds, first
  launches, staging caches), then the minimum over ``timing_iters`` runs;
- records go to a table and, optionally, a JSONL file
  (``utils/report.py``).

CLI: ``python -m nns_tpu_torch --versions 0,4,9 --grid small --device cpu``
(``--device`` defaults to ``cuda``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from nns_tpu_torch.api import NNEngine
from nns_tpu_torch.config import REFERENCE_GRID, BenchConfig
from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.kernels.oracle import nn_oracle_f64, recall_at_1
from nns_tpu_torch.utils.report import ReportWriter, RunRecord, format_table
from nns_tpu_torch.utils.timing import now_ns, synchronize

# Scaled-down grid for quick runs and tests (same corners, smaller n).
SMALL_GRID = (
    (3, 1, 1024),
    (16, 1, 1024),
    (3, 256, 1024),
    (16, 256, 1024),
    (3, 256, 16384),
    (16, 256, 16384),
)

_oracle_cache: dict = {}


def _oracle_for(k: int, m: int, n: int, seed: int, cap: int,
                clustered: bool = False, cluster_shape: tuple = ()):
    """Cached oracle minima for a (config, seed), on a query subsample sized
    to bound the f64 scan cost."""
    key = (k, m, n, seed, cap, clustered, cluster_shape)
    if key not in _oracle_cache:
        queries, refs = make_dataset(k, m, n, seed, clustered=clustered,
                                     **dict(cluster_shape))
        budget = max(1, min(m, cap, (1 << 28) // max(n, 1)))
        sub = (
            np.arange(m)
            if budget >= m
            else np.random.default_rng(0).choice(m, size=budget, replace=False)
        )
        _, dmin = nn_oracle_f64(queries[sub], refs)
        _oracle_cache[key] = (sub, dmin)
    return _oracle_cache[key]


def run_one(
    version: int | str,
    k: int,
    m: int,
    n: int,
    cfg: BenchConfig,
    device="cuda",
) -> RunRecord:
    queries, refs = make_dataset(k, m, n, cfg.seed, clustered=cfg.clustered,
                                 **dict(cfg.cluster_shape))
    engine = NNEngine(version, device=device)

    # An untimed build of the same data first, so that the timed build pays
    # no first-use cost of its staging.
    if cfg.warmup_iters > 0:
        NNEngine(version, device=device).build(refs)
        synchronize(device)

    t0 = now_ns()
    engine.build(refs)
    synchronize(device)
    build_ms = (now_ns() - t0) / 1e6

    # Warm-up runs, then best-of timed runs; each query returns host arrays.
    for _ in range(max(0, cfg.warmup_iters)):
        idx = engine.query(queries)
    query_ms = float("inf")
    idx = None
    for _ in range(max(1, cfg.timing_iters)):
        t0 = now_ns()
        idx = engine.query(queries)
        query_ms = min(query_ms, (now_ns() - t0) / 1e6)

    recall = None
    if cfg.check_recall:
        sub, dmin = _oracle_for(
            k, m, n, cfg.seed, cfg.recall_check_queries, cfg.clustered,
            cfg.cluster_shape,
        )
        recall = recall_at_1(np.asarray(idx)[sub], queries[sub], refs, oracle_dmin=dmin)

    return RunRecord(
        version=engine.spec.name,
        k=k,
        m=m,
        n=n,
        build_ms=build_ms,
        query_ms=query_ms,
        qps=m / (query_ms / 1e3) if query_ms > 0 else float("inf"),
        recall_at_1=recall,
    )


def run(cfg: BenchConfig, verbose: bool = True, device="cuda") -> list[RunRecord]:
    if torch.device(device).type == "cuda":
        # Build every CUDA kernel before anything is timed (the reference's
        # pre-main WarmUP analog, core.cu:1900-1933).
        from nns_tpu_torch.kernels import _cuda

        _cuda.library()
    writer = ReportWriter(cfg.jsonl_path)
    try:
        for version in cfg.versions:
            for k, m, n in cfg.grid:
                rec = run_one(version, k, m, n, cfg, device)
                writer.add(rec)
                if verbose:
                    print(
                        f"[nns-tpu-torch] {rec.version:<24} k={k:<3} m={m:<6} n={n:<8} "
                        f"build={rec.build_ms:9.2f}ms query={rec.query_ms:9.2f}ms "
                        f"qps={rec.qps:12.1f} recall={rec.recall_at_1} {rec.note}",
                        flush=True,
                    )
    finally:
        writer.close()
    return writer.records


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="nns_tpu_torch.harness",
        description="Run NNS versions over the benchmark grid (main.cu analog).",
    )
    p.add_argument("--versions", default="all", help="comma-separated version ids/names, or 'all'")
    p.add_argument("--grid", default="reference", choices=["reference", "small"])
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--no-recall", action="store_true", help="skip oracle recall check")
    p.add_argument(
        "--clustered", action="store_true",
        help="clustered Gaussian-mixture reference points (BASELINE config 5 domain)",
    )
    p.add_argument("--cluster-sigma", type=float, default=None,
                   help="blob sigma (default 0.01; clustered only)")
    p.add_argument("--cluster-count", type=int, default=None,
                   help="blob count (default ~sqrt(n)/4; clustered only)")
    p.add_argument("--cluster-anisotropy", type=float, default=None,
                   help="per-axis sigma stretch ratio (clustered only)")
    p.add_argument("--cluster-powerlaw", action="store_true",
                   help="Zipf-like blob populations (clustered only)")
    p.add_argument("--jsonl", default=None, help="append structured records to this JSONL file")
    p.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the whole run (trace.json) to this directory",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device the engines run on (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    if args.versions == "all":
        versions: tuple = tuple(range(15))
    else:
        versions = tuple(
            int(v) if v.strip().isdigit() else v.strip() for v in args.versions.split(",")
        )
    cfg = BenchConfig(
        versions=versions,
        grid=REFERENCE_GRID if args.grid == "reference" else SMALL_GRID,
        seed=args.seed,
        warmup_iters=args.warmup,
        timing_iters=args.iters,
        check_recall=not args.no_recall,
        clustered=args.clustered,
        cluster_shape=tuple(
            (key, val)
            for key, val in (
                ("sigma", args.cluster_sigma),
                ("n_clusters", args.cluster_count),
                ("anisotropy", args.cluster_anisotropy),
                ("powerlaw", True if args.cluster_powerlaw else None),
            )
            if val is not None
        ),
        jsonl_path=args.jsonl,
    )
    profile = contextlib.nullcontext()
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=activities)
    with profile:
        records = run(cfg, device=args.device)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        profile.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    print()
    print(format_table(records))
    bad = [r for r in records if r.recall_at_1 is not None and r.recall_at_1 < 1.0]
    if bad:
        print(f"\nFAIL: {len(bad)} runs below recall@1 = 1.0", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
