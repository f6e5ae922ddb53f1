"""Where the time of the 3-D supercell drain, the v9 drain, the beam drain
or the sharded supercell drain goes, on one CUDA device.

Run from the repository root: ``python -m nns_tpu_torch.utils.profile_drain
[--w 16] [--path cells|v9|beam|sharded]``.

``--path cells`` (the default) builds ``CellListEngine`` over bench.py's
workload (1M uniform 3-D refs, seed 1000; W distinct 10K-query batches, the
first make_dataset's, the others drawn in the refs' box) and traces one
``query_queue`` over them as in step 2 below: the served drain, split by
its own spans (``nns.cells.bin``, ``.device``, ``.download``,
``.exact_rows``; the card answers the queue, so no ``.unstage``).

``--path v9`` builds ``NNEngine(9, device="cuda")`` over
bench_k16's workload on 1M refs (16-D uniform, seed 1000), answers W
distinct 10K-query batches once untimed, then:

1. times each step of the first v9 call in the process (CUDA start, the
   kernel library, the engine's staging, the query split, phase 1, the
   whole drain at 1024 x 1M), then the same steps again, to separate the
   process's one-time costs from per-call ones (host clock, synchronized);
2. traces one ``query_many`` over the W batches with ``torch.profiler``
   and prints the wall time, the device time by kernel (top 12), the
   device's busy share and, per program span (``nns.*``,
   ``nns_tpu_torch.utils.spans``), its host time and count.

``--path beam`` builds ``NNEngine(13, device="cuda")`` over 1M clustered
3-D refs (seed 1000) and traces, as in step 2, its ``query_many`` over W
10K batches drawn around the refs (the beam drain, as chip_smoke.py draws
them), then the KD beam index's chunk scan (budget 128) over the same
staged batches.

``--path sharded`` builds ``CellListEngine`` and ``ShardedCellEngine`` on
``Mesh.virtual(4)`` of the one card over 1M uniform 3-D refs (seed 1000)
and traces, as in step 2, each one's ``query_queue`` over the same W 10K
batches drawn in the refs' box, in turns (one device, four shards, four
shards, one device). On one card the four shards show the cost of the
merge, the per-shard launches and the host staging the sharded drain
keeps, not scaling.

It prints the card's name and power limit first, and fails without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=16, help="10K-query batches in the queue")
    ap.add_argument("--path", choices=("cells", "v9", "beam", "sharded"), default="cells")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_drain: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.path == "cells":
        return _cells(args.w)
    if args.path == "beam":
        return _beam(args.w)
    if args.path == "sharded":
        return _sharded(args.w)

    from nns_tpu_torch import NNEngine, nns
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion, _cat_q, phase1, split_bf16x3

    queries, refs = make_dataset(16, 10_000, 1_000_000, 1000)
    rng = np.random.default_rng(1001)
    batches = [queries] + [rng.random((10_000, 16), dtype=np.float32) for _ in range(args.w - 1)]

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"[steps]   {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        return out

    q1k = queries[:1024]
    for i in range(2):
        print(f"[steps] call {i}", flush=True)
        timed("CUDA start", lambda: torch.zeros(1, device="cuda"))
        timed("kernel library", _cuda.library)
        mx = timed("MXUExpansion(1M refs)", lambda: MXUExpansion(refs, device="cuda"))
        st = timed("stage_queries", lambda: mx.stage_queries(q1k))
        qc = timed("split + _cat_q", lambda: _cat_q(*split_bf16x3(st.q_dev)))
        timed("phase1", lambda: phase1(qc, mx.rc, mx.r2h, mx.tile_n, mx.ts, rc_t=mx.rc_t))
        timed("drain (phases 1-2, refine)", lambda: mx._drain_staged(st))
        timed("nns(version=9) one-shot", lambda: nns(q1k, refs, version=9, device="cuda"))
    del mx
    eng = NNEngine(9, device="cuda").build(refs)
    _trace("drain", lambda: eng.query_many(batches), args.w)
    return 0


def _trace(tag: str, fn, w: int) -> None:
    """Run ``fn`` once untimed, then once under torch.profiler: the wall
    time, the device's busy share, the device time by kernel (top 12), the
    host time and count of each program span, each per 10K batch of the W,
    and the traced call's counters (``spans.COUNTS``) that moved."""
    from torch.profiler import ProfilerActivity, profile

    from nns_tpu_torch.utils.spans import COUNTS

    fn()  # warm
    torch.cuda.synchronize()
    before = dict(COUNTS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels and copies): an op's own entry
    # would count its kernels' time again, and a span mirrored onto the
    # device's timeline is no device work.
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
              and not e.is_user_annotation]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] W={w}: wall {wall_ms:.3f} ms ({wall_ms / w:.3f} ms/batch); "
          f"device busy {busy_ms:.3f} ms ({busy_ms / w:.3f} ms/batch, "
          f"{100 * busy_ms / wall_ms:.1f}% of wall)", flush=True)
    for e in events[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3 / w:9.4f} ms/batch  "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    # The program's spans, in order of host time (inclusive of what they hold).
    for e in sorted((e for e in prof.key_averages() if e.key.startswith("nns.")
                     and str(e.device_type).endswith("CPU")), key=lambda e: -e.cpu_time_total):
        print(f"[{tag}]   span {e.key:<22s} {e.cpu_time_total / 1e3 / w:9.4f} ms/batch  "
              f"x{e.count / w:g}/batch", flush=True)
    moved = {name: n - before[name] for name, n in COUNTS.items() if n != before[name]}
    print(f"[{tag}]   counters {moved}", flush=True)


def _cells(w: int) -> int:
    """The 3-D supercell drain on one device, traced."""
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels.cell_list import CellListEngine

    queries, refs = make_dataset(3, 10_000, 1_000_000, 1000)
    rng = np.random.default_rng(1001)
    lo, hi = refs.min(axis=0), refs.max(axis=0)
    batches = [queries] + [(rng.random((10_000, 3), dtype=np.float32) * (hi - lo) + lo)
                           .astype(np.float32) for _ in range(w - 1)]
    eng = CellListEngine(refs, device="cuda")
    _trace("cells", lambda: eng.query_queue(batches), w)
    return 0


def _beam(w: int) -> int:
    """The beam drain (v13) and the KD chunk scan on 1M clustered refs."""
    from nns_tpu_torch import NNEngine
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.trees.kdtree import KDTree

    _, refs = make_dataset(3, 1, 1_000_000, 1000, clustered=True)
    rng = np.random.default_rng(1007)
    batches = [(refs[rng.integers(0, len(refs), 10_000)]
                + rng.normal(0, 0.01, (10_000, 3))).astype(np.float32) for _ in range(w)]
    eng = NNEngine(13, device="cuda").build(refs)
    _trace("beam", lambda: eng.query_many(batches), w)
    kd = KDTree.build(refs).device_index("cuda")
    staged = [kd.stage_queries(b) for b in batches]
    _trace("scan", lambda: [kd.query_staged_with_coverage(st, budget=128) for st in staged], w)
    return 0


def _sharded(w: int) -> int:
    """The 3-D supercell drain on one device and on four virtual shards."""
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels.cell_list import CellListEngine
    from nns_tpu_torch.parallel import Mesh, ShardedCellEngine

    _, refs = make_dataset(3, 1, 1_000_000, 1000)
    rng = np.random.default_rng(1001)
    lo, hi = refs.min(axis=0), refs.max(axis=0)
    batches = [(rng.random((10_000, 3), dtype=np.float32) * (hi - lo) + lo).astype(np.float32)
               for _ in range(w)]
    engines = {"one": CellListEngine(refs, device="cuda"),
               "four": ShardedCellEngine(refs, Mesh.virtual(4, "cuda"))}
    for tag in ("one", "four", "four", "one"):
        _trace(tag, lambda: engines[tag].query_queue(batches), w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
