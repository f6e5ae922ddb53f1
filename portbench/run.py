"""One run of one cell: set-up, a measured window, the check of its answers.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up: the kernel library (built into the checkout's
``nns_tpu_torch/_build/`` by its first run), the refs from ``--seed`` and
the cell's query pool from ``--seed + 1``, one build of
``NNEngine(version, device="cuda")``, and the mix's warm-up calls through
the entry the window uses. A traced run builds three times more, timed,
and serves the last (``build_ms``). The window is a closed loop with one
client: calls back to back, each timed from its start to numpy answers on
the host, until ``--seconds`` have passed. What one call is comes from
the mix's ``calls/<call>.py``. With ``--trace 1`` the window runs under
``torch.profiler`` and the cell's per-layer metrics are reported; else
its end-to-end metrics.

After the window, with the program's state freed, a sample drawn from the
seed is held against the plain float64 reference through the mix's
``answers/<answer>.py``: calls drawn among those the window answered, and
of each, rows of every batch in the call, its first and last row among
them (``Sample``). The last lines on standard error give each number
compared beside its limit; the last line on standard output is the
result, as JSON.

The run fails, printing no result, without a CUDA device for each chip
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or ``nns_tpu``
has been imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any

import numpy as np

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "nns_tpu")
CACHE = spec.ROOT / ".portbench_cache"
# The calls and rows compared with the reference come from this stream of
# the seed.
SAMPLE_STREAM = 0x5EED
# Timed builds of a traced run, after the first; build_ms is their median.
BUILDS = 3


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/*.py``)."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    build_ms: list = dataclasses.field(default_factory=list)
    calls: int = 0  # calls answered in the window
    queries: int = 0  # queries answered in the window
    units: int = 0  # batches answered in the window
    window_s: float = 0.0
    call_s: list = dataclasses.field(default_factory=list)
    trace: Any = None  # portbench.trace.Trace of a traced window


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that the
    run must not hold, compared whole (``nns_tpu_torch`` is not
    ``nns_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def query_pool(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """The mix's batches, (rows, k) float32 each, from ``seed + 1``."""
    dist = traffic["queries"]
    rows, count = traffic["rows"], traffic["pool_batches"]
    pts = spec.distribution(dist["distribution"]).points(
        rows * count, config["k"], seed + 1, dist)
    return [pts[i * rows:(i + 1) * rows] for i in range(count)]


def check_rows(rows: int, count: int, rng) -> np.ndarray:
    """``count`` row indices of a batch of ``rows``, sorted: the first and
    the last row and others drawn from ``rng``; every row where ``count``
    reaches ``rows``."""
    if count >= rows:
        return np.arange(rows)
    inner = rng.choice(np.arange(1, rows - 1), size=max(count - 2, 0), replace=False)
    return np.sort(np.concatenate([[0, rows - 1], inner])).astype(np.int64)


class Sample:
    """What is held against the reference: ``check_calls`` calls drawn
    uniformly (a reservoir) from those offered, and of each,
    ``check_rows`` rows of every batch in it, so that every queue position
    of a call is checked. The rows of each position are drawn once per run;
    all draws come from the seed."""

    def __init__(self, traffic: dict, seed: int):
        self.size = traffic["check_calls"]
        self.rng = np.random.default_rng([seed, SAMPLE_STREAM])
        self.rows = [check_rows(traffic["rows"], traffic["check_rows"], self.rng)
                     for _ in range(traffic["batches_per_call"])]
        self.seen, self.kept = 0, []

    @property
    def due(self) -> int:
        """Rows that a full sample compares."""
        return self.size * sum(len(r) for r in self.rows)

    def offer(self, units, answers) -> None:
        """A call's pool indices and answers, in queue order."""
        if len(self.kept) < self.size:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot < self.size:
            self.kept[slot] = (list(units), np.concatenate(
                [np.asarray(a)[r] for a, r in zip(answers, self.rows)]))

    def queries(self, pool: list[np.ndarray], units) -> np.ndarray:
        """The checked rows of a call over ``units``, in the order of its
        kept answers."""
        return np.concatenate([pool[u][r] for u, r in zip(units, self.rows)])


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, end_to_end: list[dict],
             per_layer: list[dict]) -> tuple[dict, dict, dict]:
    """One run. Returns (result line, checks, notes for standard error)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from nns_tpu_torch.api import NNEngine
    from portbench import trace as trace_mod

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    notes: dict[str, Any] = {}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def clock(label, fn):
        t = time.perf_counter()
        out = fn()
        sync()
        notes[label] = time.perf_counter() - t
        return out

    if on_card:
        from nns_tpu_torch.kernels import _cuda

        before = time.time()
        path = clock("library_s", lambda: (_cuda.build(), _cuda.library())[0])
        notes["library_built"] = os.path.getmtime(path) >= int(before)
    refs = clock("refs_s", lambda: spec.distribution(config["refs"]["distribution"]).points(
        config["n"], config["k"], seed, config["refs"]))
    pool = clock("pool_s", lambda: query_pool(config, traffic, seed))

    run = Run(config, traffic)

    def build():
        t = time.perf_counter()
        e = NNEngine(config["version"], device=device).build(refs)
        sync()
        return e, (time.perf_counter() - t) * 1e3

    engine, notes["first_build_ms"] = build()
    for _ in range(BUILDS if trace else 0):
        engine = None
        engine, ms = build()
        run.build_ms.append(ms)
    if run.build_ms:
        notes["build_ms"] = run.build_ms
    notes["engine"] = engine.spec.name
    answer = spec.answer(traffic["answer"])
    call = spec.call(traffic["call"]).make_call(engine, traffic, pool)
    rows, w = traffic["rows"], traffic["batches_per_call"]
    t = time.perf_counter()
    for j in range(traffic["warmup_calls"]):
        call(j)
    j = traffic["warmup_calls"]
    sync()
    notes["warmup_s"] = time.perf_counter() - t

    sample = Sample(traffic, seed)
    attempted = failed = 0
    entry = f"api.{traffic['call']}"
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_card else []))
    run.setup_s = time.perf_counter() - t0
    with prof if prof is not None else contextlib.nullcontext():
        with record_function(trace_mod.WINDOW):
            tw0 = time.perf_counter()
            while True:
                attempted += rows * w
                c0 = time.perf_counter()
                try:
                    with record_function(entry):
                        units, answers = call(j)
                except Exception:  # a failing engine ends the window; the run is not correct
                    traceback.print_exc()
                    failed += rows * w
                    break
                c1 = time.perf_counter()
                j += 1
                run.call_s.append(c1 - c0)
                run.calls += 1
                good = sum(answer.well_formed(a, rows) for a in answers[:len(units)])
                failed += rows * (w - good)
                if good == w:
                    sample.offer(units, answers)
                run.units += good
                run.queries += rows * good
                if c1 - tw0 >= seconds:
                    break
            sync()
            run.window_s = time.perf_counter() - tw0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        notes["power_limit_w"] = _power_limit_w()

    if prof is not None:
        run.trace = clock("trace_s", lambda: trace_mod.collect(prof))
    metrics = {}
    for m in per_layer if trace else end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The reference runs on the card after the program's state is freed.
    call = engine = prof = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    misses = sum(answer.misses(sample.queries(pool, units), refs, a, dev)
                 for units, a in sample.kept)
    notes["reference_s"] = time.perf_counter() - t
    checked = sum(len(a) for _, a in sample.kept)
    checks = {
        "misses": {"value": misses, "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "checked_rows": {"value": checked, "limit": sample.due},
    }
    correct = misses == 0 and failed == 0 and checked >= sample.due

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": cell["chips"],
        "memory_peak_bytes": peak,
        "power_limit_w": notes.get("power_limit_w"),
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    notes.update(calls=run.calls, queries=run.queries, window_s=run.window_s,
                 setup_s=run.setup_s)
    result["checks"] = checks
    return result, checks, notes


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    _cache_dirs()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    result, checks, notes = run_cell(
        cell, config, traffic, args.seed, args.seconds, bool(args.trace), "cuda", t0,
        spec.metrics_for(bench, cell["name"], "end_to_end"),
        spec.metrics_for(bench, cell["name"], "per_layer"))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 1
    for key, value in notes.items():
        print(f"portbench: {key} {value}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"({'at least' if name == 'checked_rows' else 'at most'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
