"""The control of ``correct``: the plain reference put in the program's
place one precision lower (TF32, ``reference.control_min_idx``), held to
the same comparison as a run's answers, on a sample of the cell's shape
(``run.Sample``: as many calls, and as many rows of every batch in each,
as a run of the cell compares). Its misses are the upper reading of the
limit on ``misses``; the benchmark's own runs never run it.

    python -m portbench.control --workload <name> --seeds 1 2 3 [--device cuda]

One JSON line per seed: the misses, the rows compared and the seconds.
"""

from __future__ import annotations

import argparse
import json
import time

from portbench import spec
from portbench.run import Sample, query_pool


def control_misses(config: dict, traffic: dict, seed: int, device) -> tuple[int, int]:
    """(misses, rows compared) of the control on ``traffic["check_calls"]``
    calls of the mix, drawn from the seed, and the sample's rows of each."""
    refs = spec.distribution(config["refs"]["distribution"]).points(
        config["n"], config["k"], seed, config["refs"])
    pool = query_pool(config, traffic, seed)
    answer, call = spec.answer(traffic["answer"]), spec.call(traffic["call"])
    sample = Sample(traffic, seed)
    misses = rows = 0
    for _ in range(sample.size):
        units = call.units(traffic, len(pool), int(sample.rng.integers(0, 1 << 30)))
        queries = sample.queries(pool, units)
        misses += answer.misses(queries, refs, answer.control(queries, refs, device), device)
        rows += len(queries)
    return misses, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for seed in args.seeds:
        t = time.perf_counter()
        misses, rows = control_misses(config, traffic, seed, args.device)
        print(json.dumps({"workload": cell["name"], "seed": seed, "control_misses": misses,
                          "checked_rows": rows, "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
