"""The harness on the card: a short run of each cell through the command,
each cell with every fault planted, and the control on the card. They skip
without a CUDA device (the fixture decides); run them on a card with

    python -m pytest portbench/tests/test_portbench_gpu.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, run, spec

pytestmark = pytest.mark.gpu
BENCH = spec.load_benchmark()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(cuda, cell, trace):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed",
                        str(2 ** 31 + 3), "--seconds", "2", "--trace", str(trace)],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    names = {m["name"] for m in spec.metrics_for(BENCH, cell, "per_layer" if trace
                                                  else "end_to_end")}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_fault_planted_is_not_correct_on_the_card(cuda, cell, monkeypatch):
    """One in-process run of the cell on the card at its configuration's
    ``cpu_n`` refs, a 2-second window, with every fault planted."""
    entry = spec.workload(BENCH, cell)
    config = spec.config(BENCH, entry["config"])
    config["n"] = config["cpu_n"]
    traffic = spec.traffic(entry["traffic"])
    fired = {name: fault.plant(monkeypatch.setattr, traffic["rows"])
             for name, fault in spec.faults().items()}
    result, checks, _ = run.run_cell(entry, config, traffic, 2 ** 31 + 7, 2.0, False, cuda,
                                     time.perf_counter(),
                                     spec.metrics_for(BENCH, cell, "end_to_end"), [])
    assert sum(f["fired"] for f in fired.values()) > 0, fired
    assert result["correct"] is False and result["failed"] == 0, (checks, fired)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_the_control_misses_on_the_card(cuda, config):
    cfg = spec.config(BENCH, config)
    cfg["n"] = min(cfg["n"], 1 << 18)
    mix = dict(spec.traffic("drain-w8"), check_calls=1)
    misses, rows = control.control_misses(cfg, mix, 2 ** 31 + 5, cuda)
    assert rows == mix["batches_per_call"] * mix["check_rows"] and misses > 0
