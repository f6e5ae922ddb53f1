"""The harness on the card: a short run of each cell through the command,
and the control on the card. They skip without a CUDA device (the fixture
decides); run them on a card with

    python -m pytest portbench/tests/test_portbench_gpu.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import control, spec

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


@pytest.mark.parametrize("config", ["uniform3d-1m", "uniform16d-1m"])
def test_the_control_misses_on_the_card(cuda, config):
    cfg = dict(spec.config(BENCH, config), n=1 << 18)
    mix = dict(spec.traffic("drain-w8"), check_calls=1)
    misses, rows = control.control_misses(cfg, mix, 2 ** 31 + 5, cuda)
    assert rows == mix["batches_per_call"] * mix["check_rows"] and misses > 0
