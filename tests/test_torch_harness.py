"""The PyTorch port's benchmark harness (``nns_tpu_torch/harness.py``,
``python -m nns_tpu_torch``) against the JAX package's, on CPU torch: the
main.cu-analog protocol (seeded identical data per version, build and query
timed apart, the f64 recall gate, JSONL and table output, the CLI), and its
report writer, a copy of the JAX package's.

Tolerances: every record of a ported version has recall@1 = 1.0, and every
field that is not a time (version, k, m, n, recall, note) equals the JAX
harness's record of the same run (v8 too: one device of the CPU runs its
single-device path, the JAX harness its 8-device virtual mesh)."""

import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import nns_tpu.harness as jharness
import nns_tpu.utils.report as jreport
import nns_tpu_torch.utils.report as preport
from nns_tpu.config import BenchConfig as JBenchConfig
from nns_tpu_torch.api import list_versions
from nns_tpu_torch.config import BenchConfig
from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.harness import SMALL_GRID, main, run, run_one

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_one_records_fields():
    cfg = BenchConfig(check_recall=True, warmup_iters=1, timing_iters=1)
    rec = run_one(4, 3, 16, 1024, cfg, device="cpu")
    assert rec.version == "fused"
    assert rec.recall_at_1 == 1.0
    assert rec.build_ms >= 0 and rec.query_ms > 0 and rec.qps > 0


def test_identical_data_across_versions():
    # The reference reseeds before every version (main.cu:64), so every
    # version sees the same data.
    q1, r1 = make_dataset(3, 8, 256, seed=1000)
    q2, r2 = make_dataset(3, 8, 256, seed=1000)
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(r1, r2)


def test_run_grid(tmp_path):
    jsonl = tmp_path / "runs.jsonl"
    cfg = BenchConfig(versions=(0, 4), grid=((3, 4, 256), (16, 4, 256)), warmup_iters=1,
                      timing_iters=1, jsonl_path=str(jsonl))
    records = run(cfg, verbose=False, device="cpu")
    assert len(records) == 4
    assert all(r.recall_at_1 == 1.0 for r in records)
    lines = jsonl.read_text().splitlines()
    assert [json.loads(line)["version"] for line in lines] == ["cpu_scan"] * 2 + ["fused"] * 2


def test_cli_small(capsys):
    rc = main(["--versions", "0,4", "--grid", "small", "--warmup", "1", "--iters", "1",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fused" in out and "cpu_scan" in out


def test_harness_clustered_distribution():
    cfg = BenchConfig(versions=(12, 14), grid=((3, 64, 4096),), clustered=True,
                      warmup_iters=0, timing_iters=1)
    recs = run(cfg, verbose=False, device="cpu")
    assert len(recs) == 2 and all(r.recall_at_1 == 1.0 for r in recs)


def _fields(rec):
    return (rec.version, rec.k, rec.m, rec.n, rec.recall_at_1, rec.note)


@pytest.mark.parametrize("version", range(15))
def test_records_equal_jax(version):
    kw = dict(versions=(version,), grid=SMALL_GRID, warmup_iters=0, timing_iters=1)
    got = run(BenchConfig(**kw), verbose=False, device="cpu")
    want = jharness.run(JBenchConfig(**kw), verbose=False)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert all(r.recall_at_1 == 1.0 for r in got)


def test_cli_small_grid_every_version(tmp_path):
    # The command a user runs without a card: every version at recall 1.0.
    jsonl = tmp_path / "small.jsonl"
    subprocess.run(
        [sys.executable, "-m", "nns_tpu_torch", "--grid", "small", "--device", "cpu",
         "--jsonl", str(jsonl)],
        cwd=_ROOT, capture_output=True, text=True, timeout=600, check=True)
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(recs) == 15 * len(SMALL_GRID)
    assert sorted({r["version"] for r in recs}) == sorted(s.name for s in list_versions())
    assert all(r["recall_at_1"] == 1.0 for r in recs)


def test_profile_dir_writes_a_trace(tmp_path):
    rc = main(["--versions", "4", "--grid", "small", "--warmup", "0", "--iters", "1",
               "--device", "cpu", "--profile-dir", str(tmp_path)])
    assert rc == 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # The engine's own spans are on the trace.
    assert {"nns.api.build", "nns.api.query"} <= {e.get("name") for e in events}


def _code(module) -> str:
    """The module's syntax tree without its docstring."""
    tree = ast.parse(open(module.__file__).read())
    del tree.body[0]
    return ast.dump(tree)


def test_report_is_the_jax_package_copy():
    assert _code(preport) == _code(jreport)
    recs = [(m.RunRecord("fused", 3, 16, 1024, 0.5, 1.25, 12800.0, 1.0),
             m.RunRecord("sharded", 3, 1, 1024, math.nan, math.nan, math.nan, None, "not ported"))
            for m in (preport, jreport)]
    assert preport.format_table(recs[0]) == jreport.format_table(recs[1])
    assert [r.to_json() for r in recs[0]] == [r.to_json() for r in recs[1]]
