"""A deployment joins the benchmark by new files and new entries alone: in a
copy of the benchmark, a new configuration and a cell of it on a mix the
benchmark has pass the copy's own spec tests and its sound-run and
altered-answer cases, with no file of the copy changed but the entries
added to ``BENCHMARK.json``."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import spec

BENCH = spec.load_benchmark()
CONFIG = "uniform8d-1m"
CELL = f"{CONFIG}.call1024"


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _joined(bench: dict) -> dict:
    """``bench`` with the new configuration and its cell appended, and the
    cell appended to the lists of the per-layer metrics that the calls of a
    mix report."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({
        "name": CONFIG, "source": "https://github.com/sty-hhh/NNS-CUDA/blob/main/main.cu",
        "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
        "why": "2^20 uniform 8-D refs: NNEngine auto serves them with v9 at its least k"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "call1024", "chips": 1,
        "why": "closed loop, one query of 1024 uniform 8-D queries per call: v9 at small m"})
    for m in bench["per_layer"]:
        if m["moves"] == "call_p95_ms" and "workloads" in m:
            m["workloads"].append(CELL)
    return bench


def test_a_deployment_joins_by_new_files_alone(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    config = dict(spec.config(BENCH, "uniform16d-1m"), name=CONFIG, k=8, cpu_n=4096)
    (tmp_path / "portbench" / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_joined(BENCH), indent=1))
    after = _digests(tmp_path)
    assert {f: d for f, d in after.items() if f in before and f != "BENCHMARK.json"} == {
        f: d for f, d in before.items() if f != "BENCHMARK.json"}
    assert set(after) - set(before) == {f"portbench/configs/{CONFIG}.json"}

    tests = "portbench/tests/"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(spec.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         tests + "test_portbench_spec.py",
         f"{tests}test_portbench_run.py::test_last_line_keys_and_a_sound_run[{CELL}]",
         f"{tests}test_portbench_run.py::test_an_altered_answer_is_not_correct[{CELL}]"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    # The copy's node ids name the new cell: had the repository's own
    # benchmark been loaded, pytest would have found no such test.
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
