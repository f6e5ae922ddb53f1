"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")

BENCH = spec.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_are_the_contracts():
    assert set(BENCH) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_texts(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME_RE.fullmatch(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME_RE.fullmatch(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT_RE.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in e.get("reduced", []):
            assert NAME_RE.fullmatch(key)


def test_command_paths_and_run_seconds():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert spec.ROOT.joinpath(p).is_dir() and not p.startswith("/") and ".." not in p
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each allowed rs + 60 s,
    # 2 x 90 s of compiling a cell and 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds_metrics_and_layers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry = spec.workload(BENCH, cell)
    assert entry["chips"] in (1, 4)
    config = spec.config(BENCH, entry["config"])
    traffic = spec.traffic(entry["traffic"])
    assert config["name"] == entry["config"]
    spec.distribution(config["refs"]["distribution"]).points
    spec.distribution(traffic["queries"]["distribution"]).points
    e2e = spec.metrics_for(BENCH, cell, "end_to_end")
    layers = spec.metrics_for(BENCH, cell, "per_layer")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layers
    for m in e2e + layers:
        assert callable(spec.reader(m["name"]))
    call, answer = spec.call(traffic["call"]), spec.answer(traffic["answer"])
    assert callable(call.units) and callable(call.make_call)
    assert callable(answer.well_formed) and callable(answer.misses) and callable(answer.control)
    for key in ("rows", "batches_per_call", "pool_batches", "warmup_calls", "check_calls",
                "check_rows"):
        assert isinstance(traffic[key], int) and traffic[key] >= 1
    assert len(call.units(traffic, traffic["pool_batches"], 5)) == traffic["batches_per_call"]


def test_pairs_configs_and_reductions():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {c["config"] for c in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert spec.config(BENCH, c["name"])["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


def test_every_metric_file_has_a_reader_and_an_entry():
    files = {p.stem for p in (spec.PKG / "metrics").glob("*.py")}
    assert files == {m["name"].split(".")[0] for m in METRICS}
