"""Whole runs of the harness on the CPU at a small size: the last line, the
failures without a card, the guard against JAX, and faults planted under
the timed path, which the comparison has to catch."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import run, spec

BENCH = spec.load_benchmark()
SMALL = {"uniform3d-1m": 1 << 16, "uniform16d-1m": 1 << 13}


def _small(cell_name: str, **traffic):
    cell = spec.workload(BENCH, cell_name)
    config = dict(spec.config(BENCH, cell["config"]), n=SMALL[cell["config"]])
    mix = spec.traffic(cell["traffic"])
    rows = 1000 if mix["rows"] >= 10000 else 128
    w = min(mix["batches_per_call"], 2)
    # One checked call: a short window on a loaded host may answer no more.
    mix.update(rows=rows, batches_per_call=w, pool_batches=4 * w, warmup_calls=1,
               check_calls=1, check_rows=min(rows, 40))
    mix.update(traffic)
    return cell, config, mix


def _run(cell_name: str, trace=False, seconds=0.3, **traffic):
    cell, config, mix = _small(cell_name, **traffic)
    return run.run_cell(cell, config, mix, 2 ** 31 + 11, seconds, trace, "cpu",
                        time.perf_counter(),
                        spec.metrics_for(BENCH, cell_name, "end_to_end"),
                        spec.metrics_for(BENCH, cell_name, "per_layer"))


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_last_line_keys_and_a_sound_run(cell):
    result, checks, _ = _run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.metrics_for(BENCH, cell, "end_to_end")}
    for m in result["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert checks["misses"] == {"value": 0, "limit": 0}
    assert json.loads(json.dumps(result)) == result


def test_traced_run_adds_breakdown_and_window():
    result, _, _ = _run("uniform3d-1m.call1024", trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device runs here: of the per-layer metrics only the host's build time reads.
    assert set(result["metrics"]) == {"build_ms"}
    assert result["correct"] is True


def _alter_one_row_per_batch(monkeypatch, rows):
    """The fault: an answer altered where the engines produce it."""
    from nns_tpu_torch.kernels.cell_list import CellListEngine
    from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion

    unstage = CellListEngine._unstage

    def bad_unstage(signed, order, risk):
        idx, ok = unstage(signed, order, risk)
        idx[0] = idx[0] + 1
        return idx, ok

    drain = MXUExpansion._drain_staged

    def bad_drain(self, st):
        idx = drain(self, st)
        idx[::rows] += 1
        return idx

    monkeypatch.setattr(CellListEngine, "_unstage", staticmethod(bad_unstage))
    monkeypatch.setattr(MXUExpansion, "_drain_staged", bad_drain)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    _, _, mix = _small(cell)
    _alter_one_row_per_batch(monkeypatch, mix["rows"])
    result, checks, _ = _run(cell)
    assert result["correct"] is False
    # The first row of every batch of every checked call is compared.
    assert checks["misses"]["value"] >= checks["checked_rows"]["value"] // mix["check_rows"]


@pytest.mark.parametrize("fault", ["last_batch_shifted", "last_row_of_last_batch"])
@pytest.mark.parametrize("cell", ["uniform3d-1m.drain", "uniform16d-1m.drain"])
def test_a_fault_in_the_last_batch_of_each_call_is_not_correct(cell, fault, monkeypatch):
    """A fault at one queue position: the last batch of each call answered
    one row off, or its last row altered alone."""
    from nns_tpu_torch.api import NNEngine

    query_many = NNEngine.query_many

    def bad(self, batches):
        out = query_many(self, batches)
        last = np.array(out[-1])
        if fault == "last_batch_shifted":
            last = np.roll(last, 1)
        else:
            last[-1] = (last[-1] + 1) % SMALL[spec.workload(BENCH, cell)["config"]]
        return out[:-1] + [last]

    monkeypatch.setattr(NNEngine, "query_many", bad)
    _, _, mix = _small(cell)
    result, checks, _ = _run(cell, batches_per_call=8, pool_batches=16)
    assert result["correct"] is False and result["failed"] == 0
    # At least the last row of each checked call.
    calls = checks["checked_rows"]["value"] // (8 * mix["check_rows"])
    assert calls >= 1 and checks["misses"]["value"] >= calls


@pytest.mark.parametrize("cell", ["uniform3d-1m.drain", "uniform16d-1m.call1024"])
def test_half_of_each_batch_left_out_is_not_correct(cell, monkeypatch):
    from nns_tpu_torch.api import NNEngine

    query, query_many = NNEngine.query, NNEngine.query_many
    monkeypatch.setattr(NNEngine, "query", lambda self, q: query(self, q)[: len(q) // 2])
    monkeypatch.setattr(NNEngine, "query_many",
                        lambda self, bs: [a[: len(a) // 2] for a in query_many(self, bs)])
    result, checks, _ = _run(cell)
    assert result["correct"] is False and result["failed"] == result["attempted"]


def test_a_failing_call_ends_the_window_and_is_not_correct(monkeypatch):
    from nns_tpu_torch.api import NNEngine

    calls = []

    def flaky(self, batches):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("planted")
        return [np.zeros(len(b), np.int32) for b in batches]

    monkeypatch.setattr(NNEngine, "query_many", flaky)
    result, _, _ = _run("uniform16d-1m.drain", seconds=30)
    assert result["correct"] is False and result["failed"] > 0


def _cli(args, cwd, env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run([sys.executable, "-m", "portbench", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_command_fails_without_a_card():
    p = _cli(["--workload", "uniform3d-1m.drain", "--seed", "3", "--seconds", "1",
              "--trace", "0"], spec.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_the_command_fails_beside_nothing_but_its_own_files(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "uniform3d-1m.drain", "--seed", "3", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_imports_no_jax():
    code = (
        "import sys, time\n"
        "from portbench import run, spec\n"
        "b = spec.load_benchmark()\n"
        "for name in ('uniform3d-1m.call1024', 'uniform16d-1m.drain'):\n"
        "    c = spec.workload(b, name)\n"
        "    cfg = dict(spec.config(b, c['config']), n=1 << 16)\n"
        "    mix = dict(spec.traffic(c['traffic']), rows=128, batches_per_call=1,\n"
        "               pool_batches=2, warmup_calls=1, check_calls=1, check_rows=128,\n"
        "               call='query')\n"
        "    r, _, _ = run.run_cell(c, cfg, mix, 5, 0.2, True, 'cpu', time.perf_counter(),\n"
        "                          [], [])\n"
        "    assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "nns_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "nns_tpu"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["nns_tpu_torch", "nns_tpu_torch.api", "jaxtyping"]) == []
    assert run.forbidden_modules(["nns_tpu.api", "jax._src", "flax", "numpy"]) == [
        "flax", "jax", "nns_tpu"]


def _sample(seed, calls=3, w=5, rows=100, per_batch=10):
    mix = {"check_calls": calls, "batches_per_call": w, "rows": rows, "check_rows": per_batch}
    s = run.Sample(mix, seed)
    for j in range(1000):
        s.offer([j * w + b for b in range(w)], [np.arange(rows) + 1000 * (j * w + b)
                                                 for b in range(w)])
    return s


def test_sample_checks_every_queue_position_and_is_drawn_from_the_seed():
    s = _sample(2 ** 33 + 1)
    assert len(s.kept) == 3 and s.due == 3 * 5 * 10
    assert len(s.rows) == 5
    for r in s.rows:
        assert len(r) == 10 and r[0] == 0 and r[-1] == 99 and len(set(r)) == 10
    pool = [np.arange(100) + 1000 * u for u in range(5000)]
    for units, answers in s.kept:
        assert units == list(range(units[0], units[0] + 5))
        # The kept answers are the checked rows of every position, in order.
        assert np.array_equal(answers, s.queries(pool, units))
    other = _sample(2 ** 33 + 1)
    assert [u for u, _ in s.kept] == [u for u, _ in other.kept]
    assert all(np.array_equal(a, b) for a, b in zip(s.rows, other.rows))
    assert [u for u, _ in _sample(7).kept] != [u for u, _ in s.kept]
    assert np.array_equal(run.Sample({"check_calls": 1, "batches_per_call": 1, "rows": 8,
                                      "check_rows": 8}, 3).rows[0], np.arange(8))


def test_sample_draws_calls_uniformly():
    counts = np.zeros(1000)
    for seed in range(300):
        for units, _ in _sample(seed, w=1).kept:
            counts[units[0]] += 1
    assert counts[:500].sum() == pytest.approx(counts[500:].sum(), rel=0.2)


def test_pool_is_the_seeds_and_the_refs_are_make_datasets():
    from nns_tpu_torch.data import make_dataset

    _, config, mix = _small("uniform3d-1m.drain")
    pool = run.query_pool(config, mix, 41)
    assert len(pool) == mix["pool_batches"] and pool[0].shape == (mix["rows"], 3)
    assert all(b.dtype == np.float32 and b.flags.c_contiguous for b in pool)
    assert all(np.array_equal(a, b) for a, b in zip(pool, run.query_pool(config, mix, 41)))
    assert not np.array_equal(pool[0], run.query_pool(config, mix, 42)[0])
    refs = spec.distribution("uniform").points(config["n"], 3, 40, config["refs"])
    assert np.array_equal(refs, make_dataset(3, 1, config["n"], 40)[1])
