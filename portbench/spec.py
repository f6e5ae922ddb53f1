"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (``workloads`` entry) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``traffic/<traffic>.json``. A
configuration's ``refs`` and a mix's ``queries`` name a point distribution,
``distributions/<name>.py``; a mix's ``call`` names what one call of the
window is, ``calls/<call>.py``, and its ``answer`` how an answer is judged,
``answers/<answer>.py``. Every metric, end-to-end or per-layer, is read
by ``metrics/<name>.py``'s ``read(run)``; a metric named ``<name>.<part>``
(one quantity split by the end-to-end metric it moves) by the same file.
A metric applies to the cells its ``workloads`` key lists, or to every
cell without one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"known: {[c['name'] for c in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(ROOT / entry["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metric entries that apply
    to the cell ``cell_name``."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def _load(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable[[Any], float | None]:
    """The ``read`` of ``metrics/<name>.py`` for ``metric`` = ``<name>`` or
    ``<name>.<part>``: a run record to a number, or None where the run
    holds nothing to read."""
    name = metric.split(".")[0]
    return _load(PKG / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def call(name: str):
    """``calls/<name>.py``: its ``units(traffic, pool_size, j)``, the pool
    indices of the j-th call's batches, and ``make_call(engine, traffic,
    pool)``, whose ``call(j)`` returns (those indices, one answer each)."""
    return _load(PKG / "calls" / f"{name}.py", f"portbench_call_{name}")


def answer(name: str):
    """``answers/<name>.py``: its ``well_formed(answer, rows)``,
    ``misses(queries, refs, answer, device)`` against the plain reference,
    and ``control(queries, refs, device)``, the control's answers."""
    return _load(PKG / "answers" / f"{name}.py", f"portbench_answer_{name}")


def distribution(name: str):
    """``distributions/<name>.py``: its ``points(count, k, seed, params)``."""
    return _load(PKG / "distributions" / f"{name}.py", f"portbench_dist_{name}")
