"""Structured run reporting (SURVEY.md §5 "metrics/logging"). A copy of
``nns_tpu/utils/report.py`` (its code pinned equal by
tests/test_torch_harness.py).

The reference prints one line per (version, config): `CudaCall v, k, m, n, ms`
(main.cu:76) plus separate tree build-time lines (core.cu:1158-1159 etc.).
Here every run is a structured record — version, config, build/query split,
throughput, recall — written as JSONL and pretty-printed as a table.
"""

from __future__ import annotations

import dataclasses
import json
from typing import IO, Iterable


@dataclasses.dataclass
class RunRecord:
    version: str
    k: int
    m: int
    n: int
    build_ms: float
    query_ms: float
    qps: float
    recall_at_1: float | None = None
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class ReportWriter:
    """Accumulates records; optionally streams them to a JSONL file."""

    def __init__(self, jsonl_path: str | None = None) -> None:
        self.records: list[RunRecord] = []
        self._fh: IO[str] | None = open(jsonl_path, "a") if jsonl_path else None

    def add(self, record: RunRecord) -> None:
        self.records.append(record)
        if self._fh is not None:
            self._fh.write(record.to_json() + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def format_table(records: Iterable[RunRecord]) -> str:
    header = f"{'version':<12} {'k':>3} {'m':>6} {'n':>9} {'build_ms':>10} {'query_ms':>10} {'qps':>12} {'recall':>7} note"
    lines = [header, "-" * len(header)]
    for r in records:
        recall = "-" if r.recall_at_1 is None else f"{r.recall_at_1:.4f}"
        lines.append(
            f"{r.version:<12} {r.k:>3} {r.m:>6} {r.n:>9} {r.build_ms:>10.3f} "
            f"{r.query_ms:>10.3f} {r.qps:>12.1f} {recall:>7} {r.note}"
        )
    return "\n".join(lines)
