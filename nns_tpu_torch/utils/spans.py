"""The serving paths' spans and counters.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler runs, so each span lands on the profiler's trace, on the clock of
the device's kernels and copies, nested on the caller's thread. With no
profiler it returns one shared no-op: no range is built and no profiler op
is called. Span names start with ``nns.``: ``nns.api.*`` (``NNEngine``),
``nns.cells.*`` (the v14 supercell engine), ``nns.mxu.*`` (the v9
expansion engine).

``COUNTS`` holds plain counters that are always on, in the style of
``kernels._cuda.LAUNCHES``: each is added to where its work happens, from a
value the code already holds (no device sync, no pass over the rows).

- ``cells.rows``, ``cells.certified_rows``: rows the v14 engine answered,
  and rows its certificate proved;
- ``cells.device_staged_rows``: rows of the v14 queue drain binned on the
  device and scanned (a batch too skewed for the scan is not);
- ``cells.device_checked_rows``: rows of the v14 queue drain whose
  finiteness ``bin_queue`` checked in the pass that bins them (every row
  of the queue; ``NNEngine.query_many`` makes no host pass over them);
- ``cells.device_answered_rows``: rows of the v14 queue drain on a CUDA
  device answered by ``cell_answer`` (decoded, or listed for the exact
  fallback), not by the host tail;
- ``cells.exact_calls``: exact fused calls the v14 engine makes for its
  uncertified rows (one per batch on the host paths, one per queue in
  the drain on a CUDA device);
- ``mxu.rows``, ``mxu.certified_rows``: rows of the v9 drain, and rows
  phase 2's certificate proved;
- ``copy.bytes_up``, ``copy.bytes_down``: bytes of the explicit copies
  between the host and a CUDA device on those paths (0 on a CPU device).
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()

COUNTS: dict[str, int] = {
    "cells.rows": 0, "cells.certified_rows": 0, "cells.device_staged_rows": 0,
    "cells.device_checked_rows": 0, "cells.device_answered_rows": 0, "cells.exact_calls": 0,
    "mxu.rows": 0, "mxu.certified_rows": 0,
    "copy.bytes_up": 0, "copy.bytes_down": 0,
}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else the
    shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count_copy(direction: str, nbytes: int, device: torch.device) -> None:
    """Add ``nbytes`` to ``copy.bytes_<direction>`` (``up`` or ``down``)
    when ``device`` is a CUDA device."""
    if device.type == "cuda":
        COUNTS["copy.bytes_" + direction] += nbytes
