"""Timing on the card: CUDA events around a run of launches.

A PyTorch call returns before the device finishes, so a host clock without
a synchronize measures the enqueue. ``cuda_ms`` records an event before and
after each call on the current stream and synchronizes once at the end.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable

import torch


def cuda_ms(fn: Callable[..., Any], *args: Any, iters: int = 5,
            warmup: int = 1) -> tuple[float, Any]:
    """(median ms over ``iters`` timed calls, last result) of ``fn(*args)``
    on the current CUDA stream, after ``warmup`` untimed calls."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        result = fn(*args)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events), result
