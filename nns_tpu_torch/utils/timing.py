"""Timing on the card: CUDA events around a run of launches.

A PyTorch call returns before the device finishes, so a host clock without
a synchronize measures the enqueue. ``cuda_ms`` records an event before and
after each call on the current stream and synchronizes once at the end.
Where a call's device work is shorter than its host time (a wrapper costs
tens of microseconds of Python), that brackets the host time.
``cuda_device_ms`` queues a sleep kernel ahead of the timed calls, so that
the host enqueues them while the device is busy and each event pair
brackets the call's device work alone. ``now_ns`` and ``synchronize`` time
a region on the host clock (the harness's build and query times): the
region ends in a host copy or in ``synchronize``.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import torch

# Device clock cycles of ``cuda_device_ms``'s sleep kernel: ~3 ms at the
# H100's 1.98 GHz boost, longer than the host takes to enqueue a few
# wrapper calls.
_HOLD_CYCLES = 6_000_000


def _timed(fn, args, iters: int, warmup: int, hold_cycles: int) -> tuple[float, Any]:
    result = None
    for _ in range(warmup):
        result = fn(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    for start, end in events:
        start.record()
        result = fn(*args)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events), result


def cuda_ms(fn: Callable[..., Any], *args: Any, iters: int = 5,
            warmup: int = 1) -> tuple[float, Any]:
    """(median ms over ``iters`` timed calls, last result) of ``fn(*args)``
    on the current CUDA stream, after ``warmup`` untimed calls."""
    return _timed(fn, args, iters, warmup, 0)


def cuda_device_ms(fn: Callable[..., Any], *args: Any, iters: int = 5,
                   warmup: int = 1) -> tuple[float, Any]:
    """As ``cuda_ms``, with the device held busy while the host enqueues
    the timed calls: the device time of each call, without its host time."""
    return _timed(fn, args, iters, warmup, _HOLD_CYCLES)


def now_ns() -> int:
    """Nanosecond host clock (the JAX package's ``utils/timing.now_ns``)."""
    return time.perf_counter_ns()


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU, where every op has finished when it returns)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
