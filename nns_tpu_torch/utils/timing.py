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
region ends in a host copy or in ``synchronize``. ``Timer``, ``warmup`` and
``time_callable`` are the JAX package's (``nns_tpu/utils/timing.py``): where
it blocks until a result is ready, they synchronize the CUDA devices that
hold the result's tensors (a CPU tensor has finished when it returns).
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


def _wait(result: Any) -> None:
    """Wait for the CUDA devices that hold the tensors of ``result`` (a
    tensor, or a tuple, list or dict of results), as
    ``jax.block_until_ready`` waits for a pytree."""
    if isinstance(result, torch.Tensor):
        synchronize(result.device)
    elif isinstance(result, (tuple, list)):
        for r in result:
            _wait(r)
    elif isinstance(result, dict):
        for r in result.values():
            _wait(r)


class Timer:
    """Context manager measuring wall time in ms, waiting for a result."""

    def __init__(self) -> None:
        self.ms: float = 0.0
        self._result: Any = None

    def __enter__(self) -> "Timer":
        self._start = now_ns()
        return self

    def set_result(self, result: Any) -> Any:
        self._result = result
        return result

    def __exit__(self, *exc: object) -> None:
        if self._result is not None:
            _wait(self._result)
        self.ms = (now_ns() - self._start) / 1e6


def warmup(fn: Callable[..., Any], *args: Any, iters: int = 2) -> None:
    """Run ``fn`` a few times, waiting for each result, so that timed runs
    exclude one-time costs (kernel builds, first launches, staging
    caches)."""
    for _ in range(max(1, iters)):
        _wait(fn(*args))


def time_callable(fn: Callable[..., Any], *args: Any, iters: int = 3,
                  warmup_iters: int = 2) -> tuple[float, Any]:
    """Return (best_ms, last_result) over ``iters`` timed runs after
    warm-up, each run waiting for its result."""
    warmup(fn, *args, iters=warmup_iters)
    best = float("inf")
    result = None
    for _ in range(max(1, iters)):
        start = now_ns()
        result = fn(*args)
        _wait(result)
        best = min(best, (now_ns() - start) / 1e6)
    return best, result
