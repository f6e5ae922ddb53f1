"""The traced window: ``torch.profiler`` events reduced to what the
per-layer readers need.

``collect`` takes the profiler's raw events: the window is the harness's
``portbench.window`` range on the host; device operations are the events
on the device's timeline that are no user annotation: kernels, copies and
sets. They are chosen by the event's kind and never by name, so that the
host ranges the profiler mirrors onto the device's timeline
(``record_function`` spans, the program's or the harness's) never count. ``summarize`` does the arithmetic on plain
tuples, so that tests can hand it synthetic events: the device's busy time is the
union of the operations' intervals inside the window (overlapping streams
count once), and each idle gap inside the window is named by the innermost
host operation on the window's thread at the gap's midpoint.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW = "portbench.window"
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_ns: tuple[int, int]
    ops: list[tuple[str, int, int]]  # device operations starting in the window
    busy_ns: int
    gaps: list[tuple[str, int]]  # (host operation, idle ns) per gap

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def device_s(self, part: str) -> float:
        """Summed device time of the operations whose name holds ``part``."""
        return sum(e - s for name, s, e in self.ops if part in name) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops, idle = defaultdict(int), defaultdict(int)
        for name, s, e in self.ops:
            ops[name[:NAME_CHARS]] += e - s
        for name, ns in self.gaps:
            idle[name[:NAME_CHARS]] += ns
        return {key: [[name, ns / 1e9] for name, ns in
                      sorted(table.items(), key=lambda kv: -kv[1])[:top]]
                for key, table in (("device_ops", ops), ("idle_gaps", idle))}


def union(intervals, t0: int, t1: int) -> tuple[int, list[tuple[int, int]]]:
    """Busy time of ``intervals`` [(start, end)] clipped to [t0, t1], and
    the idle gaps [(start, end)] between them inside [t0, t1]."""
    busy, gaps, cursor = 0, [], t0
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s or e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            busy += e - s
        else:
            busy += e - cursor
        cursor = e
    if cursor < t1:
        gaps.append((cursor, t1))
    return busy, gaps


def innermost(host, points):
    """For each of ``points`` (sorted), the name of the innermost host
    range [(name, start, end)] (properly nested, one thread) holding it,
    or None."""
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    names, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        names.append(stack[-1][0] if stack else None)
    return names


def summarize(window: tuple[int, int], device, host) -> Trace:
    """``device`` [(name, start, end)] operations, ``host`` [(name, start,
    end)] ranges of the window's thread, all in ns."""
    t0, t1 = window
    ops = [d for d in device if t0 <= d[1] < t1]
    busy, gaps = union([(s, e) for _, s, e in ops], t0, t1)
    names = innermost(host, [(s + e) // 2 for s, e in gaps])
    return Trace(window, ops, busy,
                 [(name or WINDOW, e - s) for name, (s, e) in zip(names, gaps)])


def _on_host(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def is_device_op(e) -> bool:
    """Whether the profiler event ``e`` is a kernel, copy or set the card
    ran, and not a host range mirrored onto the device's timeline."""
    return not _on_host(e) and not e.is_user_annotation()


def from_events(events) -> Trace:
    """The ``Trace`` of the profiler's raw events."""
    window, tid, device, host = None, None, [], []
    for e in events:
        if e.name() == WINDOW and _on_host(e):
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
            tid = e.start_thread_id()
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    for e in events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if is_device_op(e):
            device.append(span)
        elif _on_host(e) and e.start_thread_id() == tid:
            host.append(span)
    return summarize(window, device, host)


def collect(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    return from_events(prof.profiler.kineto_results.events())
