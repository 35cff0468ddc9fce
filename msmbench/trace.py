"""The traced sub-window of a `--trace 1` run, and what is read from it.

A steady run of calls is run under torch.profiler, inside a span
`msmbench.window`, each call inside `msmbench.call`.  From the trace come the
device's events (kernels, copies, memsets), the host's, and the sub-window's
wall time on the profiler's clock.  The busy time is the union of the
device's intervals; each idle stretch between them is labelled by the
innermost host operation that was running at its middle.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

WINDOW_SPAN = "msmbench.window"
CALL_SPAN = "msmbench.call"
IN_CALL = "python in the call"
BETWEEN_CALLS = "harness between calls"


@dataclasses.dataclass
class Event:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class TraceWindow:
    """What a per-layer metric reads: the device's and the host's events of
    the traced sub-window, its bounds, the MSMs run in it and the work they
    needed, and the facts of the run's set-up."""

    device: list[Event]
    host: list[Event]
    start_us: float
    end_us: float
    msms: int
    nonzero_digits: int
    input_bytes: int
    setup: dict
    #: Host-clock latencies (ms) of the window's calls outside the traced ones.
    window_calls_ms: list = dataclasses.field(default_factory=list)

    @property
    def wall_us(self) -> float:
        return self.end_us - self.start_us

    def device_us(self, include=(), exclude=()) -> tuple[float, int]:
        """Device time and event count of the events whose name matches one
        of the `include` patterns (every event if none) and none of the
        `exclude` ones."""
        inc = [re.compile(p) for p in include]
        exc = [re.compile(p) for p in exclude]
        us, count = 0.0, 0
        for ev in self.device:
            if inc and not any(p.search(ev.name) for p in inc):
                continue
            if any(p.search(ev.name) for p in exc):
                continue
            us += ev.us
            count += 1
        return us, count


def busy_intervals(events: list[Event], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi], in order."""
    out: list[list[float]] = []
    for ev in sorted(events, key=lambda e: e.start_us):
        s, e = max(ev.start_us, lo), min(ev.end_us, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(tw: TraceWindow) -> float:
    return sum(e - s for s, e in busy_intervals(tw.device, tw.start_us, tw.end_us))


def idle_gaps(tw: TraceWindow) -> list[tuple[float, float]]:
    """The stretches of the sub-window in which no device event ran."""
    gaps, t = [], tw.start_us
    for s, e in busy_intervals(tw.device, tw.start_us, tw.end_us):
        if s > t:
            gaps.append((t, s))
        t = e
    if tw.end_us > t:
        gaps.append((t, tw.end_us))
    return gaps


def label_points(host: list[Event], points: list[float]) -> list[str]:
    """For each time, the name of the innermost host event that spans it
    (the host's events of one thread nest): the port's Python between
    operations where only a call's span does, and the harness between calls
    where none does."""
    evs = sorted(host, key=lambda e: (e.start_us, -e.end_us))
    labels = [BETWEEN_CALLS] * len(points)
    stack: list[Event] = []
    k = 0
    for i in sorted(range(len(points)), key=lambda i: points[i]):
        t = points[i]
        while k < len(evs) and evs[k].start_us <= t:
            while stack and stack[-1].end_us <= evs[k].start_us:
                stack.pop()
            stack.append(evs[k])
            k += 1
        while stack and stack[-1].end_us < t:
            stack.pop()
        if stack:
            labels[i] = IN_CALL if stack[-1].name == CALL_SPAN else stack[-1].name
    return labels


def short_name(name: str) -> str:
    """A kernel's name without its argument list (the last parenthesised
    group; template arguments may hold parentheses of their own).  A
    group after a space, as in "Memcpy DtoH (Device -> Pageable)", stays."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i and name[i - 1] != " " else name
                break
    return name[:160]


def breakdown(tw: TraceWindow, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle time by
    what the host was doing, each as [name, seconds], at most `top` each."""
    ops: dict[str, float] = defaultdict(float)
    for ev in tw.device:
        ops[short_name(ev.name)] += ev.us / 1e6
    gaps = idle_gaps(tw)
    labels = label_points(tw.host, [(s + e) / 2 for s, e in gaps])
    idle: dict[str, float] = defaultdict(float)
    for (s, e), lab in zip(gaps, labels):
        idle[lab] += (e - s) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def from_profiler(prof, msms: int, nonzero_digits: int, input_bytes: int,
                  setup: dict) -> TraceWindow:
    """The TraceWindow of a torch.profiler run whose calls ran inside one
    `msmbench.window` span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window, thread = [], [], None, None
    for ev in prof.events():
        e = Event(ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == cuda:
            # The profiler also copies each record_function span to the
            # device's timeline as an annotation; it is no device work.
            if ev.name not in (WINDOW_SPAN, CALL_SPAN):
                device.append(e)
        else:
            host.append((ev.thread, e))
            if ev.name == WINDOW_SPAN:
                window, thread = e, ev.thread
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    host_events = [e for th, e in host if th == thread and e.name != WINDOW_SPAN
                   and window.start_us <= e.start_us <= window.end_us]
    device = [e for e in device if e.end_us > window.start_us and e.start_us < window.end_us]
    return TraceWindow(device, host_events, window.start_us, window.end_us, msms,
                       nonzero_digits, input_bytes, setup)
