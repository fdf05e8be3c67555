"""The device trace of a run's profiled segment: ``torch.profiler`` around
a few served steps, read into the kernels that ran, the seconds in which
any operation ran on the card, and where the card sat idle.

The segment is fenced as ``chip_smoke.py``'s ``device_trace`` fences its
blocks: a profiler session loses device events near either end, so the
session starts with idle host time and a burst of tiny kernels before the
segment, and ends with another burst and idle time after it; only events
inside the segment's host interval are kept. Host and device times share
one base: a ``record_function`` mark taken at a known ``time.monotonic``
instant gives the offset of the profiler's clock, so device intervals
line up with the engine's spans (which a ``TraceRecorder`` on a
``WallClock``, time.monotonic, stamps).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

EDGE_S = 0.05


@dataclass
class DeviceTrace:
    t0: float                                   # segment start, time.monotonic
    t1: float                                   # segment end
    events: list = field(default_factory=list)  # (name, start, seconds), inside [t0, t1]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        segment."""
        spans = sorted((max(s, self.t0), min(s + d, self.t1)) for _, s, d in self.events)
        out: list[list[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def kernel_seconds(self, pattern) -> tuple[float, int]:
        """(summed seconds, launches) of the events whose name matches the
        compiled regex ``pattern``."""
        hits = [d for n, _, d in self.events if pattern.search(n)]
        return sum(hits), len(hits)


def _burst(torch) -> None:
    x = torch.zeros(1, device="cuda")
    for _ in range(1_000):
        x.add_(1.0)


def profile_segment(torch, run_steps) -> DeviceTrace:
    """Run ``run_steps()`` under torch.profiler; its device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        _burst(torch)
        torch.cuda.synchronize()
        with record_function("portbench_clock_mark"):
            t_mark = time.monotonic()
        t0 = time.monotonic()
        run_steps()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        _burst(torch)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == "portbench_clock_mark"]
    if not marks:
        raise RuntimeError("device trace: the clock mark is not in the profiler's events")
    offset = marks[0].start_ns() / 1e9 - t_mark
    out = DeviceTrace(t0, t1)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns() / 1e9 - offset
        d = e.duration_ns() / 1e9
        if s + d > t0 and s < t1:
            out.events.append((e.name(), s, d))
    return out


def breakdown(trace: DeviceTrace, spans, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and
    the idle time of the card summed by the innermost engine span open at
    each gap's middle ("between spans" where none was)."""
    by_name: dict[str, float] = {}
    for n, _, d in trace.events:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    opened = [(sp.t0, sp.t0 + (sp.dur_ms or 0.0) / 1e3, sp.stage) for sp in spans]
    idle: dict[str, float] = {}
    for a, b in trace.idle_gaps():
        mid = (a + b) / 2
        inner = [(e - s, st) for s, e, st in opened if s <= mid <= e]
        name = min(inner)[1] if inner else "between spans"
        idle[name] = idle.get(name, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
