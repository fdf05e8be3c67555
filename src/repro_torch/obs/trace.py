"""Deterministic per-lookup/per-insert tracing on the injectable Clock.

``TraceRecorder`` produces nested spans whose start/duration come from
the same ``Clock`` that charges all simulated latency, so a trace taken
under ``SimClock`` is bit-reproducible run-to-run and CI can gate on
exact span accounting.  The same recorder carries a structured event
stream (faults, failovers, write-behind, migrations, rebalances,
evictions, retries) and feeds the stage/category/shard histogram set
on every span close.

Device spans (``device_span``) time work on the card: a timing event
recorded on the current stream when the span opens and one when it
closes, nothing else. They resolve onto the recorder's own clock at the
next ``sync_point()``, which a caller makes right after a device→host
copy it already makes: the stream is drained there, so one anchor event
recorded at a known ``clock.now()`` places every pending event, and the
card's timer is re-anchored at every sync and never drifts from the
clock. A device span is marked ``on="device"``; its parent is the
innermost open host span and it is never a parent itself.

Contract ("empty-recorder parity", mirroring the fault injector's
empty schedule): every instrumented call site goes through a no-op
null span when the recorder is absent, so tracing off leaves counters
and device bytes bit-identical to the untraced build and records no
timing event on the card.

Span-accounting invariant (enforced by ``check_span_accounting``):

* every opened span closes (``opened == closed``), including when an
  ``InjectedCrash`` unwinds the stack — spans are context managers;
* under ``SimClock`` with the simulator store stack, all clock charges
  happen inside *leaf* spans, so for every root span the sum of its
  leaf descendants' durations equals the root duration exactly.

Device spans sit outside this host accounting: they are not counted in
``opened`` / ``closed``, and ``span_accounting`` and
``coverage_fraction`` skip them, since the card's time overlaps the host
time of the span that launched it.

Under ``WallClock`` real time accrues between spans, so the equality
becomes a coverage fraction — report it, never assert it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.obs.hist import HistogramSet

NO_PARENT = -1


@dataclass
class Span:
    span_id: int
    parent_id: int
    stage: str
    category: str
    shard: int
    t0: float
    dur_ms: float | None = None
    attrs: dict = field(default_factory=dict)
    on: str = "host"            # "device": timed on the card (``device_span``)


@dataclass
class Event:
    name: str
    t: float
    fields: dict


class _SpanHandle:
    """Context manager for one live span; ``set()`` adds attributes."""

    __slots__ = ("_rec", "span")

    def __init__(self, rec: "TraceRecorder", span: Span) -> None:
        self._rec = rec
        self.span = span

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec._close(self.span)
        return False


class _NullSpan:
    """Shared no-op span: the disabled-tracing hot path."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _DeviceSpanHandle:
    """Context manager for one device span: a timing event on entry and
    one on exit; the recorder resolves both at its next ``sync_point``."""

    __slots__ = ("_rec", "span", "_start")

    def __init__(self, rec: "TraceRecorder", span: Span) -> None:
        self._rec = rec
        self.span = span

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self) -> "_DeviceSpanHandle":
        self._start = self._rec.timer.record()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec._pending.append((self.span, self._start,
                                   self._rec.timer.record()))
        return False


class CudaEventTimer:
    """The card's timer: ``record`` puts a timing event on the current
    CUDA stream; ``elapsed_ms`` reads two completed events."""

    def record(self):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, ev) -> None:
        ev.synchronize()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b)


class TraceRecorder:
    """Clock-timed span tree + event stream + latency histograms."""

    def __init__(self, clock, timer=None) -> None:
        self.clock = clock
        # The device spans' timer: None times them with CUDA events, and
        # only on a CUDA device; a timer passed in (``record``, ``wait``,
        # ``elapsed_ms``) times them on any device.
        self.timer = timer
        self.spans: list[Span] = []
        self.events: list[Event] = []
        self.hist = HistogramSet()
        self.opened = 0
        self.closed = 0
        self._stack: list[int] = []
        self._pending: list[tuple] = []     # (span, start event, end event)

    # -- spans ---------------------------------------------------------
    def span(self, stage: str, *, category: str = "", shard: int = -1,
             **attrs) -> _SpanHandle:
        parent = self._stack[-1] if self._stack else NO_PARENT
        sp = Span(len(self.spans), parent, stage, category, shard,
                  self.clock.now(), attrs=dict(attrs))
        self.spans.append(sp)
        self._stack.append(sp.span_id)
        self.opened += 1
        return _SpanHandle(self, sp)

    def device_span(self, stage: str, device, *, category: str = "",
                    shard: int = -1, **attrs):
        """A span timed on the card around the work launched inside it;
        ``NULL_SPAN`` where ``device`` is not CUDA and no timer was
        passed in. Its ``t0`` is the host clock at opening and its
        ``dur_ms`` None until the next ``sync_point()`` sets both."""
        if self.timer is None:
            if getattr(device, "type", device) != "cuda":
                return NULL_SPAN
            self.timer = CudaEventTimer()
        parent = self._stack[-1] if self._stack else NO_PARENT
        sp = Span(len(self.spans), parent, stage, category, shard,
                  self.clock.now(), attrs=dict(attrs), on="device")
        self.spans.append(sp)
        return _DeviceSpanHandle(self, sp)

    def sync_point(self) -> None:
        """Resolve the pending device spans onto this recorder's clock.
        Call right after a device→host copy: the stream is drained, so
        an anchor event recorded now completes at once, at ``clock.now()``,
        and each event's time is the anchor's less the card's time
        between them."""
        if not self._pending:
            return
        timer = self.timer
        anchor = timer.record()
        t_anchor = self.clock.now()
        timer.wait(anchor)
        for sp, start, end in self._pending:
            sp.t0 = t_anchor - timer.elapsed_ms(start, anchor) / 1e3
            sp.dur_ms = timer.elapsed_ms(start, end)
            self.hist.observe(sp.stage, sp.dur_ms,
                              category=sp.category, shard=sp.shard)
        self._pending.clear()

    def _close(self, sp: Span) -> None:
        # ``with`` blocks unwind LIFO even under exceptions, so the
        # closing span is always the top of the stack.
        if self._stack and self._stack[-1] == sp.span_id:
            self._stack.pop()
        sp.dur_ms = (self.clock.now() - sp.t0) * 1e3
        self.closed += 1
        self.hist.observe(sp.stage, sp.dur_ms,
                          category=sp.category, shard=sp.shard)

    # -- events & direct histogram feed --------------------------------
    def event(self, name: str, **fields) -> None:
        self.events.append(Event(name, self.clock.now(), dict(fields)))

    def observe_ms(self, stage: str, ms: float, *,
                   category: str = "", shard: int = -1) -> None:
        self.hist.observe(stage, ms, category=category, shard=shard)

    def event_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev.name] = out.get(ev.name, 0) + 1
        return dict(sorted(out.items()))

    # -- export --------------------------------------------------------
    def to_jsonl(self, path) -> int:
        """Dump spans then events, one JSON object per line."""
        n = 0
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(
                    {"type": "span", "id": sp.span_id,
                     "parent": sp.parent_id, "stage": sp.stage,
                     "category": sp.category, "shard": sp.shard,
                     "t0": round(sp.t0, 9),
                     "dur_ms": (None if sp.dur_ms is None
                                else round(sp.dur_ms, 9)),
                     "attrs": sp.attrs, "on": sp.on},
                    sort_keys=True) + "\n")
                n += 1
            for ev in self.events:
                f.write(json.dumps(
                    {"type": "event", "name": ev.name,
                     "t": round(ev.t, 9), "fields": ev.fields},
                    sort_keys=True) + "\n")
                n += 1
        return n


# -- span accounting ----------------------------------------------------

def _on_host(sp) -> bool:
    """Whether ``sp`` is a host span (a span without ``on`` is: the
    reference's spans have none)."""
    return getattr(sp, "on", "host") == "host"


def _children_map(spans: list[Span]) -> dict[int, list[Span]]:
    """Host spans by parent: device spans sit outside the accounting."""
    kids: dict[int, list[Span]] = {}
    for sp in spans:
        if _on_host(sp):
            kids.setdefault(sp.parent_id, []).append(sp)
    return kids


def _leaf_sum_ms(root: Span, kids: dict[int, list[Span]]) -> float:
    """Sum of leaf-descendant durations under ``root`` (iterative)."""
    total = 0.0
    stack = [root]
    while stack:
        sp = stack.pop()
        ch = kids.get(sp.span_id)
        if ch:
            stack.extend(ch)
        elif sp is not root or root.span_id not in kids:
            total += sp.dur_ms or 0.0
    return total


def span_accounting(rec: TraceRecorder, eps_ms: float = 1e-6) -> dict:
    """Summary of the accounting invariant over a finished trace."""
    kids = _children_map(rec.spans)
    roots = kids.get(NO_PARENT, [])
    max_gap = 0.0
    gaps = []
    for root in roots:
        if root.dur_ms is None:
            continue
        gap = abs(_leaf_sum_ms(root, kids) - root.dur_ms)
        max_gap = max(max_gap, gap)
        if gap > eps_ms:
            gaps.append((root.span_id, root.stage, gap))
    return {"opened": rec.opened, "closed": rec.closed,
            "spans": sum(map(_on_host, rec.spans)),
            "roots": len(roots),
            "max_gap_ms": max_gap, "gapped_roots": gaps}


def check_span_accounting(rec: TraceRecorder,
                          eps_ms: float = 1e-6) -> list[str]:
    """Violations of the accounting invariant; [] when it holds."""
    acc = span_accounting(rec, eps_ms)
    out = []
    if acc["opened"] != acc["closed"]:
        out.append(f"span leak: opened={acc['opened']} "
                   f"closed={acc['closed']}")
    for span_id, stage, gap in acc["gapped_roots"]:
        out.append(f"root span {span_id} ({stage}): leaf durations "
                   f"differ from root by {gap:.6f} ms")
    return out


def coverage_fraction(rec: TraceRecorder) -> float:
    """Leaf time / root time across all roots (WallClock-safe view)."""
    kids = _children_map(rec.spans)
    roots = kids.get(NO_PARENT, [])
    root_ms = sum(r.dur_ms or 0.0 for r in roots)
    if root_ms <= 0.0:
        return 1.0
    leaf_ms = sum(_leaf_sum_ms(r, kids) for r in roots)
    return min(1.0, leaf_ms / root_ms)
