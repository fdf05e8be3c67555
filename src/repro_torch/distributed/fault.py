"""Fault tolerance: preemption handling, straggler watchdog, retry.

The counterpart of ``repro.distributed.fault`` (standard library only).

``PreemptionHandler`` — SIGTERM/SIGINT → set a flag; the training loop
checkpoints and exits cleanly at the next step boundary (emergency save).

``StepWatchdog`` — if a step exceeds ``timeout_factor ×`` the
trailing-median step time, a callback fires (alert / skip / abort). On a
real multi-host deployment the callback wires to the cluster manager to
evict the slow host; here ``ServingEngine.step`` counts it in
``stats.straggler_steps`` and the training loop logs it.

``retry_step`` — bounded retry of a step on ``RuntimeError`` (torch's
CUDA errors are ``RuntimeError``s). Backoff between attempts is charged
to an injectable ``repro_torch.core.clock.Clock``: a ``SimClock`` makes
retry timing deterministic and testable, a ``WallClock`` really sleeps;
the default ``backoff_s=0`` retries at once.
"""

from __future__ import annotations

import signal
import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = False
        self._installed = False
        self._signals = signals
        self._prev = {}

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self._flag = True

    @property
    def preempted(self) -> bool:
        return self._flag

    def trigger_for_test(self) -> None:
        self._flag = True


@dataclass
class StepWatchdog:
    timeout_factor: float = 3.0
    min_history: int = 5
    window: int = 32
    on_straggler: Callable[[float, float], None] | None = None
    _times: deque = field(default_factory=lambda: deque(maxlen=32))
    _start: float | None = None
    straggler_events: int = 0

    def step_start(self) -> None:
        self._start = time.monotonic()

    def step_end(self) -> float:
        assert self._start is not None, "step_end without step_start"
        dt = time.monotonic() - self._start
        self._start = None
        if len(self._times) >= self.min_history:
            med = statistics.median(self._times)
            if dt > self.timeout_factor * med:
                self.straggler_events += 1
                if self.on_straggler is not None:
                    self.on_straggler(dt, med)
        self._times.append(dt)
        return dt

    def observe_for_test(self, dt: float) -> None:
        """Inject a synthetic step time (unit tests)."""
        if len(self._times) >= self.min_history:
            med = statistics.median(self._times)
            if dt > self.timeout_factor * med:
                self.straggler_events += 1
                if self.on_straggler is not None:
                    self.on_straggler(dt, med)
        self._times.append(dt)


def retry_step(fn: Callable, *args, retries: int = 2,
               on_retry: Callable[[int, BaseException], None] | None = None,
               backoff_s: float = 0.0, clock=None):
    """Call ``fn(*args)``, retrying ``RuntimeError`` (device / transient
    errors) up to ``retries`` times. With ``backoff_s > 0`` the k-th retry
    waits ``backoff_s · 2^k`` seconds first, charged via ``clock.advance``:
    pass a ``SimClock`` for deterministic tests; the default is a real
    sleep."""
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except RuntimeError as e:
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s > 0.0 and attempt < retries:
                if clock is None:
                    from repro_torch.core.clock import WallClock
                    clock = WallClock()
                clock.advance(backoff_s * (2.0 ** attempt))
    raise last
