"""Straggler watchdog for the serving loop.

The ``StepWatchdog`` of ``repro.distributed.fault`` (standard library
only): if a step exceeds ``timeout_factor ×`` the trailing-median step
time, a callback fires (alert / skip / abort). On a real multi-host
deployment the callback wires to the cluster manager to evict the slow
host; here ``ServingEngine.step`` counts it in ``stats.straggler_steps``.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable


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
