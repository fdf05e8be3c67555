"""Clocks.

Benchmarks and the serving simulator run on a simulated clock so that
"30 ms remote search" style costs are charged without wall-clock sleeps,
while live serving uses the wall clock.
"""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def advance(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real time. ``advance`` sleeps (used only in live serving tests)."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class SimClock(Clock):
    """Manually advanced clock for discrete-event simulation."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot advance clock backwards by {seconds}")
        self._t += seconds
