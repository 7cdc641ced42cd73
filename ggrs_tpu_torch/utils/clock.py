"""Injectable millisecond clocks (the reference's `utils/clock.py`, copied).

Every timer consumer takes a Clock, so protocol tests can drive time
deterministically with FakeClock — no sleeps, no flaky timing tests.
"""

from __future__ import annotations

import time


class Clock:
    """Real monotonic clock, millisecond resolution."""

    def now_ms(self) -> int:
        return time.monotonic_ns() // 1_000_000


class FakeClock(Clock):
    """Manually advanced clock for deterministic protocol tests."""

    def __init__(self, start_ms: int = 0):
        self._now = start_ms

    def now_ms(self) -> int:
        return self._now

    def advance(self, ms: int) -> None:
        assert ms >= 0
        self._now += ms
