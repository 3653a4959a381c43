"""Clock abstraction with a test-controllable variant.

The port's own copy of ``corda_tpu/utils/clock.py``.

Capability match for the reference's TestClock/MutableClock virtual time
(reference: test-utils/src/main/kotlin/net/corda/testing/node/TestClock.kt,
node/.../utilities/ClockUtils.kt). Times are epoch-microseconds.
"""

from __future__ import annotations

import time


class Clock:
    def now_micros(self) -> int:
        return int(time.time() * 1_000_000)


class TestClock(Clock):
    """A clock tests can set and advance deterministically."""

    def __init__(self, start_micros: int = 1_700_000_000_000_000):
        self._now = start_micros

    def now_micros(self) -> int:
        return self._now

    def set_time(self, micros: int) -> None:
        self._now = micros

    def advance(self, micros: int) -> None:
        self._now += micros
