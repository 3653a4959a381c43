"""Event-sequence assertions: the Expect DSL.

Capability match for the reference's Expect DSL (reference:
test-utils/src/main/kotlin/net/corda/testing/Expect.kt): declare the shape of
an event stream — single expectations, strict sequences, unordered parallel
groups — and check a recorded feed against it.

    expect_events(feed,
        sequence(
            expect(VaultUpdate, lambda e: len(e.produced) == 1),
            parallel(expect(TxRecorded), expect(ProgressChange)),
        ))

The port's own copy of ``corda_tpu/testing/expect.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence


class ExpectationFailed(AssertionError):
    pass


@dataclass
class _Expect:
    event_type: type
    predicate: Callable[[Any], bool] | None = None

    def matches(self, event) -> bool:
        if not isinstance(event, self.event_type):
            return False
        return self.predicate is None or bool(self.predicate(event))

    def describe(self) -> str:
        return self.event_type.__name__


@dataclass
class _Sequence:
    parts: tuple

    def describe(self) -> str:
        return "sequence(" + ", ".join(p.describe() for p in self.parts) + ")"


@dataclass
class _Parallel:
    parts: tuple

    def describe(self) -> str:
        return "parallel(" + ", ".join(p.describe() for p in self.parts) + ")"


def expect(event_type: type, predicate=None) -> _Expect:
    return _Expect(event_type, predicate)


def sequence(*parts) -> _Sequence:
    return _Sequence(tuple(parts))


def parallel(*parts) -> _Parallel:
    return _Parallel(tuple(parts))


def expect_events(feed: Sequence, spec) -> None:
    """Consume `feed` against `spec`; raises ExpectationFailed with the first
    unsatisfied expectation. Events not matched by the spec are skipped
    (the reference likewise ignores unexpected events between matches)."""
    remaining = list(feed)
    _consume(remaining, spec)


def _consume(feed: list, spec) -> None:
    if isinstance(spec, _Expect):
        while feed:
            event = feed.pop(0)
            if spec.matches(event):
                return
        raise ExpectationFailed(f"no event matched {spec.describe()}")
    if isinstance(spec, _Sequence):
        for part in spec.parts:
            _consume(feed, part)
        return
    if isinstance(spec, _Parallel):
        outstanding = list(spec.parts)
        while outstanding:
            if not feed:
                raise ExpectationFailed(
                    "feed exhausted with outstanding parallel expectations: "
                    + ", ".join(p.describe() for p in outstanding))
            event = feed.pop(0)
            for part in outstanding:
                if isinstance(part, _Expect) and part.matches(event):
                    outstanding.remove(part)
                    break
        return
    raise TypeError(f"unknown spec {spec!r}")
