"""Small collection utilities.

Capability match for the reference's NonEmptySet (reference:
core/src/main/kotlin/net/corda/core/utilities/NonEmptySet.kt — a set that
can never become empty, used where "at least one" is a type-level invariant,
e.g. signature sets).

The port's own copy of ``corda_tpu/utils/collections.py``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


class NonEmptySet(frozenset):
    """A frozenset that refuses to be empty. Set-algebra results that would
    be empty raise instead of silently violating the invariant."""

    def __new__(cls, items: Iterable[T]):
        self = super().__new__(cls, items)
        if not len(self):
            raise ValueError("NonEmptySet cannot be empty")
        return self

    # Every operation that could shrink the set routes through the
    # constructor so an empty result raises instead of silently escaping as
    # a plain frozenset.

    def __and__(self, other):
        return NonEmptySet(frozenset(self) & frozenset(other))

    __rand__ = __and__

    def __sub__(self, other):
        return NonEmptySet(frozenset(self) - frozenset(other))

    def __xor__(self, other):
        return NonEmptySet(frozenset(self) ^ frozenset(other))

    __rxor__ = __xor__

    def __or__(self, other):
        return NonEmptySet(frozenset(self) | frozenset(other))

    __ror__ = __or__

    def intersection(self, *others):
        return NonEmptySet(frozenset(self).intersection(*others))

    def difference(self, *others):
        return NonEmptySet(frozenset(self).difference(*others))

    def symmetric_difference(self, other):
        return NonEmptySet(frozenset(self).symmetric_difference(other))

    def union(self, *others):
        return NonEmptySet(frozenset(self).union(*others))

    @staticmethod
    def of(first: T, *rest: T) -> "NonEmptySet":
        return NonEmptySet((first,) + rest)
