"""Composable random generators for property-style tests.

Capability match for the reference's generator infrastructure (reference:
core/src/main/kotlin/net/corda/core/testing/Generators.kt and
client/src/main/kotlin/net/corda/client/mock/Generator.kt, EventGenerator.kt):
a tiny generator monad plus domain generators (keys, parties, amounts,
issued tokens, state refs) and the cash EventGenerator the loadtest uses to
produce random-but-valid command streams.

The port's own copy of ``corda_tpu/testing/generators.py``. It draws from
``random.Random`` exactly as the reference does, so one seed gives the
same stream in both packages.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Generator(Generic[T]):
    """Wraps rng -> T; composes with map/flat_map/choice (Generator.kt)."""

    def __init__(self, fn: Callable[[random.Random], T]):
        self._fn = fn

    def generate(self, rng: random.Random) -> T:
        return self._fn(rng)

    def map(self, f: Callable[[T], U]) -> "Generator[U]":
        return Generator(lambda rng: f(self._fn(rng)))

    def flat_map(self, f: Callable[[T], "Generator[U]"]) -> "Generator[U]":
        return Generator(lambda rng: f(self._fn(rng)).generate(rng))

    @staticmethod
    def pure(value: T) -> "Generator[T]":
        return Generator(lambda _rng: value)

    @staticmethod
    def choice(options: list["Generator[T]"]) -> "Generator[T]":
        return Generator(lambda rng: rng.choice(options).generate(rng))

    @staticmethod
    def int_range(lo: int, hi: int) -> "Generator[int]":
        return Generator(lambda rng: rng.randint(lo, hi))

    @staticmethod
    def pick(values: list[T]) -> "Generator[T]":
        return Generator(lambda rng: rng.choice(values))

    def list_of(self, n: int) -> "Generator[list[T]]":
        return Generator(lambda rng: [self._fn(rng) for _ in range(n)])


# -- domain generators (core Generators.kt capability) ----------------------


def key_pair_gen() -> Generator:
    from ..crypto.keys import KeyPair

    return Generator(lambda rng: KeyPair.generate(rng.randbytes(32)))


def party_gen(names=("Alice Corp", "Bob Plc", "Charlie GmbH")) -> Generator:
    from ..crypto.party import Party

    return key_pair_gen().flat_map(
        lambda kp: Generator.pick(list(names)).map(
            lambda name: Party.of(name, kp.public)))


def secure_hash_gen() -> Generator:
    from ..crypto.hashes import SecureHash

    return Generator(lambda rng: SecureHash(rng.randbytes(32)))


def state_ref_gen() -> Generator:
    from ..contracts.structures import StateRef

    return secure_hash_gen().flat_map(
        lambda h: Generator.int_range(0, 9).map(lambda i: StateRef(h, i)))


def amount_gen(token="USD", lo=1, hi=1_000_000) -> Generator:
    from ..finance.amount import Amount

    return Generator.int_range(lo, hi).map(lambda q: Amount(q, token))


def issued_amount_gen(issuer, token="USD") -> Generator:
    from ..contracts.structures import Issued
    from ..finance.amount import Amount

    return Generator.int_range(1, 1_000_000).map(
        lambda q: Amount(q, Issued(issuer, token)))


# -- the cash event stream (client mock EventGenerator.kt capability) -------


class CashEvent:
    pass


class IssueEvent(CashEvent):
    def __init__(self, amount, owner):
        self.amount, self.owner = amount, owner


class MoveEvent(CashEvent):
    def __init__(self, amount, new_owner):
        self.amount, self.new_owner = amount, new_owner


class ExitEvent(CashEvent):
    def __init__(self, amount):
        self.amount = amount


def cash_event_generator(owners: list, issued_so_far: Callable[[], int],
                         currency: str = "USD") -> Generator:
    """Random-but-valid cash commands: issues always valid; moves/exits
    bounded by what has been issued (EventGenerator.kt shape)."""

    def gen(rng: random.Random) -> CashEvent:
        from ..finance.amount import Amount

        balance = issued_so_far()
        if balance <= 0 or rng.random() < 0.5:
            return IssueEvent(Amount(rng.randint(1, 10_000), currency),
                              rng.choice(owners))
        if rng.random() < 0.8:
            return MoveEvent(Amount(rng.randint(1, balance), currency),
                             rng.choice(owners))
        return ExitEvent(Amount(rng.randint(1, balance), currency))

    return Generator(gen)
