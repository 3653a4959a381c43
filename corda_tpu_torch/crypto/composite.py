"""Weighted-threshold composite keys.

The port's own copy of ``corda_tpu/crypto/composite.py``.

Capability match for the reference's CompositeKey (reference:
core/src/main/kotlin/net/corda/core/crypto/CompositeKey.kt:22-145): a tree
whose leaves are public keys and whose interior nodes carry per-child weights
and a threshold. `is_fulfilled_by` checks whether a set of signing keys
reaches the threshold at every level — this is how "2-of-3 notary cluster" or
"CEO or 3 of 5 assistants" requirements are expressed.

Immutable and hashable so keys can live in sets/maps and serialize
canonically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

from .keys import PublicKey


@dataclass(frozen=True)
class CompositeKey:
    """Base for the two node kinds; use CompositeKey.leaf / CompositeKey.node."""

    def is_fulfilled_by(self, keys: Iterable[PublicKey] | PublicKey) -> bool:
        if isinstance(keys, PublicKey):
            keys = {keys}
        return self._fulfilled(frozenset(keys))

    def _fulfilled(self, keys: frozenset[PublicKey]) -> bool:
        raise NotImplementedError

    @property
    def keys(self) -> frozenset[PublicKey]:
        raise NotImplementedError

    def contains_any(self, other_keys: Iterable[PublicKey]) -> bool:
        return bool(self.keys & set(other_keys))

    @property
    def single_key(self) -> PublicKey:
        ks = self.keys
        if len(ks) != 1:
            raise ValueError("The key is composed of more than one PublicKey primitive")
        return next(iter(ks))

    def to_base58_string(self) -> str:
        """Serialized form, base58-encoded (CompositeKey.kt:36-44)."""
        from . import base58
        from ..serialization.codec import serialize

        return base58.encode(serialize(self).bytes)

    @staticmethod
    def parse_from_base58(encoded: str) -> "CompositeKey":
        from . import base58
        from ..serialization.codec import deserialize

        key = deserialize(base58.decode(encoded))
        if not isinstance(key, CompositeKey):
            raise ValueError("encoded value is not a CompositeKey")
        return key

    @staticmethod
    def leaf(key: PublicKey) -> "CompositeKeyLeaf":
        return CompositeKeyLeaf(key)

    @staticmethod
    def node(
        threshold: int, children: list["CompositeKey"], weights: list[int]
    ) -> "CompositeKeyNode":
        return CompositeKeyNode(threshold, tuple(children), tuple(weights))

    class Builder:
        """Builder mirroring CompositeKey.Builder (CompositeKey.kt:110-135)."""

        def __init__(self):
            self._children: list[CompositeKey] = []
            self._weights: list[int] = []

        def add_key(self, key: "CompositeKey | PublicKey", weight: int = 1) -> "CompositeKey.Builder":
            if isinstance(key, PublicKey):
                key = CompositeKeyLeaf(key)
            self._children.append(key)
            self._weights.append(weight)
            return self

        def add_keys(self, *keys: "CompositeKey | PublicKey") -> "CompositeKey.Builder":
            for k in keys:
                self.add_key(k)
            return self

        def build(self, threshold: int | None = None) -> "CompositeKeyNode":
            t = threshold if threshold is not None else len(self._children)
            return CompositeKeyNode(t, tuple(self._children), tuple(self._weights))


@dataclass(frozen=True)
class CompositeKeyLeaf(CompositeKey):
    """A single public key at the leaf of the tree."""

    public_key: PublicKey

    def _fulfilled(self, keys: frozenset[PublicKey]) -> bool:
        return self.public_key in keys

    @property
    def keys(self) -> frozenset[PublicKey]:
        return frozenset({self.public_key})

    def __repr__(self) -> str:
        return self.public_key.to_string_short()


@dataclass(frozen=True)
class CompositeKeyNode(CompositeKey):
    """Interior node: children with weights; fulfilled when the summed weight
    of fulfilled children reaches the threshold (CompositeKey.kt:75-81)."""

    threshold: int
    children: tuple[CompositeKey, ...] = field(default_factory=tuple)
    weights: tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if len(self.children) != len(self.weights):
            raise ValueError("children and weights must have equal length")
        if not self.children:
            raise ValueError("composite key node must have at least one child")
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1")
        if any(w < 1 for w in self.weights):
            raise ValueError("weights must be >= 1")

    def _fulfilled(self, keys: frozenset[PublicKey]) -> bool:
        total = sum(
            w for child, w in zip(self.children, self.weights) if child._fulfilled(keys)
        )
        return total >= self.threshold

    @property
    def keys(self) -> frozenset[PublicKey]:
        out: set[PublicKey] = set()
        for child in self.children:
            out |= child.keys
        return frozenset(out)

    def __repr__(self) -> str:
        return "(" + ", ".join(repr(c) for c in self.children) + ")"


def all_keys(composites: Iterable[CompositeKey]) -> frozenset[PublicKey]:
    """Union of leaf keys over several composite keys (CompositeKey.kt:143-145)."""
    out: set[PublicKey] = set()
    for ck in composites:
        out |= ck.keys
    return frozenset(out)


def iter_leaves(ck: CompositeKey) -> Iterator[CompositeKeyLeaf]:
    if isinstance(ck, CompositeKeyLeaf):
        yield ck
    elif isinstance(ck, CompositeKeyNode):
        for child in ck.children:
            yield from iter_leaves(child)
