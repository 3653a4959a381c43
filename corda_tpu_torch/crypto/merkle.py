"""Merkle trees and partial (branch) Merkle trees.

Capability match for the reference's MerkleTree (reference:
core/src/main/kotlin/net/corda/core/transactions/MerkleTransaction.kt:62-99)
and PartialMerkleTree (core/.../crypto/PartialMerkleTree.kt:69-143):

  * full tree built bottom-up from leaf hashes; an odd node at any level is
    hashed with itself, recorded as a DuplicatedLeaf so partial-tree filtering
    can tell the duplicate from a real leaf;
  * node hash = sha256(left || right);
  * a partial tree keeps IncludedLeaf markers for the leaves being proven,
    bare hashes for pruned subtrees, and verifies by recomputing the root and
    set-comparing the included hashes.

Transaction ids are Merkle roots over the serialized components, so this is
on the notary hot path; the batched/tree-reduction variant for large batches
is ops/sha256.py's merkle_roots (the Merkle pair kernel on the card). This
host version is the authoritative structure (and works for any leaf count).

The port's own copy of ``corda_tpu/crypto/merkle.py``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from .hashes import SecureHash


class MerkleTreeException(Exception):
    def __init__(self, reason: str):
        super().__init__(f"Partial Merkle Tree exception. Reason: {reason}")
        self.reason = reason


@dataclass(frozen=True)
class MerkleTree:
    """A node in a full Merkle tree; `hash` is the subtree root."""

    hash: SecureHash

    @staticmethod
    def build(leaf_hashes: list[SecureHash]) -> "MerkleTree":
        """Bottom-up construction (MerkleTransaction.kt:66-99)."""
        if not leaf_hashes:
            raise MerkleTreeException("Cannot calculate Merkle root on empty hash list.")
        level: list[MerkleTree] = [MerkleLeaf(h) for h in leaf_hashes]
        while len(level) > 1:
            nxt: list[MerkleTree] = []
            for i in range(0, len(level), 2):
                left = level[i]
                right = (
                    level[i + 1]
                    if i + 1 < len(level)
                    else MerkleDuplicatedLeaf(level[-1].hash)
                )
                nxt.append(MerkleNode(left.hash.hash_concat(right.hash), left, right))
            level = nxt
        return level[0]


@dataclass(frozen=True)
class MerkleLeaf(MerkleTree):
    pass


@dataclass(frozen=True)
class MerkleDuplicatedLeaf(MerkleTree):
    """The rightmost node hashed with itself to pad an odd level."""


@dataclass(frozen=True)
class MerkleNode(MerkleTree):
    left: MerkleTree = None  # type: ignore[assignment]
    right: MerkleTree = None  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# Partial trees
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PartialTree:
    """Base of the three partial-tree node kinds."""


@dataclass(frozen=True)
class PartialIncludedLeaf(PartialTree):
    hash: SecureHash


@dataclass(frozen=True)
class PartialLeaf(PartialTree):
    hash: SecureHash


@dataclass(frozen=True)
class PartialNode(PartialTree):
    left: PartialTree
    right: PartialTree


@dataclass(frozen=True)
class PartialMerkleTree:
    """A Merkle branch proving a subset of leaves against a root
    (PartialMerkleTree.kt:69-143)."""

    root: PartialTree

    @staticmethod
    def build(merkle_root: MerkleTree, include_hashes: list[SecureHash]) -> "PartialMerkleTree":
        used: list[SecureHash] = []
        _, tree = PartialMerkleTree._build(merkle_root, frozenset(include_hashes), used)
        if len(include_hashes) != len(used):
            raise MerkleTreeException("Some of the provided hashes are not in the tree.")
        return PartialMerkleTree(tree)

    @staticmethod
    def _build(
        node: MerkleTree, include: frozenset[SecureHash], used: list[SecureHash]
    ) -> tuple[bool, PartialTree]:
        if isinstance(node, MerkleDuplicatedLeaf):
            return False, PartialLeaf(node.hash)
        if isinstance(node, MerkleLeaf):
            if node.hash in include:
                used.append(node.hash)
                return True, PartialIncludedLeaf(node.hash)
            return False, PartialLeaf(node.hash)
        assert isinstance(node, MerkleNode)
        l_in, l_tree = PartialMerkleTree._build(node.left, include, used)
        r_in, r_tree = PartialMerkleTree._build(node.right, include, used)
        if l_in or r_in:
            return True, PartialNode(l_tree, r_tree)
        return False, PartialLeaf(node.hash)

    def verify(self, merkle_root_hash: SecureHash, hashes_to_check: list[SecureHash]) -> bool:
        used: list[SecureHash] = []
        root = self._root_hash(self.root, used)
        if Counter(hashes_to_check) != Counter(used):
            return False
        return root == merkle_root_hash

    @staticmethod
    def _root_hash(node: PartialTree, used: list[SecureHash]) -> SecureHash:
        if isinstance(node, PartialIncludedLeaf):
            used.append(node.hash)
            return node.hash
        if isinstance(node, PartialLeaf):
            return node.hash
        assert isinstance(node, PartialNode)
        left = PartialMerkleTree._root_hash(node.left, used)
        right = PartialMerkleTree._root_hash(node.right, used)
        return left.hash_concat(right)

    def included_hashes(self) -> list[SecureHash]:
        used: list[SecureHash] = []
        self._root_hash(self.root, used)
        return used
