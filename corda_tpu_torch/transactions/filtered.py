"""Filtered transactions — Merkle tear-offs.

The port's own copy of ``corda_tpu/transactions/filtered.py``.

Capability match for the reference's FilteredTransaction machinery (reference:
core/src/main/kotlin/net/corda/core/transactions/MerkleTransaction.kt:104-178):
reveal only a chosen subset of a transaction's components (e.g. just the
commands an oracle must sign over) together with a partial Merkle proof tying
them to the transaction id. Used by oracles (NodeInterestRates) and
non-validating verification.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..contracts.structures import Command, StateRef, TransactionState
from ..crypto.hashes import SecureHash
from ..crypto.merkle import MerkleTreeException, PartialMerkleTree
from ..serialization.codec import register, serialized_hash
from .wire import WireTransaction


@register
@dataclass(frozen=True)
class FilteredLeaves:
    """The revealed components (MerkleTransaction.kt:104-117)."""

    inputs: tuple[StateRef, ...] = ()
    outputs: tuple[TransactionState, ...] = ()
    attachments: tuple[SecureHash, ...] = ()
    commands: tuple[Command, ...] = ()

    def filtered_hashes(self) -> list[SecureHash]:
        return [
            serialized_hash(x)
            for group in (self.inputs, self.outputs, self.attachments, self.commands)
            for x in group
        ]


@dataclass(frozen=True)
class FilterFuns:
    """Per-component-kind predicates (MerkleTransaction.kt:120-137)."""

    filter_inputs: Callable[[StateRef], bool] = field(default=lambda _: False)
    filter_outputs: Callable[[TransactionState], bool] = field(default=lambda _: False)
    filter_attachments: Callable[[SecureHash], bool] = field(default=lambda _: False)
    filter_commands: Callable[[Command], bool] = field(default=lambda _: False)


@register
@dataclass(frozen=True)
class FilteredTransaction:
    """Revealed leaves + the Merkle branch proving them
    (MerkleTransaction.kt:139-178)."""

    filtered_leaves: FilteredLeaves
    partial_merkle_tree: PartialMerkleTree

    @staticmethod
    def build_merkle_transaction(
        wtx: WireTransaction, filter_funs: FilterFuns
    ) -> "FilteredTransaction":
        leaves = FilteredLeaves(
            inputs=tuple(i for i in wtx.inputs if filter_funs.filter_inputs(i)),
            outputs=tuple(o for o in wtx.outputs if filter_funs.filter_outputs(o)),
            attachments=tuple(a for a in wtx.attachments if filter_funs.filter_attachments(a)),
            commands=tuple(c for c in wtx.commands if filter_funs.filter_commands(c)),
        )
        pmt = PartialMerkleTree.build(wtx.merkle_tree, leaves.filtered_hashes())
        return FilteredTransaction(leaves, pmt)

    def verify(self, merkle_root_hash: SecureHash) -> bool:
        """Check the revealed leaves really belong to the transaction whose id
        is merkle_root_hash (MerkleTransaction.kt:170-177)."""
        hashes = self.filtered_leaves.filtered_hashes()
        if not hashes:
            raise MerkleTreeException("Transaction without included leaves.")
        return self.partial_merkle_tree.verify(merkle_root_hash, hashes)
