"""LedgerTransaction: a WireTransaction with its dependencies resolved.

The port's own copy of ``corda_tpu/transactions/ledger.py``.

Capability match for the reference's LedgerTransaction (reference:
core/src/main/kotlin/net/corda/core/transactions/LedgerTransaction.kt):
inputs resolved to actual states, commands authenticated against known
parties, attachments opened — ready for contract verification.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..contracts.structures import (
    Attachment,
    AuthenticatedObject,
    StateAndRef,
    StateRef,
    Timestamp,
    TransactionState,
)
from ..contracts.verification import TransactionForContract
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from .types import TransactionType


@dataclass(frozen=True)
class LedgerTransaction:
    """Resolved transaction; verify() runs the platform + contract rules."""

    inputs: tuple[StateAndRef, ...]
    outputs: tuple[TransactionState, ...]
    commands: tuple[AuthenticatedObject, ...]
    attachments: tuple[Attachment, ...]
    id: SecureHash
    notary: Party | None
    must_sign: tuple[CompositeKey, ...]
    timestamp: Timestamp | None
    type: TransactionType

    def __post_init__(self):
        if self.notary is None and self.inputs:
            raise ValueError("The notary must be specified explicitly for any transaction that has inputs.")
        if self.timestamp is not None and self.notary is None:
            raise ValueError("If a timestamp is provided, there must be a notary.")

    def out_ref(self, index: int) -> StateAndRef:
        return StateAndRef(self.outputs[index], StateRef(self.id, index))

    def to_transaction_for_contract(self) -> TransactionForContract:
        notaries = {inp.state.notary for inp in self.inputs}
        return TransactionForContract(
            inputs=tuple(inp.state.data for inp in self.inputs),
            outputs=tuple(out.data for out in self.outputs),
            attachments=self.attachments,
            commands=self.commands,
            id=self.id,
            notary=next(iter(notaries)) if len(notaries) == 1 else None,
            timestamp=self.timestamp,
        )

    def verify(self) -> None:
        """Type-specific + platform verification (LedgerTransaction.kt:57)."""
        self.type.verify(self)
