"""TransactionBuilder: the one mutable transaction type.

The port's own copy of ``corda_tpu/transactions/builder.py``.

Capability match for the reference's TransactionBuilder (reference:
core/src/main/kotlin/net/corda/core/transactions/TransactionBuilder.kt):
gather inputs/outputs/commands, then sign and freeze into a
SignedTransaction. The NotaryChange variant auto-collects participants as
signers (TransactionTypes.kt:129-140).
"""

from __future__ import annotations

from typing import Any

from ..contracts.structures import (
    Command,
    CommandData,
    ContractState,
    StateAndRef,
    StateRef,
    Timestamp,
    TransactionState,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.keys import DigitalSignature, KeyPair
from ..crypto.party import Party
from .signed import SignedTransaction
from .types import GeneralTransactionType, NotaryChangeTransactionType, TransactionType
from .wire import WireTransaction


class TransactionBuilder:
    def __init__(
        self,
        type: TransactionType | None = None,
        notary: Party | None = None,
    ):
        self.type = type or GeneralTransactionType()
        self.notary = notary
        self.inputs: list[StateRef] = []
        self.attachments: list[SecureHash] = []
        self.outputs: list[TransactionState] = []
        self.commands: list[Command] = []
        self.signers: list[CompositeKey] = []  # insertion-ordered, deduped
        self.timestamp: Timestamp | None = None
        self.current_sigs: list[DigitalSignature.WithKey] = []
        self._wtx_cache: WireTransaction | None = None

    @staticmethod
    def notary_change(notary: Party) -> "NotaryChangeBuilder":
        return NotaryChangeBuilder(notary)

    def copy(self) -> "TransactionBuilder":
        out = type(self)(self.type, self.notary)
        out.inputs = list(self.inputs)
        out.attachments = list(self.attachments)
        out.outputs = list(self.outputs)
        out.commands = list(self.commands)
        out.signers = list(self.signers)
        out.timestamp = self.timestamp
        return out

    def _add_signer(self, key: CompositeKey) -> None:
        if key not in self.signers:
            self.signers.append(key)

    def _check_not_signed(self) -> None:
        if self.current_sigs:
            raise ValueError("Cannot modify transaction after signing has started")
        # Every mutator calls this FIRST, so reaching here (no signatures
        # yet, mutation about to happen) is the one moment the cached wire
        # form can go stale.
        self._wtx_cache = None

    def _wire_cached(self) -> WireTransaction:
        """The wire form, computed once per content-state: an N-of-M
        multi-sig build calls sign_with N times, and rebuilding the
        WireTransaction each time discards its memoised Merkle tree —
        measured as the dominant cost of width-32 client builds (the id
        was recomputed per signature)."""
        if self._wtx_cache is None:
            self._wtx_cache = self.to_wire_transaction()
        return self._wtx_cache

    # -- mutation ----------------------------------------------------------

    def with_items(self, *items: Any) -> "TransactionBuilder":
        """Type-dispatched add (TransactionBuilder.kt:78-92)."""
        for t in items:
            if isinstance(t, StateAndRef):
                self.add_input_state(t)
            elif isinstance(t, TransactionState):
                self.add_output_state(t)
            elif isinstance(t, ContractState):
                self.add_output_state(t)
            elif isinstance(t, Command):
                self.add_command(t)
            elif isinstance(t, CommandData):
                raise ValueError(
                    "You passed CommandData without signer keys; wrap it in a Command first."
                )
            else:
                raise ValueError(f"Wrong argument type: {type(t)}")
        return self

    def add_input_state(self, state_and_ref: StateAndRef) -> None:
        self._check_not_signed()
        notary = state_and_ref.state.notary
        if notary != self.notary:
            raise ValueError(
                f'Input state requires notary "{notary}" which does not match '
                f'the transaction notary "{self.notary}".'
            )
        self._add_signer(notary.owning_key)
        self.inputs.append(state_and_ref.ref)

    def add_attachment(self, attachment_id: SecureHash) -> None:
        self._check_not_signed()
        self.attachments.append(attachment_id)

    def add_output_state(self, state: TransactionState | ContractState, notary: Party | None = None) -> int:
        self._check_not_signed()
        if isinstance(state, ContractState):
            n = notary or self.notary
            if n is None:
                raise ValueError(
                    "Need to specify a notary for the state, or a default one on the builder"
                )
            state = TransactionState(state, n)
        self.outputs.append(state)
        return len(self.outputs) - 1

    def add_command(self, command: Command | CommandData, *keys: CompositeKey) -> None:
        self._check_not_signed()
        if isinstance(command, CommandData):
            command = Command(command, tuple(keys))
        for k in command.signers:
            self._add_signer(k)
        self.commands.append(command)

    def set_time(self, timestamp: Timestamp) -> None:
        """Timestamps require the notary as timestamp authority
        (TransactionBuilder.kt:66-75)."""
        if self.notary is None:
            raise ValueError("Only notarised transactions can have a timestamp")
        self._check_not_signed()
        self._add_signer(self.notary.owning_key)
        self.timestamp = timestamp

    # -- signing & freezing ------------------------------------------------

    def sign_with(self, key: KeyPair) -> "TransactionBuilder":
        if any(s.by == key.public for s in self.current_sigs):
            raise ValueError("This partial transaction was already signed by that key")
        data = self._wire_cached().id
        self.current_sigs.append(key.sign(data.bytes))
        return self

    def check_signature(self, sig: DigitalSignature.WithKey) -> None:
        """Signature must match a command key and the tx contents
        (TransactionBuilder.kt:113-122)."""
        if not any(sig.by in c.keys for cmd in self.commands for c in cmd.signers):
            raise ValueError("Signature key doesn't match any command")
        sig.verify(self._wire_cached().id.bytes)

    def check_and_add_signature(self, sig: DigitalSignature.WithKey) -> None:
        self.check_signature(sig)
        self.add_signature_unchecked(sig)

    def add_signature_unchecked(self, sig: DigitalSignature.WithKey) -> "TransactionBuilder":
        self.current_sigs.append(sig)
        return self

    def to_wire_transaction(self) -> WireTransaction:
        return WireTransaction(
            inputs=tuple(self.inputs),
            attachments=tuple(self.attachments),
            outputs=tuple(self.outputs),
            commands=tuple(self.commands),
            notary=self.notary,
            signers=tuple(self.signers),
            type=self.type,
            timestamp=self.timestamp,
        )

    def to_signed_transaction(self, check_sufficient_signatures: bool = True) -> SignedTransaction:
        if check_sufficient_signatures:
            got = {s.by for s in self.current_sigs}
            missing = {ck for ck in self.signers if not ck.is_fulfilled_by(got)}
            if missing:
                raise ValueError(
                    f"Missing signatures on the transaction for: {sorted(missing, key=repr)}"
                )
        wtx = self._wire_cached()
        return SignedTransaction(tx_bits=wtx.serialized, sigs=tuple(self.current_sigs), id=wtx.id)


class NotaryChangeBuilder(TransactionBuilder):
    """Auto-adds input participants as signers (TransactionTypes.kt:129-140)."""

    def __init__(self, notary: Party):
        super().__init__(NotaryChangeTransactionType(), notary)

    def add_input_state(self, state_and_ref: StateAndRef) -> None:
        for participant in state_and_ref.state.data.participants:
            self._add_signer(participant)
        super().add_input_state(state_and_ref)
