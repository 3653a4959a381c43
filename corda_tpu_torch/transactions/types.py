"""Transaction types: platform-level validity rules per kind of transaction.

The port's own copy of ``corda_tpu/transactions/types.py``.

Capability match for the reference's TransactionType (reference:
core/src/main/kotlin/net/corda/core/contracts/TransactionTypes.kt:20-160):
General transactions run contract code; NotaryChange transactions move states
between notaries without contract involvement. Both enforce signer
completeness and single-notary rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from ..contracts.verification import (
    ContractRejection,
    InvalidNotaryChange,
    MoreThanOneNotary,
    NotaryChangeInWrongTransactionType,
    SignersMissing,
    TransactionMissingEncumbranceException,
)
from ..serialization.codec import register

if TYPE_CHECKING:
    from .ledger import LedgerTransaction


@dataclass(frozen=True)
class TransactionType:
    """Base: shared platform checks (TransactionTypes.kt:20-45)."""

    def verify(self, tx: "LedgerTransaction") -> None:
        """Platform rules + type rules. Presence of signatures is NOT checked
        here — only that the signer *list* covers what's required.
        (Timestamp-requires-notary is enforced by the transaction
        constructors themselves.)"""
        missing = self.verify_signers(tx)
        if missing:
            raise SignersMissing(tx.id, sorted(missing, key=repr))
        self.verify_transaction(tx)

    def verify_signers(self, tx: "LedgerTransaction") -> set:
        notary_keys = {inp.state.notary.owning_key for inp in tx.inputs}
        if len(notary_keys) > 1:
            raise MoreThanOneNotary(tx.id)
        required = self.get_required_signers(tx) | notary_keys
        return required - set(tx.must_sign)

    def get_required_signers(self, tx: "LedgerTransaction") -> set:
        raise NotImplementedError

    def verify_transaction(self, tx: "LedgerTransaction") -> None:
        raise NotImplementedError


@register
@dataclass(frozen=True)
class GeneralTransactionType(TransactionType):
    """Validity determined by contract code (TransactionTypes.kt:47-121)."""

    def get_required_signers(self, tx):
        return {k for cmd in tx.commands for k in cmd.signers}

    def verify_transaction(self, tx):
        self._verify_no_notary_change(tx)
        self._verify_encumbrances(tx)
        self._verify_contracts(tx)

    @staticmethod
    def _verify_no_notary_change(tx):
        # With inputs present, all outputs must stay on the same notary
        # (TransactionTypes.kt:60-74).
        if tx.notary is not None and tx.inputs:
            for out in tx.outputs:
                if out.notary != tx.notary:
                    raise NotaryChangeInWrongTransactionType(tx.id, out.notary)

    @staticmethod
    def _verify_encumbrances(tx):
        # Encumbered inputs must bring their encumbrance state along; output
        # encumbrance indices must point at a *different*, existing output
        # (TransactionTypes.kt:76-100).
        for inp in tx.inputs:
            enc = inp.state.data.encumbrance
            if enc is None:
                continue
            present = any(
                other.ref.txhash == inp.ref.txhash and other.ref.index == enc
                for other in tx.inputs
            )
            if not present:
                raise TransactionMissingEncumbranceException(
                    tx.id, enc, TransactionMissingEncumbranceException.INPUT
                )
        for i, out in enumerate(tx.outputs):
            enc = out.data.encumbrance
            if enc is None:
                continue
            if enc == i or enc >= len(tx.outputs):
                raise TransactionMissingEncumbranceException(
                    tx.id, enc, TransactionMissingEncumbranceException.OUTPUT
                )

    @staticmethod
    def _verify_contracts(tx):
        # Run every mentioned contract; any failure rejects the whole tx
        # (TransactionTypes.kt:106-117).
        ctx = tx.to_transaction_for_contract()
        contracts = []
        for s in list(ctx.inputs) + list(ctx.outputs):
            if s.contract not in contracts:
                contracts.append(s.contract)
        for contract in contracts:
            try:
                contract.verify(ctx)
            except Exception as e:
                raise ContractRejection(tx.id, contract, e) from e


@register
@dataclass(frozen=True)
class NotaryChangeTransactionType(TransactionType):
    """Reassign states to a new notary; no contract code runs
    (TransactionTypes.kt:123-160)."""

    def get_required_signers(self, tx):
        return {k for inp in tx.inputs for k in inp.state.data.participants}

    def verify_transaction(self, tx):
        ok = (
            len(tx.inputs) == len(tx.outputs)
            and not tx.commands
            and all(
                inp.state.data == out.data and inp.state.notary != out.notary
                for inp, out in zip(tx.inputs, tx.outputs)
            )
        )
        if not ok:
            raise InvalidNotaryChange(tx.id)
