"""Contract-facing transaction view and verification exceptions.

The port's own copy of ``corda_tpu/contracts/verification.py``.

Capability match for the reference's TransactionForContract and
TransactionVerificationException hierarchy (reference:
core/src/main/kotlin/net/corda/core/contracts/TransactionVerification.kt).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from .structures import (
    Attachment,
    AuthenticatedObject,
    ContractState,
    Timestamp,
)


class TransactionVerificationException(Exception):
    """Base for all platform-level transaction verification failures
    (reference: TransactionVerification.kt:30-80)."""

    def __init__(self, tx_id: SecureHash | None, message: str):
        super().__init__(message)
        self.tx_id = tx_id


class ContractRejection(TransactionVerificationException):
    def __init__(self, tx_id, contract, cause: Exception):
        super().__init__(tx_id, f"Contract verification failed: {cause}")
        self.contract = contract
        self.cause = cause


class MoreThanOneNotary(TransactionVerificationException):
    def __init__(self, tx_id):
        super().__init__(tx_id, "More than one notary in the transaction inputs")


class SignersMissing(TransactionVerificationException):
    def __init__(self, tx_id, missing):
        super().__init__(tx_id, f"Signers missing: {missing}")
        self.missing = missing


class NotaryChangeInWrongTransactionType(TransactionVerificationException):
    def __init__(self, tx_id, output_notary):
        super().__init__(
            tx_id, f"Outputs posted to a different notary {output_notary} in a general transaction"
        )
        self.output_notary = output_notary


class InvalidNotaryChange(TransactionVerificationException):
    def __init__(self, tx_id):
        super().__init__(tx_id, "Invalid notary change: states modified beyond the notary field")


class TransactionMissingEncumbranceException(TransactionVerificationException):
    INPUT = "input"
    OUTPUT = "output"

    def __init__(self, tx_id, missing: int, direction: str):
        super().__init__(tx_id, f"Missing required encumbrance {missing} in {direction}s")
        self.missing = missing
        self.direction = direction


class TransactionResolutionException(Exception):
    """An input StateRef points at a transaction we don't have
    (reference: Structures.kt TransactionResolutionException)."""

    def __init__(self, hash_: SecureHash):
        super().__init__(f"Transaction resolution failure for {hash_}")
        self.hash = hash_


class AttachmentResolutionException(Exception):
    def __init__(self, hash_: SecureHash):
        super().__init__(f"Attachment resolution failure for {hash_}")
        self.hash = hash_


@dataclass(frozen=True)
class InOutGroup:
    """Matched input/output states sharing a grouping key
    (TransactionVerification.kt:85)."""

    inputs: tuple[ContractState, ...]
    outputs: tuple[ContractState, ...]
    grouping_key: Any


@dataclass(frozen=True)
class TransactionForContract:
    """The stripped-down transaction view handed to Contract.verify
    (TransactionVerification.kt:15-84)."""

    inputs: tuple[ContractState, ...]
    outputs: tuple[ContractState, ...]
    attachments: tuple[Attachment, ...]
    commands: tuple[AuthenticatedObject, ...]
    id: SecureHash
    notary: Party | None
    timestamp: Timestamp | None = None
    in_states: tuple = field(default=())  # reserved

    def group_states(
        self, of_type: type, grouping_key: Callable[[ContractState], Any]
    ) -> list[InOutGroup]:
        """Fungible-state verification utility (TransactionVerification.kt:48-84):
        partition inputs and outputs by a key (e.g. (currency, issuer)) so each
        group can be conservation-checked independently."""
        in_groups: dict[Any, list[ContractState]] = {}
        out_groups: dict[Any, list[ContractState]] = {}
        for s in self.inputs:
            if isinstance(s, of_type):
                in_groups.setdefault(grouping_key(s), []).append(s)
        for s in self.outputs:
            if isinstance(s, of_type):
                out_groups.setdefault(grouping_key(s), []).append(s)
        result = []
        for k in dict.fromkeys(list(in_groups) + list(out_groups)):
            result.append(
                InOutGroup(tuple(in_groups.get(k, ())), tuple(out_groups.get(k, ())), k)
            )
        return result

    def get_timestamp_by(self, timestamp_authority: Party) -> Timestamp | None:
        """The timestamp, but only if this tx is notarised by the given
        authority (TransactionVerification.kt timestamp accessor)."""
        if self.notary == timestamp_authority:
            return self.timestamp
        return None
