"""Core ledger data types.

The port's own copy of ``corda_tpu/contracts/structures.py``.

Capability match for the reference's contract structures (reference:
core/src/main/kotlin/net/corda/core/contracts/Structures.kt): the UTXO state
model — states owned by composite keys, commands that instruct contracts,
state references forming the transaction DAG, and the marker interfaces
(Linear/Ownable/Schedulable/Deal/FungibleAsset) that services key off.

All types are frozen dataclasses registered with the canonical codec so their
serialized hashes are stable transaction-Merkle leaves.

Time is represented as integer epoch-microseconds (not floats/datetimes) so
timestamps serialize canonically.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field
from typing import Any, TYPE_CHECKING

from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import Party, PartyAndReference
from ..serialization.codec import register

if TYPE_CHECKING:
    from .verification import TransactionForContract

MICROS = 1_000_000

# Default clock-skew allowance for notarised timestamps (TimestampChecker's
# default). Flows that build time windows anchor their guards to this so
# "the flow refused" and "the notary refused" stay consistent.
DEFAULT_TIMESTAMP_TOLERANCE_MICROS = 30 * MICROS


def now_micros() -> int:
    return int(_time.time() * MICROS)


class ContractState:
    """A fact on the ledger. Implementations are frozen dataclasses.

    Reference: Structures.kt:64-136. `contract` is the program that governs
    state transitions; `participants` the keys that must sign any transaction
    consuming the state (used by vaults to decide relevance); `encumbrance`
    optionally ties consumption of this state to another output of the same
    transaction.
    """

    @property
    def contract(self) -> "Contract":
        raise NotImplementedError

    @property
    def participants(self) -> list[CompositeKey]:
        raise NotImplementedError

    @property
    def encumbrance(self) -> int | None:
        return None


class Contract:
    """Shared-ledger business logic (reference: Structures.kt:431-446).

    verify() must raise to reject a state transition; every contract mentioned
    by a transaction's states must accept it.
    """

    def verify(self, tx: "TransactionForContract") -> None:
        raise NotImplementedError

    @property
    def legal_contract_reference(self) -> SecureHash:
        raise NotImplementedError

    # Contracts are compared by type (stateless singletons), as in the
    # reference where contract classes are the unit of identity.
    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self).__qualname__)


@register
@dataclass(frozen=True, order=True)
class StateRef:
    """(tx id, output index) — a Bitcoin-style outpoint (Structures.kt:337)."""

    txhash: SecureHash
    index: int

    def __str__(self) -> str:
        return f"{self.txhash}({self.index})"


@register
@dataclass(frozen=True)
class TransactionState:
    """A ContractState plus the notary in whose custody it lives
    (Structures.kt:142-160)."""

    data: ContractState
    notary: Party

    def with_notary(self, new_notary: Party) -> "TransactionState":
        return TransactionState(self.data, new_notary)

    def out_ref(self, txhash: SecureHash, index: int) -> "StateAndRef":
        return StateAndRef(self, StateRef(txhash, index))


@register
@dataclass(frozen=True)
class StateAndRef:
    """A (state, ref) pair, e.g. a vault entry (Structures.kt:342)."""

    state: TransactionState
    ref: StateRef


class CommandData:
    """Marker base for command payloads (Structures.kt:358)."""


class TypeOnlyCommandData(CommandData):
    """Commands whose presence alone matters (Structures.kt:361-364)."""

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self).__qualname__)


class IssueCommand(CommandData):
    """Common issue command carrying an anti-replay nonce (Structures.kt:375)."""

    nonce: int


class MoveCommand(CommandData):
    """Common change-of-owner command (Structures.kt:382)."""

    contract_hash: SecureHash | None


@register
@dataclass(frozen=True)
class Command:
    """Command payload plus the keys that must sign for it (Structures.kt:367)."""

    value: CommandData
    signers: tuple[CompositeKey, ...]

    def __post_init__(self):
        if isinstance(self.signers, CompositeKey):
            object.__setattr__(self, "signers", (self.signers,))
        else:
            object.__setattr__(self, "signers", tuple(self.signers))
        if not self.signers:
            raise ValueError("Command requires at least one signer")


@register
@dataclass(frozen=True)
class AuthenticatedObject:
    """A value plus who signed it, with recognised parties resolved
    (Structures.kt:401)."""

    signers: tuple[CompositeKey, ...]
    signing_parties: tuple[Party, ...]
    value: Any


@register
@dataclass(frozen=True)
class Timestamp:
    """Notarised time window in epoch-microseconds (Structures.kt:412-425):
    the true commit time lies in (after, before)."""

    after: int | None
    before: int | None

    def __post_init__(self):
        if self.after is None and self.before is None:
            raise ValueError("At least one of before/after must be specified")
        if self.after is not None and self.before is not None and self.after > self.before:
            raise ValueError("after must be <= before")

    @staticmethod
    def around(time_micros: int, tolerance_micros: int) -> "Timestamp":
        return Timestamp(time_micros - tolerance_micros, time_micros + tolerance_micros)

    @property
    def midpoint(self) -> int:
        assert self.after is not None and self.before is not None
        return self.after + (self.before - self.after) // 2


@register
@dataclass(frozen=True)
class Issued:
    """'X issued by Y': definition of a claim against an issuer
    (Structures.kt:172-180)."""

    issuer: PartyAndReference
    product: Any

    def __str__(self) -> str:
        return f"{self.product} issued by {self.issuer}"


@register
@dataclass(frozen=True, order=True)
class UniqueIdentifier:
    """A linear-state id: optional external reference + unique internal id
    (reference: core/.../contracts/Structures.kt UniqueIdentifier in later
    snapshots; here id bytes replace a JVM UUID)."""

    external_id: str | None = None
    id: bytes = field(default_factory=lambda: os.urandom(16))

    def __str__(self) -> str:
        return f"{self.external_id}_{self.id.hex()}" if self.external_id else self.id.hex()


class OwnableState(ContractState):
    """A state with a singular owner that can be moved (Structures.kt:186)."""

    @property
    def owner(self) -> CompositeKey:
        raise NotImplementedError

    def with_new_owner(self, new_owner: CompositeKey) -> tuple[CommandData, "OwnableState"]:
        raise NotImplementedError


class LinearState(ContractState):
    """A state standing in for a evolving fact-thread on the ledger, tracked
    by linear_id across transactions (Structures.kt:226-246)."""

    @property
    def linear_id(self) -> UniqueIdentifier:
        raise NotImplementedError

    def is_relevant(self, our_keys: set) -> bool:
        raise NotImplementedError


class SchedulableState(ContractState):
    """A state that can request a flow run at a future time
    (Structures.kt:259-270)."""

    def next_scheduled_activity(self, this_state_ref: StateRef, flow_factory) -> Any | None:
        raise NotImplementedError


class DealState(LinearState):
    """A deal between parties that can be regenerated (Structures.kt:276-300)."""

    @property
    def parties(self) -> list[Party]:
        raise NotImplementedError


class FungibleAsset(OwnableState):
    """An asset splittable/mergeable by amount, e.g. cash or commodities
    (reference: core/.../contracts/FungibleAsset.kt:23)."""

    @property
    def amount(self):
        raise NotImplementedError

    @property
    def exit_keys(self) -> list[CompositeKey]:
        raise NotImplementedError


class NamedByHash:
    """Anything content-addressed by a SecureHash (Structures.kt:22)."""

    @property
    def id(self) -> SecureHash:
        raise NotImplementedError


class Attachment(NamedByHash):
    """A content-addressed blob of public static data referenced by
    transactions (Structures.kt:459-475)."""

    def open(self) -> bytes:
        raise NotImplementedError
