"""The dummy contract: accepts everything, exists for tests and demos.

The port's own copy of ``corda_tpu/testing/dummies.py``: its states and
commands register under the JAX package's wire names, so transactions made
by either package deserialize in the other.

Capability match for the reference's DummyContract (reference:
core/src/main/kotlin/net/corda/core/contracts/DummyContract.kt) — also the
workload contract of the raft-notary-demo benchmark
(samples/raft-notary-demo/.../NotaryDemoApi).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..contracts.structures import (
    Command,
    ContractState,
    Contract,
    OwnableState,
    StateAndRef,
    TypeOnlyCommandData,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import Party, PartyAndReference
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder


@register
@dataclass(frozen=True)
class DummyCreate(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class DummyMove(TypeOnlyCommandData):
    pass


class DummyContract(Contract):
    def verify(self, tx) -> None:
        pass  # Always accepts.

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"")

    @staticmethod
    def generate_initial(
        owner: PartyAndReference, magic_number: int, notary: Party
    ) -> TransactionBuilder:
        state = DummySingleOwnerState(magic_number, owner.party.owning_key)
        tx = TransactionBuilder(notary=notary)
        tx.add_output_state(state)
        tx.add_command(Command(DummyCreate(), (owner.party.owning_key,)))
        return tx

    @staticmethod
    def move(priors: list[StateAndRef] | StateAndRef, new_owner: CompositeKey) -> TransactionBuilder:
        if isinstance(priors, StateAndRef):
            priors = [priors]
        if not priors:
            raise ValueError("need at least one prior state")
        prior = priors[0].state.data
        cmd, new_state = prior.with_new_owner(new_owner)
        tx = TransactionBuilder(notary=priors[0].state.notary)
        for p in priors:
            tx.add_input_state(p)
        tx.add_command(Command(cmd, (prior.owner,)))
        tx.add_output_state(new_state)
        return tx

    @staticmethod
    def generate_initial_multi(
        owners: tuple[CompositeKey, ...], magic_number: int, notary: Party
    ) -> TransactionBuilder:
        """Issue a multi-owner state (DummyContract.kt MultiOwnerState): a
        move of it needs a signature from EVERY owner — the fan-out-verify
        workload shape (BASELINE config 4; NotaryDemo firehose widened)."""
        state = DummyMultiOwnerState(magic_number, tuple(owners))
        tx = TransactionBuilder(notary=notary)
        tx.add_output_state(state)
        tx.add_command(Command(DummyCreate(), tuple(owners)))
        return tx

    @staticmethod
    def move_multi(prior: StateAndRef,
                   new_owners: tuple[CompositeKey, ...]) -> TransactionBuilder:
        """Move a multi-owner state; signers = every current owner, so the
        transaction carries len(owners) signatures through the verify pump."""
        prior_state = prior.state.data
        if not isinstance(prior_state, DummyMultiOwnerState):
            raise ValueError("move_multi needs a DummyMultiOwnerState input")
        tx = TransactionBuilder(notary=prior.state.notary)
        tx.add_input_state(prior)
        tx.add_command(Command(DummyMove(), tuple(prior_state.owners)))
        tx.add_output_state(DummyMultiOwnerState(
            prior_state.magic_number, tuple(new_owners)))
        return tx


DUMMY_PROGRAM_ID = DummyContract()


@register
@dataclass(frozen=True)
class DummySingleOwnerState(OwnableState):
    magic_number: int = 0
    owner: CompositeKey = None  # type: ignore[assignment]

    @property
    def contract(self) -> Contract:
        return DUMMY_PROGRAM_ID

    @property
    def participants(self) -> list[CompositeKey]:
        return [self.owner]

    def with_new_owner(self, new_owner: CompositeKey):
        return DummyMove(), replace(self, owner=new_owner)


@register
@dataclass(frozen=True)
class DummyMultiOwnerState(ContractState):
    magic_number: int = 0
    owners: tuple[CompositeKey, ...] = ()

    @property
    def contract(self) -> Contract:
        return DUMMY_PROGRAM_ID

    @property
    def participants(self) -> list[CompositeKey]:
        return list(self.owners)
