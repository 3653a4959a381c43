"""State replacement + notary change: move a state to new terms by unanimous
consent of its participants.

The port's own copy of ``corda_tpu/flows/state_replacement.py``.

Capability match for the reference's AbstractStateReplacementFlow and
NotaryChangeFlow (reference: core/src/main/kotlin/net/corda/flows/
AbstractStateReplacementFlow.kt, NotaryChangeFlow.kt): the instigator builds
a replacement transaction, gathers a signature from every other participant
(each acceptor independently validates the proposal before signing), then
notarises and broadcasts. NotaryChange is the concrete instance: the
replacement moves the state to a different notary and the platform's
NotaryChangeTransactionType rules (TransactionTypes.kt:123-160 equivalent at
corda_tpu_torch/transactions/types.py) enforce that NOTHING but the notary changed.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..contracts.structures import StateAndRef, StateRef
from ..crypto.keys import DigitalSignature
from ..crypto.party import Party
from ..serialization.codec import register
from ..transactions.builder import NotaryChangeBuilder
from ..transactions.signed import SignedTransaction
from .api import FlowException, FlowLogic, register_flow
from .finality import FinalityFlow
from .notary import notarise_with_retry


class StateReplacementException(FlowException):
    pass


@register
@dataclass(frozen=True)
class ReplacementProposal:
    """What the instigator sends each participant: the state being replaced,
    the modification (here: the new notary), and the proposed transaction."""

    state_ref: StateRef
    new_notary: Party
    stx: SignedTransaction


@register_flow
class NotaryChangeFlow(FlowLogic):
    """Instigator (NotaryChangeFlow.kt capability): propose, collect
    signatures from all other participants, notarise with the ORIGINAL
    notary, broadcast. Returns the replacement StateAndRef."""

    def __init__(self, state: StateAndRef, new_notary: Party):
        self.state = state
        self.new_notary = new_notary

    def call(self):
        old_notary = self.state.state.notary
        if old_notary == self.new_notary:
            raise StateReplacementException(
                "The new notary is the same as the current one")
        # The OLD notary notarises the change (it controls the consumed
        # input); only the OUTPUT state moves to the new notary.
        tx = NotaryChangeBuilder(old_notary)
        tx.add_input_state(self.state)
        tx.add_output_state(self.state.state.with_notary(self.new_notary),
                            notary=self.new_notary)
        tx.sign_with(self.service_hub.legal_identity_key)
        stx = tx.to_signed_transaction(check_sufficient_signatures=False)

        my_key = self.service_hub.my_identity.owning_key
        proposal = ReplacementProposal(self.state.ref, self.new_notary, stx)
        parties = []
        for participant in self.state.state.data.participants:
            if participant == my_key:
                continue
            party = self.service_hub.identity_service.party_from_key(participant)
            if party is None:
                raise StateReplacementException(
                    f"no identity known for participant {participant!r}")
            parties.append(party)
        for party in parties:
            response = yield self.send_and_receive(
                party, proposal, DigitalSignature.WithKey)
            sig = response.unwrap(lambda s: self._check_sig(s, stx))
            stx = stx.with_additional_signature(sig)

        # Notarise with the OLD notary (it controls the consumed state) and
        # broadcast to everyone involved.
        notary_sig = yield from notarise_with_retry(self, stx)
        final = stx.with_additional_signature(notary_sig)
        yield from self.sub_flow(FinalityFlow(
            final, tuple(parties) + (self.service_hub.my_identity,)))
        return final.tx.out_ref(0)

    @staticmethod
    def _check_sig(sig, stx):
        if not isinstance(sig, DigitalSignature.WithKey):
            raise StateReplacementException("expected a signature")
        sig.verify(stx.id.bytes)
        return sig


@register_flow
class NotaryChangeAcceptor(FlowLogic):
    """Acceptor: validate that the proposal changes ONLY the notary of a
    state we co-own, then sign (AbstractStateReplacementFlow.Acceptor)."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        response = yield self.receive(self.other_party, ReplacementProposal)
        proposal = response.unwrap(self._validate)
        sig = self.service_hub.legal_identity_key.sign(proposal.stx.id.bytes)
        yield self.send(self.other_party, sig)
        return None

    def _validate(self, proposal) -> "ReplacementProposal":
        if not isinstance(proposal, ReplacementProposal):
            raise StateReplacementException("expected a ReplacementProposal")
        wtx = proposal.stx.tx
        from ..transactions.types import NotaryChangeTransactionType

        if not isinstance(wtx.type, NotaryChangeTransactionType):
            raise StateReplacementException(
                "proposal is not a notary-change transaction")
        if list(wtx.inputs) != [proposal.state_ref]:
            raise StateReplacementException(
                "proposal consumes unexpected states")
        if any(out.notary != proposal.new_notary for out in wtx.outputs):
            raise StateReplacementException(
                "output notary does not match the proposal")
        my_key = self.service_hub.my_identity.owning_key
        if not any(my_key in out.data.participants for out in wtx.outputs):
            raise StateReplacementException(
                "we are not a participant in the replacement state")
        return proposal


def install_notary_change_acceptor(smm) -> None:
    """Auto-accept notary changes we participate in (the reference registers
    the acceptor's flow factory the same way)."""
    smm.register_flow_initiator(
        "NotaryChangeFlow", lambda party: NotaryChangeAcceptor(party))
