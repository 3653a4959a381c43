"""TwoPartyDealFlow: agree a bilateral deal and put it on-ledger.

The port's own copy of ``corda_tpu/flows/deal.py``.

Capability match for the reference's TwoPartyDealFlow (reference:
core/src/main/kotlin/net/corda/flows/TwoPartyDealFlow.kt — the generic
instigator/acceptor handshake under the IRS demo's deal creation): the
instigator proposes a DealState, the acceptor validates it (it must be a
party to the deal; an app-supplied validator checks the terms), both sign,
the instigator notarises and broadcasts.

Responder wiring (app side):
    smm.register_flow_initiator("DealInstigatorFlow",
        lambda party: DealAcceptorFlow(party, validator=my_check))
"""

from __future__ import annotations

from dataclasses import dataclass

from ..contracts.structures import Command, DealState
from ..crypto.keys import DigitalSignature
from ..crypto.party import Party
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from ..transactions.signed import SignedTransaction
from .api import FlowException, FlowLogic, register_flow
from .finality import FinalityFlow


@register
@dataclass(frozen=True)
class DealHandshake:
    """The proposal: a partially-signed transaction creating the deal."""

    ptx: SignedTransaction


@register_flow
class DealInstigatorFlow(FlowLogic):
    def __init__(self, other_party: Party, deal: DealState,
                 deal_command, notary: Party):
        self.other_party = other_party
        self.deal = deal
        self.deal_command = deal_command
        self.notary = notary

    def call(self):
        me = self.service_hub.my_identity.owning_key
        them = self.other_party.owning_key
        tx = TransactionBuilder(notary=self.notary)
        tx.add_output_state(self.deal)
        tx.add_command(Command(self.deal_command, (me, them)))
        tx.sign_with(self.service_hub.legal_identity_key)
        ptx = tx.to_signed_transaction(check_sufficient_signatures=False)

        response = yield self.send_and_receive(
            self.other_party, DealHandshake(ptx), DigitalSignature.WithKey)
        sig = response.unwrap(
            lambda s: self.check_counterparty_signature(
                s, ptx.id.bytes, self.other_party))
        stx = ptx.with_additional_signature(sig)
        final = yield from self.sub_flow(FinalityFlow(
            stx, (self.service_hub.my_identity, self.other_party)))
        return final



@register_flow
class DealAcceptorFlow(FlowLogic):
    """Subclass and override validate_terms (and register the subclass) to
    impose app-level acceptance rules — a METHOD, not an injected callable,
    because constructor args are checkpointed and callables cannot round-trip
    through a checkpoint (the reference's Acceptor is likewise abstract)."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        response = yield self.receive(self.other_party, DealHandshake)
        handshake = response.unwrap(self._validate)
        sig = self.service_hub.legal_identity_key.sign(handshake.ptx.id.bytes)
        yield self.send(self.other_party, sig)
        return handshake.ptx.id

    def validate_terms(self, deal: DealState) -> None:
        """App hook: raise FlowException to refuse the deal."""

    def _validate(self, handshake) -> "DealHandshake":
        if not isinstance(handshake, DealHandshake):
            raise FlowException("expected a DealHandshake")
        wtx = handshake.ptx.tx
        deals = [o.data for o in wtx.outputs if isinstance(o.data, DealState)]
        if len(deals) != 1:
            raise FlowException("proposal must create exactly one deal")
        deal = deals[0]
        me = self.service_hub.my_identity
        if me not in deal.parties:
            raise FlowException("we are not a party to the proposed deal")
        if wtx.inputs:
            raise FlowException("deal creation must not consume states")
        self.validate_terms(deal)
        return handshake
