"""Fixable deals: scheduled oracle fixings on a bilateral contract.

The port's own copy of ``corda_tpu/finance/fixable_deal.py``.

Capability match for the irs-demo's fixing machinery (reference:
samples/irs-demo/src/main/kotlin/net/corda/irs/contract/IRS.kt — the
FixableDealState shape — and flows/FixingFlow.kt + api/NodeInterestRates.kt:
when a fixing date arrives the scheduler launches a flow that queries the
rate oracle, embeds the Fix as a command, collects the counterparty's and
the oracle's signatures over a commands-only tear-off, and notarises).

This is the full composition the reference's flagship demo exercises:
SchedulableState -> NodeSchedulerService -> oracle query -> Fix command ->
tear-off signature -> bilateral signing -> notarisation -> broadcast.
The cashflow maths of a real swap is out of scope (simm/OpenGamma tier);
the deal simply records its fixed rate.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..contracts.dsl import require_that, select_command
from ..contracts.structures import (
    Command,
    Contract,
    DealState,
    SchedulableState,
    StateRef,
    UniqueIdentifier,
)
from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.finality import FinalityFlow
from ..flows.oracle import Fix, FixOf, RatesFixQueryFlow, RatesFixSignFlow
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from ..transactions.signed import SignedTransaction


class FixableDealContract(Contract):
    def verify(self, tx) -> None:
        deals_in = [s for s in tx.inputs if isinstance(s, FixableDealState)]
        deals_out = [s for s in tx.outputs if isinstance(s, FixableDealState)]
        all_signers = {k for c in tx.commands for k in c.signers}
        if not deals_in:
            # Deal CREATION: the agreement tx puts unfixed deals on ledger;
            # every participant must be a DECLARED signer (the builder
            # chooses the signer list, so the contract — not must_sign —
            # is what forces both parties' signatures onto the tx).
            with require_that() as req:
                req("a new deal starts unfixed",
                    all(d.fixed_value is None for d in deals_out))
                req("a deal-creation produces at least one deal",
                    bool(deals_out))
                req("every participant signs the deal creation",
                    all(k in all_signers for d in deals_out
                        for k in d.participants))
            return
        fix_cmd = select_command(tx.commands, Fix)
        with require_that() as req:
            req("a fixing consumes exactly one unfixed deal",
                len(deals_in) == 1 and deals_in[0].fixed_value is None)
            req("a fixing produces exactly one fixed deal",
                len(deals_out) == 1 and deals_out[0].fixed_value is not None)
            if deals_in and deals_out:
                before, after = deals_in[0], deals_out[0]
                req("the fixed value equals the oracle's Fix command",
                    after.fixed_value == fix_cmd.value.value
                    and fix_cmd.value.of == before.fix_of)
                req("terms other than the fixed value are unchanged",
                    replace(after, fixed_value=None) == before)
                # Signer rule: both parties AND the oracle must be declared
                # Fix-command signers — listing the oracle makes must_sign
                # demand its transaction signature, so a unilateral
                # fabricated rate cannot commit.
                req("both parties sign the fixing",
                    before.party_a.owning_key in fix_cmd.signers
                    and before.party_b.owning_key in fix_cmd.signers)
                req("the oracle attests the fixing",
                    before.oracle.owning_key in fix_cmd.signers)

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.finance.FixableDeal")


FIXABLE_DEAL_PROGRAM_ID = FixableDealContract()


@register
@dataclass(frozen=True)
class FixableDealState(DealState, SchedulableState):
    """A bilateral deal awaiting a rate fixing at fix_at_micros (IRS.kt's
    FixableDealState shape, one fixing for brevity)."""

    party_a: Party = None  # type: ignore[assignment]  # floating-leg payer:
    # its node runs the scheduled fixing (FixingFlow.kt picks the floater)
    party_b: Party = None  # type: ignore[assignment]
    oracle: Party = None  # type: ignore[assignment]
    fix_of: FixOf = None  # type: ignore[assignment]
    fix_at_micros: int = 0
    notional: int = 0
    fixed_value: int | None = None
    uid: UniqueIdentifier = field(default_factory=UniqueIdentifier)

    @property
    def linear_id(self) -> UniqueIdentifier:
        return self.uid

    @property
    def contract(self) -> Contract:
        return FIXABLE_DEAL_PROGRAM_ID

    @property
    def participants(self):
        return [self.party_a.owning_key, self.party_b.owning_key]

    @property
    def parties(self):
        return [self.party_a, self.party_b]

    def next_scheduled_activity(self, this_state_ref: StateRef, flow_factory):
        from ..node.services.scheduler import ScheduledActivity

        if self.fixed_value is not None:
            return None
        return ScheduledActivity("FixingFlow", (this_state_ref,),
                                 self.fix_at_micros)


@register_flow
class FixingFlow(FlowLogic):
    """Scheduler-launched on party_a's node when the fixing falls due:
    query the oracle, build the fixing transaction, gather the oracle's
    tear-off signature and the counterparty's signature, notarise and
    broadcast (FixingFlow.kt capability)."""

    def __init__(self, state_ref: StateRef):
        self.state_ref = state_ref

    def call(self):
        sar = self._load()
        deal = sar.state.data
        me = self.service_hub.my_identity
        if me != deal.party_a:
            # BOTH participants' schedulers fire (each vault holds the deal);
            # only the floating-leg payer acts — the other side exits quietly
            # rather than erroring a flow per fixing.
            return None
        other = deal.party_b

        fix = yield from self.sub_flow(
            RatesFixQueryFlow(deal.oracle, deal.fix_of))

        tx = TransactionBuilder(notary=sar.state.notary)
        tx.add_input_state(sar)
        tx.add_output_state(replace(deal, fixed_value=fix.value))
        tx.add_command(Command(fix, (me.owning_key, other.owning_key,
                                     deal.oracle.owning_key)))
        tx.sign_with(self.service_hub.legal_identity_key)
        ptx = tx.to_signed_transaction(check_sufficient_signatures=False)

        oracle_sig = yield from self.sub_flow(
            RatesFixSignFlow(deal.oracle, ptx))
        ptx = ptx.with_additional_signature(oracle_sig)

        response = yield self.send_and_receive(other, ptx, object)
        their_sig = response.unwrap(
            lambda s: self.check_counterparty_signature(
                s, ptx.id.bytes, other))
        stx = ptx.with_additional_signature(their_sig)
        final = yield from self.sub_flow(
            FinalityFlow(stx, (me, other)))
        return final

    def _load(self):
        state = self.service_hub.load_state(self.state_ref)
        if state is None:
            raise FlowException(f"unknown state {self.state_ref}")
        from ..contracts.structures import StateAndRef

        return StateAndRef(state, self.state_ref)



@register_flow
class FixingAcceptorFlow(FlowLogic):
    """party_b: validate that the proposed fixing only sets fixed_value to
    the oracle-signed Fix, then co-sign."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        response = yield self.receive(self.other_party, SignedTransaction)
        ptx = response.unwrap(self._validate)
        sig = self.service_hub.legal_identity_key.sign(ptx.id.bytes)
        yield self.send(self.other_party, sig)
        return None

    def _validate(self, ptx) -> SignedTransaction:
        if not isinstance(ptx, SignedTransaction):
            raise FlowException("expected a SignedTransaction")
        wtx = ptx.tx
        deals = [o.data for o in wtx.outputs
                 if isinstance(o.data, FixableDealState)]
        if len(deals) != 1 or deals[0].fixed_value is None:
            raise FlowException("proposal does not fix exactly one deal")
        deal = deals[0]
        me = self.service_hub.my_identity
        if me not in deal.parties:
            raise FlowException("we are not a party to this deal")
        # The oracle must already have signed the tx (over its tear-off).
        oracle_keys = deal.oracle.owning_key.keys
        if not any(sig.by in oracle_keys for sig in ptx.sigs):
            raise FlowException("missing the oracle's signature")
        fixes = [c.value for c in wtx.commands if isinstance(c.value, Fix)]
        if len(fixes) != 1 or fixes[0].value != deal.fixed_value:
            raise FlowException("fix command does not match the fixed value")
        if fixes[0].of != deal.fix_of:
            # The oracle signature only proves SOME fix is genuine — it must
            # be the fix THIS deal references, or a cheaper instrument's rate
            # could be substituted.
            raise FlowException("fix is for a different instrument")
        return ptx


def install_fixing_acceptor(smm) -> None:
    smm.register_flow_initiator(
        "FixingFlow", lambda party: FixingAcceptorFlow(party))
