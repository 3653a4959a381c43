"""Portfolio valuation agreement — the simm-valuation-demo shape.

The port's own copy of ``corda_tpu/tools/portfolio.py``.

Capability match for the reference's simm-valuation-demo flows (reference:
samples/simm-valuation-demo/src/main/kotlin/net/corda/vega/flows/SimmFlow.kt
— two parties deterministically value their shared portfolio and agree the
result on-ledger; PortfolioState/PortfolioValuation in .../contracts). The
margin number comes from the sensitivities-based fixed-point SIMM model in
corda_tpu_torch/tools/simm.py (per-trade tenor-bucket sensitivities +
risk-weight and correlation aggregation — the reference's AnalyticsEngine.kt pipeline in
integer arithmetic): both sides compute independently from the shared trades
and oracle fix, compare, and only an AGREED valuation reaches the ledger.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..contracts.dsl import require_that, select_command
from ..contracts.structures import (
    Command,
    Contract,
    DealState,
    TypeOnlyCommandData,
    UniqueIdentifier,
)
from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.finality import FinalityFlow
from ..flows.oracle import FixOf, RatesFixQueryFlow
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
# Codec registration: PortfolioState.trades holds simm.IRSTrade values, so
# any process loading the portfolio cordapp must be able to (de)serialize
# them — importing at module level registers the type (the lazy import
# inside compute_valuation runs too late for an inbound transaction).
from . import simm as _simm  # noqa: F401


@register
@dataclass(frozen=True)
class ValueCommand(TypeOnlyCommandData):
    pass


class PortfolioContract(Contract):
    def verify(self, tx) -> None:
        ins = [s for s in tx.inputs if isinstance(s, PortfolioState)]
        outs = [s for s in tx.outputs if isinstance(s, PortfolioState)]
        all_signers = {k for c in tx.commands for k in c.signers}
        if not ins:  # creation: unvalued portfolio appears
            with require_that() as req:
                req("a new portfolio starts unvalued",
                    all(o.valuation is None for o in outs))
                req("every participant signs the portfolio creation",
                    all(k in all_signers for o in outs
                        for k in o.participants))
            return
        value_cmd = select_command(tx.commands, ValueCommand)
        with require_that() as req:
            req("a valuation updates exactly one portfolio",
                len(ins) == 1 and len(outs) == 1)
            req("the valuation is set", outs[0].valuation is not None)
            req("the portfolio's trades are unchanged",
                replace(outs[0], valuation=None)
                == replace(ins[0], valuation=None))
            # The agreement is only an agreement if BOTH parties must sign —
            # the builder picks the signer list, so the contract enforces it.
            req("both parties sign the valuation",
                all(k in value_cmd.signers for k in ins[0].participants))

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.tools.Portfolio")


PORTFOLIO_PROGRAM_ID = PortfolioContract()


@register
@dataclass(frozen=True)
class PortfolioState(DealState):
    """The shared portfolio: trade notionals between two parties, plus the
    latest agreed valuation (PortfolioState capability)."""

    party_a: Party = None  # type: ignore[assignment]
    party_b: Party = None  # type: ignore[assignment]
    oracle: Party = None  # type: ignore[assignment]
    rate_ref: FixOf = None  # type: ignore[assignment]
    trades: tuple = ()  # tuple[simm.IRSTrade, ...]
    valuation: int | None = None
    uid: UniqueIdentifier = field(default_factory=UniqueIdentifier)

    @property
    def linear_id(self) -> UniqueIdentifier:
        return self.uid

    @property
    def contract(self) -> Contract:
        return PORTFOLIO_PROGRAM_ID

    @property
    def participants(self):
        return [self.party_a.owning_key, self.party_b.owning_key]

    @property
    def parties(self):
        return [self.party_a, self.party_b]


def compute_valuation(trades, rate: int) -> int:
    """The deterministic margin model both sides run independently: the
    sensitivities-based fixed-point SIMM pipeline (tools/simm.py) on the
    shared trades and the oracle's rate fix."""
    from .simm import initial_margin

    return initial_margin(trades, rate)


@register_flow
class SimmValuationFlow(FlowLogic):
    """party_a: fetch the rate, value the portfolio, and agree the valuation
    with party_b (who recomputes independently) — then notarise+broadcast."""

    def __init__(self, portfolio_ref):
        self.portfolio_ref = portfolio_ref

    def call(self):
        from ..contracts.structures import StateAndRef

        state = self.service_hub.load_state(self.portfolio_ref)
        if state is None:
            raise FlowException("unknown portfolio")
        sar = StateAndRef(state, self.portfolio_ref)
        portfolio = state.data
        me = self.service_hub.my_identity
        other = (portfolio.party_b if me == portfolio.party_a
                 else portfolio.party_a)

        fix = yield from self.sub_flow(
            RatesFixQueryFlow(portfolio.oracle, portfolio.rate_ref))
        my_valuation = compute_valuation(portfolio.trades, fix.value)

        # Consensus on the number BEFORE anything is signed (SimmFlow's
        # agree step): the counterparty recomputes and must match.
        response = yield self.send_and_receive(
            other, (self.portfolio_ref, my_valuation), object)
        reply = response.unwrap(lambda r: r)
        if reply != my_valuation:
            raise FlowException(
                f"valuations diverge: ours {my_valuation}, theirs {reply}")

        tx = TransactionBuilder(notary=sar.state.notary)
        tx.add_input_state(sar)
        tx.add_output_state(replace(portfolio, valuation=my_valuation))
        tx.add_command(Command(ValueCommand(),
                               (me.owning_key, other.owning_key)))
        tx.sign_with(self.service_hub.legal_identity_key)
        ptx = tx.to_signed_transaction(check_sufficient_signatures=False)
        response = yield self.send_and_receive(other, ptx, object)
        sig = response.unwrap(
            lambda s: self.check_counterparty_signature(
                s, ptx.id.bytes, other))
        stx = ptx.with_additional_signature(sig)
        final = yield from self.sub_flow(FinalityFlow(stx, (me, other)))
        return final


@register_flow
class SimmValuationResponder(FlowLogic):
    """party_b: recompute the valuation from the SAME oracle and only agree
    (and later sign) if the numbers match."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        from ..transactions.signed import SignedTransaction

        proposal = yield self.receive(self.other_party, object)
        ref, their_valuation = proposal.unwrap(self._shape)
        state = self.service_hub.load_state(ref)
        if state is None:
            raise FlowException("we do not hold this portfolio")
        portfolio = state.data
        fix = yield from self.sub_flow(
            RatesFixQueryFlow(portfolio.oracle, portfolio.rate_ref))
        my_valuation = compute_valuation(portfolio.trades, fix.value)
        yield self.send(self.other_party, my_valuation)
        if my_valuation != their_valuation:
            return None  # disagreement: nothing further to sign

        response = yield self.receive(self.other_party, SignedTransaction)
        ptx = response.unwrap(lambda p: self._validate(p, my_valuation))
        sig = self.service_hub.legal_identity_key.sign(ptx.id.bytes)
        yield self.send(self.other_party, sig)
        return None

    @staticmethod
    def _shape(payload):
        if (not isinstance(payload, tuple) or len(payload) != 2
                or not isinstance(payload[1], int)):
            raise FlowException("expected (portfolio_ref, valuation)")
        return payload

    def _validate(self, ptx, agreed_valuation):
        outs = [o.data for o in ptx.tx.outputs
                if isinstance(o.data, PortfolioState)]
        if len(outs) != 1 or outs[0].valuation != agreed_valuation:
            raise FlowException("transaction does not carry the agreed value")
        return ptx


def install_simm_responder(smm) -> None:
    smm.register_flow_initiator(
        "SimmValuationFlow", lambda party: SimmValuationResponder(party))
