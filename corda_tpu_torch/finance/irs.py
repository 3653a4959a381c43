"""Interest-rate swap modelled as a universal-contract product.

The port's own copy of ``corda_tpu/finance/irs.py``.

Capability match for the reference's IRS modelling (reference:
samples/irs-demo/src/main/kotlin/net/corda/contracts/IRS.kt — the bespoke
~700-line contract — and experimental/src/test/kotlin/net/corda/contracts/
universal/IRS.kt, which re-expresses the same product in ~40 lines of the
universal DSL). This framework takes the universal route as the primary
representation: the full cashflow schedule is a ``RollOut`` whose per-period
template nets the floating leg (LIBOR-fixed via the oracle machinery of
flows/oracle.py) against the fixed leg, so the whole lifecycle — fix the
period's rate, pay the net amount, roll to the next period — is driven by
the one generic ``UniversalContract`` with no product-specific code.

Lifecycle per period (each step is an on-ledger transition):

1. ``UApplyFixes`` substitutes the period's LIBOR fixing (attested by the
   oracle key the product pins) into the reduced-period arrangement.
2. ``UAction "pay floating"`` (or ``"pay fixed"``) nets the legs: the payer
   transfers ``|floating − fixed|`` and the state rolls to the remaining
   schedule via the spliced ``Continuation``.
"""

from __future__ import annotations

from ..contracts.structures import (
    Command,
    StateAndRef,
    StateRef,
    Timestamp,
    now_micros,
)
from ..contracts.universal import (
    Actions,
    All,
    Const,
    Continuation,
    EndDate,
    GTE,
    Interest,
    PosPart,
    RollOut,
    StartDate,
    TimeCondition,
    Transfer,
    UAction,
    UApplyFixes,
    UniversalState,
    actions_of,
    all_of,
    arrange,
    after,
    collect_fixings,
    eval_amount,
    fixing,
    involved_parties,
    reduce_rollout,
    replace_fixings,
    transfer,
    _DAY_MICROS,
)
from ..crypto.composite import CompositeKey
from ..crypto.party import Party
from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.finality import FinalityFlow
from ..flows.oracle import FixOf, RatesFixQueryFlow, RatesFixSignFlow
from ..transactions.builder import TransactionBuilder
from .types import Tenor


def interest_rate_swap(
    notional: int,                 # fixed-point quanta (universal.SCALE)
    currency: str,
    fixed_rate: int,               # percent, fixed-point (e.g. 0.5% = SCALE//2)
    floating_index: str,           # e.g. "LIBOR"
    index_tenor: str,              # e.g. "3M"
    oracle: Party | CompositeKey,  # who may attest the index fixing
    fixed_leg_payer: Party,
    floating_leg_payer: Party,
    start_day: int,
    end_day: int,
    frequency: Tenor = Tenor("3M"),
    day_count: str = "ACT/365",
) -> RollOut:
    """The reference experimental IRS arrangement (universal/IRS.kt
    contractInitial), with one deliberate hardening: the reference offers
    two separate "pay floating"/"pay fixed" actions, which lets the debtor
    exercise the out-of-the-money action (netting to zero under PosPart) and
    discharge the period without paying. Here each period has a single
    ``settle`` action that carries BOTH clamped directions — whichever party
    exercises it, the in-the-money leg transfers the positive net and the
    mirror leg transfers zero, so the true net always lands on ledger."""
    floating = Interest(Const(notional), day_count,
                        fixing(floating_index, StartDate(), index_tenor,
                               oracle),
                        StartDate(), EndDate())
    fixed = Interest(Const(notional), day_count, Const(fixed_rate),
                     StartDate(), EndDate())
    parties = {fixed_leg_payer, floating_leg_payer}
    template = Actions(frozenset({
        arrange("settle", after(EndDate()), parties,
                all_of(transfer(PosPart(floating - fixed), currency,
                                floating_leg_payer, fixed_leg_payer),
                       transfer(PosPart(fixed - floating), currency,
                                fixed_leg_payer, floating_leg_payer),
                       Continuation())),
    }))
    return RollOut(start_day, end_day, frequency, template)


# ---------------------------------------------------------------------------
# Network flows: the swap's period lifecycle over real sessions
# (reference: samples/irs-demo/.../flows/FixingFlow.kt capability, re-hosted
# on the universal contract so one flow pair serves every RollOut product)
# ---------------------------------------------------------------------------


def _participants(arrangement) -> tuple:
    return tuple(sorted(involved_parties(arrangement),
                        key=lambda k: k.to_base58_string()))


def _load_sar(flow: FlowLogic, ref: StateRef) -> StateAndRef:
    state = flow.service_hub.load_state(ref)
    if state is None:
        raise FlowException(f"unknown state {ref}")
    return StateAndRef(state, ref)


def _period_fix_of(reduced) -> tuple[FixOf, CompositeKey]:
    """The (FixOf, pinned oracle key) of the reduced period's single Fixing.
    Products with several fixings per period would generalise this."""
    found = collect_fixings(reduced)
    if not found:
        raise FlowException("current period has no fixing to apply")
    if len(found) > 1:
        raise FlowException("multiple distinct fixings in one period")
    return next(iter(found.items()))


@register_flow
class IrsFixFlow(FlowLogic):
    """Apply the current period's oracle fixing to a RollOut state: query the
    rate, build the UApplyFixes transition, collect the oracle's tear-off
    signature over the embedded Fix command, notarise, broadcast."""

    def __init__(self, state_ref: StateRef, oracle_party: Party,
                 counterparty: Party):
        self.state_ref = state_ref
        self.oracle_party = oracle_party
        self.counterparty = counterparty

    def call(self):
        sar = _load_sar(self, self.state_ref)
        details = sar.state.data.details
        if not isinstance(details, RollOut):
            raise FlowException("fixing applies to RollOut states")
        reduced = reduce_rollout(details)
        fix_of, oracle_key = _period_fix_of(reduced)
        if oracle_key != self.oracle_party.owning_key:
            raise FlowException(
                "the product pins a different oracle for this source")

        fix = yield from self.sub_flow(
            RatesFixQueryFlow(self.oracle_party, fix_of))
        fixed = replace_fixings(reduced, {fix.of: fix.value})

        me = self.service_hub.my_identity
        tx = TransactionBuilder(notary=sar.state.notary)
        tx.add_input_state(sar)
        tx.add_output_state(UniversalState(_participants(fixed), fixed))
        tx.add_command(UApplyFixes((fix,)), me.owning_key)
        tx.add_command(Command(fix, (self.oracle_party.owning_key,)))
        tx.sign_with(self.service_hub.legal_identity_key)
        ptx = tx.to_signed_transaction(check_sufficient_signatures=False)
        # Fail fast on OUR node before consuming anyone's time: a transition
        # the contract rejects must never reach the oracle or the notary.
        ptx.tx.to_ledger_transaction(self.service_hub).verify()

        oracle_sig = yield from self.sub_flow(
            RatesFixSignFlow(self.oracle_party, ptx))
        stx = ptx.with_additional_signature(oracle_sig)
        return (yield from self.sub_flow(
            FinalityFlow(stx, (me, self.counterparty))))


@register_flow
class IrsSettleFlow(FlowLogic):
    """Exercise the period's ``settle`` action on a fixed state: evaluate the
    netted legs, emit one state per leg plus the rolled remainder, timestamp,
    notarise, broadcast."""

    def __init__(self, state_ref: StateRef, counterparty: Party,
                 action_name: str = "settle"):
        self.state_ref = state_ref
        self.counterparty = counterparty
        self.action_name = action_name

    def call(self):
        sar = _load_sar(self, self.state_ref)
        details = sar.state.data.details
        if isinstance(details, RollOut):
            raise FlowException("apply the period fixing before settling")
        action = actions_of(details).get(self.action_name)
        if action is None:
            raise FlowException(f"no action {self.action_name!r} on state")
        me = self.service_hub.my_identity
        if me not in action.actors:
            raise FlowException(f"{me} may not exercise {self.action_name!r}")

        parts = (set(action.arrangement.arrangements)
                 if isinstance(action.arrangement, All)
                 else {action.arrangement})
        tx = TransactionBuilder(notary=sar.state.notary)
        tx.add_input_state(sar)
        for part in sorted(parts, key=repr):
            if isinstance(part, Transfer):
                amount = eval_amount(None, part.amount)
                settled = Transfer(Const(amount), part.currency,
                                   part.from_party, part.to_party)
                tx.add_output_state(
                    UniversalState(_participants(settled), settled))
            else:
                tx.add_output_state(
                    UniversalState(_participants(part), part))
        # Anchor the timestamp window so the action's time condition holds:
        # an after-style (GTE) gate pins the earliest-possible-time at the
        # boundary, a before-style (LTE) gate caps the latest; a gate that
        # cannot hold yet fails cleanly instead of notarising garbage.
        after, before = None, now_micros() + 30_000_000
        cond = action.condition
        if isinstance(cond, TimeCondition) and isinstance(cond.day, Const):
            boundary = cond.day.value * _DAY_MICROS
            if cond.cmp == GTE:
                if boundary > before:
                    raise FlowException(
                        f"the period ending on day {cond.day.value} has not "
                        "ended yet")
                after = boundary
            else:  # LTE: must demonstrably commit before the deadline
                if boundary < now_micros():
                    raise FlowException(
                        f"the deadline on day {cond.day.value} has passed")
                before = min(before, boundary)
        tx.set_time(Timestamp(after, before))
        tx.add_command(UAction(self.action_name), me.owning_key)
        tx.sign_with(self.service_hub.legal_identity_key)
        stx = tx.to_signed_transaction(check_sufficient_signatures=False)
        # Verify locally BEFORE notarising: a condition shape this flow's
        # window anchoring doesn't cover (composite conditions, computed
        # days) must fail here — not consume the input at the notary with a
        # transaction every counterparty will reject.
        stx.tx.to_ledger_transaction(self.service_hub).verify()
        return (yield from self.sub_flow(
            FinalityFlow(stx, (me, self.counterparty))))
