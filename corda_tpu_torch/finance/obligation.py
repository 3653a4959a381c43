"""Obligation: IOUs that settle against cash and net bilaterally.

Capability match for the reference's Obligation contract (reference:
finance/src/main/kotlin/net/corda/contracts/asset/Obligation.kt — clause
based; the same core rules here as direct groups): an obligation binds an
obligor to deliver an amount of a token to a beneficiary. Supported
lifecycles:

  * Issue: obligor signs new debt into existence;
  * Move: the beneficiary (owner) reassigns who is owed;
  * Settle: cash moves from obligor to beneficiary, extinguishing that much
    obligation (partial settlement leaves a remainder);
  * Net: mutual obligations between the same two parties in the same token
    collapse to a single net obligation (bilateral netting, both sign).

The port's own copy of ``corda_tpu/finance/obligation.py``. Its states and
commands register with the port's codec under the same wire names, so one
obligation transaction has the same bytes and id in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..contracts.dsl import RequirementFailed, require_that, select_command
from ..contracts.structures import (
    Command,
    CommandData,
    Contract,
    Issued,
    OwnableState,
    StateAndRef,
    TypeOnlyCommandData,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from .amount import Amount
from .cash import Cash, CashState


@register
@dataclass(frozen=True)
class ObligationIssue(CommandData):
    nonce: int


@register
@dataclass(frozen=True)
class ObligationMove(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class ObligationSettle(CommandData):
    amount: Amount  # of the Issued token being extinguished


@register
@dataclass(frozen=True)
class ObligationNet(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class ObligationState(OwnableState):
    """`obligor` owes `amount` (of an Issued token) to `owner`
    (Obligation.kt State: the owner is the beneficiary)."""

    obligor: CompositeKey = None  # type: ignore[assignment]
    amount: Amount = None  # type: ignore[assignment]
    owner: CompositeKey = None  # type: ignore[assignment]

    @property
    def contract(self) -> Contract:
        return OBLIGATION_PROGRAM_ID

    @property
    def participants(self) -> list[CompositeKey]:
        return [self.obligor, self.owner]

    def with_new_owner(self, new_owner: CompositeKey):
        return ObligationMove(), replace(self, owner=new_owner)


class Obligation(Contract):
    def verify(self, tx) -> None:
        groups = tx.group_states(ObligationState, lambda s: s.amount.token)
        if not groups:
            raise RequirementFailed("Obligation transaction has no obligations")
        for group in groups:
            token = group.grouping_key
            in_sum = sum(s.amount.quantity for s in group.inputs)
            out_sum = sum(s.amount.quantity for s in group.outputs)
            if self._is_net_group(tx, group):
                self._verify_net(tx, group)
            elif not group.inputs:
                issue = select_command(tx.commands, ObligationIssue)
                with require_that() as req:
                    req("new debt is positive",
                        all(o.amount.quantity > 0 for o in group.outputs))
                    req("every obligor has signed the issue",
                        all(o.obligor in issue.signers
                            for o in group.outputs))
            elif in_sum > out_sum:
                settle = select_command(tx.commands, ObligationSettle)
                settled = settle.value.amount
                in_pairs = {(s.obligor, s.owner) for s in group.inputs}
                with require_that() as req:
                    req("the settle amount covers the reduction",
                        settled.token == token
                        and in_sum - out_sum == settled.quantity)
                    req("cash moves to each beneficiary for the settled "
                        "amount",
                        self._cash_covers(tx, group, settled.quantity))
                    req("the obligor signed the settlement",
                        all(s.obligor in settle.signers
                            for s in group.inputs))
                    req("the remainder keeps its original obligor and "
                        "beneficiary",  # debt cannot be reassigned here
                        all((o.obligor, o.owner) in in_pairs
                            for o in group.outputs))
            else:
                move = select_command(tx.commands, ObligationMove)

                def terms(states):  # canonical sort key: keys define no order
                    return sorted(
                        ((s.obligor, s.amount.quantity) for s in states),
                        key=lambda t: (t[0].to_base58_string(), t[1]))

                with require_that() as req:
                    req("obligation amounts are conserved in a move",
                        in_sum == out_sum)
                    req("terms other than the beneficiary are unchanged",
                        terms(group.inputs) == terms(group.outputs))
                    req("every current beneficiary has signed the move",
                        all(s.owner in move.signers for s in group.inputs))

    @staticmethod
    def _cash_covers(tx, group, settled_quantity: int) -> bool:
        """Cash outputs to the beneficiaries must cover what was settled,
        in the obligation's underlying product."""
        product = group.grouping_key.product \
            if isinstance(group.grouping_key, Issued) else group.grouping_key
        owed: dict = {}
        for s in group.inputs:
            owed[s.owner] = owed.get(s.owner, 0) + s.amount.quantity
        for o in group.outputs:
            owed[o.owner] = owed.get(o.owner, 0) - o.amount.quantity
        paid: dict = {}
        for out in tx.outputs:
            if isinstance(out, CashState) \
                    and out.amount.token.product == product:
                paid[out.owner] = paid.get(out.owner, 0) \
                    + out.amount.quantity
        covered = 0
        for owner, reduction in owed.items():
            if reduction <= 0:
                continue
            if paid.get(owner, 0) < reduction:
                return False
            covered += reduction
        return covered == settled_quantity

    @staticmethod
    def _is_net_group(tx, group) -> bool:
        """A group is a netting when the GROUP ITSELF holds obligations in
        both directions between one pair — the tx-wide command alone must not
        reroute an unrelated group in the same transaction."""
        if not any(isinstance(c.value, ObligationNet) for c in tx.commands):
            return False
        directed = {(s.obligor, s.owner) for s in group.inputs}
        undirected = {frozenset(p) for p in directed}
        return len(undirected) == 1 and len(directed) == 2

    @staticmethod
    def _verify_net(tx, group) -> None:
        net_cmd = select_command(tx.commands, ObligationNet)
        pairs = {frozenset((s.obligor, s.owner)) for s in group.inputs}
        with require_that() as req:
            req("netting involves exactly one pair of parties",
                len(pairs) == 1)
            gross = {}
            for s in group.inputs:
                gross[(s.obligor, s.owner)] = gross.get(
                    (s.obligor, s.owner), 0) + s.amount.quantity
            directions = list(gross.items())
            req("netting requires obligations in both directions",
                len(directions) == 2)
            (d1, q1), (d2, q2) = directions
            net_quantity = abs(q1 - q2)
            if net_quantity == 0:
                req("zero net debt leaves no outputs", not group.outputs)
            else:
                net_obligor, net_owner = d1 if q1 > q2 else d2
                req("exactly one net obligation remains",
                    len(group.outputs) == 1)
                if group.outputs:
                    out = group.outputs[0]
                    req("the net obligation has the right direction and size",
                        out.obligor == net_obligor
                        and out.owner == net_owner
                        and out.amount.quantity == net_quantity)
            req("both parties signed the netting",
                all(k in net_cmd.signers for pair in pairs for k in pair))

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.finance.Obligation")

    # -- generation --------------------------------------------------------

    @staticmethod
    def generate_issue(obligor: CompositeKey, beneficiary: CompositeKey,
                       amount: Amount, notary: Party,
                       nonce: int = 0) -> TransactionBuilder:
        tx = TransactionBuilder(notary=notary)
        tx.add_output_state(ObligationState(obligor, amount, beneficiary))
        tx.add_command(Command(ObligationIssue(nonce), (obligor,)))
        return tx

    @staticmethod
    def generate_settle(tx: TransactionBuilder, obligations: list[StateAndRef],
                        cash_states: list[StateAndRef],
                        amount: Amount) -> None:
        """Pay `amount` of the obligations' token from the obligor's cash.
        All obligations must share one obligor and one beneficiary — mixed
        inputs would build a transaction the contract rejects."""
        token = obligations[0].state.data.amount.token
        pairs = {(o.state.data.obligor, o.state.data.owner)
                 for o in obligations}
        if len(pairs) != 1:
            raise ValueError(
                "generate_settle needs a single (obligor, beneficiary) pair; "
                "settle mixed obligations in separate transactions")
        total = sum(o.state.data.amount.quantity for o in obligations)
        if amount.quantity > total:
            raise ValueError("settling more than is owed")
        for sar in obligations:
            tx.add_input_state(sar)
        remainder = total - amount.quantity
        state = obligations[0].state.data
        if remainder:
            tx.add_output_state(replace(
                state, amount=Amount(remainder, token)))
        product = token.product if isinstance(token, Issued) else token
        Cash.generate_spend(
            tx, Amount(amount.quantity, product), state.owner, cash_states)
        tx.add_command(Command(
            ObligationSettle(Amount(amount.quantity, token)),
            (state.obligor,)))

    @staticmethod
    def generate_net(tx: TransactionBuilder,
                     obligations: list[StateAndRef]) -> None:
        gross: dict = {}
        token = obligations[0].state.data.amount.token
        for sar in obligations:
            tx.add_input_state(sar)
            s = sar.state.data
            gross[(s.obligor, s.owner)] = gross.get(
                (s.obligor, s.owner), 0) + s.amount.quantity
        (d1, q1), (d2, q2) = list(gross.items())
        net_quantity = abs(q1 - q2)
        if net_quantity:
            obligor, owner = d1 if q1 > q2 else d2
            tx.add_output_state(ObligationState(
                obligor, Amount(net_quantity, token), owner))
        signers = {k for pair in gross for k in pair}
        tx.add_command(Command(ObligationNet(), tuple(signers)))


OBLIGATION_PROGRAM_ID = Obligation()
