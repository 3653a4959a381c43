"""CommercialPaper: issue / trade / redeem short-term debt.

The port's own copy of ``corda_tpu/finance/commercial_paper.py``.

Capability match for the reference's CommercialPaper contract (reference:
finance/src/main/kotlin/net/corda/contracts/CommercialPaper.kt, clause-based;
same rules expressed as direct requireThat groups):

  * Issue: the issuer signs, face value is positive, maturity is in the
    future (measured against the transaction's notarised timestamp);
  * Move: the owner signs, the paper's terms are unchanged;
  * Redeem: at/after maturity (notarised timestamp), the paper is consumed
    and the transaction moves cash covering the face value to the owner.

The reference's TwoPartyTradeFlow sells exactly this asset; here too —
CPState is an OwnableState, so finance/trade.py handles it unchanged.
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
from ..crypto.party import Party, PartyAndReference
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from .amount import Amount
from .cash import Cash, CashState


@register
@dataclass(frozen=True)
class CPIssue(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class CPMove(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class CPRedeem(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class CPState(OwnableState):
    """A claim on the issuer for face_value at maturity (CommercialPaper.kt
    State)."""

    issuance: PartyAndReference = None  # type: ignore[assignment]
    owner: CompositeKey = None  # type: ignore[assignment]
    face_value: Amount = None  # type: ignore[assignment]  # of Issued token
    maturity_micros: int = 0

    @property
    def contract(self) -> Contract:
        return CP_PROGRAM_ID

    @property
    def participants(self) -> list[CompositeKey]:
        return [self.owner]

    def with_new_owner(self, new_owner: CompositeKey):
        return CPMove(), replace(self, owner=new_owner)

    def without_owner(self) -> "CPState":
        return replace(self, owner=None)


class CommercialPaper(Contract):
    def verify(self, tx) -> None:
        groups = tx.group_states(
            CPState, lambda s: (s.issuance, s.face_value, s.maturity_micros))
        if not groups:
            raise RequirementFailed(
                "CommercialPaper transaction has no CP states")
        timestamp = tx.timestamp
        # Both bounds are needed to compare against a maturity instant; the
        # platform allows one-sided windows, so reject them here rather than
        # crash in midpoint.
        midpoint = (timestamp.midpoint
                    if timestamp is not None
                    and timestamp.after is not None
                    and timestamp.before is not None else None)
        # Cash paid per owner is a transaction-wide pool each redeemed paper
        # CLAIMS from — naive per-paper sums would let N identical papers
        # redeem against one payment.
        cash_pool: dict = {}
        for out in tx.outputs:
            if isinstance(out, CashState):
                key = (out.owner, out.amount.token)
                cash_pool[key] = cash_pool.get(key, 0) + out.amount.quantity
        for group in groups:
            issuance, face_value, maturity = group.grouping_key
            # Classify by the GROUP's own shape (per-group clause matching,
            # as the reference's GroupClauseVerifier does) — commands are
            # transaction-wide and may serve other groups.
            if not group.inputs:
                issue = select_command(tx.commands, CPIssue)
                with require_that() as req:
                    req("the issue is signed by the issuer",
                        issuance.party.owning_key in issue.signers)
                    req("the face value is positive",
                        all(o.face_value.quantity > 0 for o in group.outputs))
                    req("the issue has a fully-bounded timestamp",
                        midpoint is not None)
                    req("the maturity date is in the future",
                        midpoint is not None and maturity > midpoint)
            elif not group.outputs:
                redeem = select_command(tx.commands, CPRedeem)
                with require_that() as req:
                    req("the redemption has a fully-bounded timestamp",
                        midpoint is not None)
                    req("the paper must have matured",
                        midpoint is not None and maturity <= midpoint)
                    req("the redemption is signed by the owner",
                        all(s.owner in redeem.signers for s in group.inputs))
                    for paper in group.inputs:
                        key = (paper.owner, paper.face_value.token)
                        req("the received amount equals the face value",
                            cash_pool.get(key, 0)
                            >= paper.face_value.quantity)
                        cash_pool[key] = (cash_pool.get(key, 0)
                                          - paper.face_value.quantity)
            else:
                move = select_command(tx.commands, CPMove)
                with require_that() as req:
                    req("the move is signed by the owner",
                        all(s.owner in move.signers for s in group.inputs))
                    req("the paper's terms are unchanged (only ownership moves)",
                        [s.without_owner() for s in group.inputs]
                        == [o.without_owner() for o in group.outputs])

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.finance.CommercialPaper")

    # -- generation (CommercialPaper.kt:140-178 capability) ----------------

    @staticmethod
    def generate_issue(issuance: PartyAndReference, face_value: Amount,
                       maturity_micros: int, notary: Party) -> TransactionBuilder:
        state = CPState(issuance, issuance.party.owning_key, face_value,
                        maturity_micros)
        tx = TransactionBuilder(notary=notary)
        tx.add_output_state(state)
        tx.add_command(Command(CPIssue(), (issuance.party.owning_key,)))
        return tx

    @staticmethod
    def generate_move(tx: TransactionBuilder, paper: StateAndRef,
                      new_owner: CompositeKey) -> None:
        tx.add_input_state(paper)
        tx.add_output_state(replace(paper.state.data, owner=new_owner))
        tx.add_command(Command(CPMove(), (paper.state.data.owner,)))

    @staticmethod
    def generate_redeem(tx: TransactionBuilder, paper: StateAndRef,
                        cash_states: list[StateAndRef]) -> None:
        """Consume the paper; pay its face value to the owner from the
        redeemer's (issuer's) cash."""
        state = paper.state.data
        Cash.generate_spend(
            tx, Amount(state.face_value.quantity,
                       state.face_value.token.product),
            state.owner, cash_states)
        tx.add_input_state(paper)
        tx.add_command(Command(CPRedeem(), (state.owner,)))


CP_PROGRAM_ID = CommercialPaper()
