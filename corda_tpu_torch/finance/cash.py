"""Cash: the fungible currency-claim contract.

Capability match for the reference's Cash contract (reference:
finance/src/main/kotlin/net/corda/contracts/asset/Cash.kt:42 — there built
from the clause framework; here the same rules as direct requireThat groups,
which is the idiomatic Python shape of GroupClauseVerifier):

  * states are amounts of `Issued(issuer&ref, currency)` owned by a key;
  * verification groups by issued-token and conservation-checks each group;
  * Issue: outputs exceed inputs, no nonsense, issuer signs (anti-replay
    nonce in the command);
  * Move: quantities conserved, every input owner signs;
  * Exit: quantity removed matches the Exit command, issuer + owners sign.

Transaction generation (generate_issue/generate_spend/generate_exit) mirrors
finance/.../asset/Cash.kt:153-221 and OnLedgerAsset, including greedy coin
selection with a change output.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..contracts.structures import (
    CommandData,
    Contract,
    FungibleAsset,
    StateAndRef,
    TypeOnlyCommandData,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import Party, PartyAndReference
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from .amount import Amount
from .on_ledger_asset import InsufficientBalanceException, OnLedgerAsset

__all__ = ["Cash", "CashState", "CashIssue", "CashMove", "CashExit",
           "InsufficientBalanceException", "CASH_PROGRAM_ID"]


@register
@dataclass(frozen=True)
class CashIssue(CommandData):
    """Issue cash onto the ledger; nonce prevents replay across transactions
    (reference: Cash.kt Commands.Issue / Structures.kt:375)."""

    nonce: int


@register
@dataclass(frozen=True)
class CashMove(TypeOnlyCommandData):
    """Change ownership (reference: Cash.kt Commands.Move)."""


@register
@dataclass(frozen=True)
class CashExit(CommandData):
    """Remove cash from the ledger, e.g. off-ledger redemption
    (reference: Cash.kt Commands.Exit)."""

    amount: Amount  # of Issued token


@register
@dataclass(frozen=True)
class CashState(FungibleAsset):
    """An amount of issued currency owned by a key (Cash.kt State).

    Also queryable: projects to the `cash_states` table (the reference's
    CashSchemaV1, finance/.../schemas/CashSchemaV1.kt)."""

    amount: Amount = None  # type: ignore[assignment]  # Amount of Issued
    owner: CompositeKey = None  # type: ignore[assignment]

    def to_schema_row(self):
        return ("cash_states", {
            "currency": str(self.amount.token.product),
            "quantity": self.amount.quantity,
            "issuer": self.amount.token.issuer.party.name,
            "owner_key": self.owner.to_base58_string(),
        })

    @property
    def contract(self) -> Contract:
        return CASH_PROGRAM_ID

    @property
    def participants(self) -> list[CompositeKey]:
        return [self.owner]

    @property
    def exit_keys(self) -> list[CompositeKey]:
        return [self.owner, self.amount.token.issuer.party.owning_key]

    @property
    def issuer(self) -> PartyAndReference:
        return self.amount.token.issuer

    def with_new_owner(self, new_owner: CompositeKey):
        return CashMove(), replace(self, owner=new_owner)

    def __str__(self) -> str:
        return f"{self.amount} owned by {self.owner!r}"


class Cash(OnLedgerAsset):
    """Cash instantiates the generic OnLedgerAsset scaffolding (reference:
    Cash.kt extends OnLedgerAsset; the shared conservation rules and coin
    selection live in finance/on_ledger_asset.py). The generate_* methods
    keep their historical staticmethod call shape."""

    state_type = CashState
    issue_command_type = CashIssue
    move_command_type = CashMove
    exit_command_type = CashExit
    asset_noun = "cash"

    def make_issue_command(self, nonce: int) -> CashIssue:
        return CashIssue(nonce)

    def make_move_command(self) -> CashMove:
        return CashMove()

    def make_exit_command(self, amount: Amount) -> CashExit:
        return CashExit(amount)

    def derive_state(self, template, amount: Amount,
                     owner: CompositeKey) -> "CashState":
        return CashState(amount, owner)

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.finance.Cash")

    # -- transaction generation (Cash.kt:153-221 call shape) ---------------

    @staticmethod
    def generate_issue(
        amount: Amount, issuer: PartyAndReference, owner: CompositeKey,
        notary: Party, nonce: int = 0,
    ) -> TransactionBuilder:
        return OnLedgerAsset.generate_issue(
            CASH_PROGRAM_ID, amount, issuer, owner, notary, nonce=nonce)

    @staticmethod
    def generate_spend(
        tx: TransactionBuilder,
        amount: Amount,  # plain-currency amount; any acceptable issuer
        recipient: CompositeKey,
        cash_states: list[StateAndRef],
        change_owner: CompositeKey | None = None,
    ) -> list[CompositeKey]:
        return OnLedgerAsset.generate_spend(
            CASH_PROGRAM_ID, tx, amount, recipient, cash_states,
            change_owner=change_owner)

    @staticmethod
    def generate_exit(
        tx: TransactionBuilder, amount: Amount,  # Amount of Issued token
        cash_states: list[StateAndRef],
    ) -> list[CompositeKey]:
        return OnLedgerAsset.generate_exit(
            CASH_PROGRAM_ID, tx, amount, cash_states)


CASH_PROGRAM_ID = Cash()
