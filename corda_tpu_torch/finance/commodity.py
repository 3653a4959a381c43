"""CommodityContract: a non-cash fungible asset over OnLedgerAsset.

The port's own copy of ``corda_tpu/finance/commodity.py``.

Capability match for the reference's CommodityContract (reference:
finance/src/main/kotlin/net/corda/contracts/asset/CommodityContract.kt:36 —
"intentionally similar to the Cash contract, and the same commands (issue,
move, exit) apply"; Commodity token in core FinanceTypes). The issuer is
the party responsible for delivering the commodity on demand; the deposit
reference is their internal accounting handle (e.g. a warehouse location).
All conservation rules and transaction generation come from the shared
OnLedgerAsset scaffolding — this module only names the types.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..contracts.structures import (
    CommandData,
    Contract,
    FungibleAsset,
    TypeOnlyCommandData,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.party import PartyAndReference
from ..serialization.codec import register
from .amount import Amount
from .on_ledger_asset import OnLedgerAsset


@register
@dataclass(frozen=True)
class Commodity:
    """The thing being tracked (reference: core FinanceTypes Commodity):
    a ticker-style code plus display metadata."""

    commodity_code: str
    display_name: str = ""
    default_fraction_digits: int = 0


@register
@dataclass(frozen=True)
class CommodityIssue(CommandData):
    nonce: int


@register
@dataclass(frozen=True)
class CommodityMove(TypeOnlyCommandData):
    pass


@register
@dataclass(frozen=True)
class CommodityExit(CommandData):
    amount: Amount  # of Issued[Commodity]


@register
@dataclass(frozen=True)
class CommodityState(FungibleAsset):
    """An amount of issued commodity owned by a key."""

    amount: Amount = None  # type: ignore[assignment]
    owner: CompositeKey = None  # type: ignore[assignment]

    @property
    def contract(self) -> Contract:
        return COMMODITY_PROGRAM_ID

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
        return CommodityMove(), replace(self, owner=new_owner)


class CommodityContract(OnLedgerAsset):
    state_type = CommodityState
    issue_command_type = CommodityIssue
    move_command_type = CommodityMove
    exit_command_type = CommodityExit
    asset_noun = "commodity"

    def make_issue_command(self, nonce: int) -> CommodityIssue:
        return CommodityIssue(nonce)

    def make_move_command(self) -> CommodityMove:
        return CommodityMove()

    def make_exit_command(self, amount: Amount) -> CommodityExit:
        return CommodityExit(amount)

    def derive_state(self, template, amount: Amount,
                     owner: CompositeKey) -> CommodityState:
        return CommodityState(amount, owner)

    @property
    def legal_contract_reference(self) -> SecureHash:
        return SecureHash.sha256(b"corda_tpu_torch.finance.Commodity")


COMMODITY_PROGRAM_ID = CommodityContract()
