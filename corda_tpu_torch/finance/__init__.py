"""Finance layer: fungible asset contracts.

The port's own copies of ``corda_tpu/finance``'s Amount arithmetic, the
on-ledger asset base and the Cash contract: what the node's vault
observers read (node/services/vault_observers.py). Commodity and the
two-party trade flows are not ported yet (ROADMAP.md).
"""

from .amount import Amount
from .cash import Cash, CashExit, CashIssue, CashMove, CashState
from .on_ledger_asset import OnLedgerAsset

__all__ = [
    "Amount", "Cash", "CashState", "CashIssue", "CashMove", "CashExit",
    "OnLedgerAsset",
]
