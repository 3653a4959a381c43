"""Finance layer: fungible asset contracts and trading flows.

The port's own copies of ``corda_tpu/finance``'s Amount arithmetic, the
on-ledger asset base, the Cash, CommercialPaper and Commodity contracts
and the two-party delivery-versus-payment trade flows; the rate types
(``types``), fixable deals (``fixable_deal``) and the interest-rate swap
(``irs``) are modules of their own, not exported here, as in the JAX
package. Obligation is not ported yet (ROADMAP.md).
"""

from .amount import Amount
from .cash import Cash, CashExit, CashIssue, CashMove, CashState
from .commodity import Commodity, CommodityContract, CommodityState
from .on_ledger_asset import OnLedgerAsset
from .trade import BuyerFlow, SellerFlow, SellerTradeInfo

__all__ = [
    "Amount", "Cash", "CashState", "CashIssue", "CashMove", "CashExit",
    "Commodity", "CommodityContract", "CommodityState", "OnLedgerAsset",
    "SellerFlow", "BuyerFlow", "SellerTradeInfo",
]
