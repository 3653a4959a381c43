"""TwoPartyTradeFlow: delivery-versus-payment between two nodes.

The port's own copy of ``corda_tpu/finance/trade.py``.

Capability match for the reference's TwoPartyTradeFlow (reference:
finance/src/main/kotlin/net/corda/flows/TwoPartyTradeFlow.kt:18-45):

  Seller: owns an asset, wants `price` cash.
    1. send the buyer the asset + price + the key to pay;
    2. receive the buyer's partially-signed DvP transaction;
    3. check it (resolve the buyer's cash history, confirm payment + asset
       movement), sign it;
    4. FinalityFlow: notarise and broadcast to both parties.
  Buyer (initiated): receives the offer, resolves the ASSET's history,
    gathers cash from its vault, builds the swap (asset -> buyer,
    cash -> seller), signs, returns it — then learns the outcome through
    the finality broadcast.

As in the reference, both legs of the swap are atomic: one transaction moves
the asset and the cash, so the notary's uniqueness commit is the settlement
point. Signature checks on the received transaction ride the node's
micro-batched verifier.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..contracts.structures import Command, StateAndRef
from ..crypto.composite import CompositeKey
from ..crypto.party import Party
from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.finality import FinalityFlow
from ..flows.resolve import ResolveTransactionsFlow
from ..serialization.codec import register
from ..transactions.builder import TransactionBuilder
from ..transactions.signed import SignedTransaction
from .amount import Amount
from .cash import Cash, CashState


@register
@dataclass(frozen=True)
class SellerTradeInfo:
    """The seller's opening message (TwoPartyTradeFlow.kt SellerTradeInfo)."""

    asset_for_sale: StateAndRef
    price: Amount  # plain-currency amount
    seller_owner_key: CompositeKey


class UnacceptablePriceException(FlowException):
    def __init__(self, given_price: Amount):
        super().__init__(f"Unacceptable price: {given_price}")
        self.given_price = given_price


class AssetMismatchException(FlowException):
    pass


@register_flow
class SellerFlow(FlowLogic):
    def __init__(self, other_party: Party, asset_to_sell: StateAndRef,
                 price: Amount):
        self.other_party = other_party
        self.asset_to_sell = asset_to_sell
        self.price = price

    def call(self):
        my_key = self.service_hub.my_identity.owning_key
        hello = SellerTradeInfo(self.asset_to_sell, self.price, my_key)
        response = yield self.send_and_receive(
            self.other_party, hello, SignedTransaction)
        ptx = response.unwrap(self._validate_partial)

        # The buyer's cash inputs come from history we don't have: fetch and
        # verify it (this also batch-verifies the buyer's signature).
        yield from self.sub_flow(
            ResolveTransactionsFlow(ptx.tx, self.other_party))

        # Everything checks out — counter-sign and finalise (notarise +
        # broadcast to both parties).
        my_sig = self.service_hub.legal_identity_key.sign(ptx.id.bytes)
        stx = ptx.with_additional_signature(my_sig)
        final = yield from self.sub_flow(FinalityFlow(
            stx, (self.service_hub.my_identity, self.other_party)))
        return final

    def _validate_partial(self, ptx: SignedTransaction) -> SignedTransaction:
        wtx = ptx.tx
        if self.asset_to_sell.ref not in wtx.inputs:
            raise AssetMismatchException(
                "Transaction does not consume the asset being sold")
        my_key = self.service_hub.my_identity.owning_key
        paid = sum(
            out.data.amount.quantity
            for out in wtx.outputs
            if isinstance(out.data, CashState) and out.data.owner == my_key
            and out.data.amount.token.product == self.price.token
        )
        if paid < self.price.quantity:
            raise FlowException(
                f"Transaction pays {paid}, expected {self.price}")
        return ptx


@register_flow
class BuyerFlow(FlowLogic):
    """The responding side; register with
    smm.register_flow_initiator('SellerFlow', lambda party: BuyerFlow(party,
    acceptable_price, notary))."""

    def __init__(self, other_party: Party, acceptable_price: Amount,
                 notary: Party):
        self.other_party = other_party
        self.acceptable_price = acceptable_price
        self.notary = notary

    def call(self):
        offer = yield self.receive(self.other_party, SellerTradeInfo)
        trade = offer.unwrap(self._validate_offer)

        # The asset's provenance is unknown to us: resolve + verify it before
        # paying for it (Buyer.validateTradeRequest capability).
        yield from self.sub_flow(ResolveTransactionsFlow(
            (trade.asset_for_sale.ref.txhash,), self.other_party))

        my_key = self.service_hub.my_identity.owning_key
        tx = TransactionBuilder(notary=self.notary)
        # Soft-locked indexed coin selection: concurrent buyers on this
        # vault reserve disjoint coins instead of racing generate_spend
        # over the same full listing and double-spending at the notary.
        vault_states = self.service_hub.vault_service.select_coins(
            str(trade.price.token), trade.price.quantity,
            holder=self.run_id or b"buyer")
        Cash.generate_spend(
            tx, trade.price, trade.seller_owner_key, vault_states,
            change_owner=my_key)
        tx.add_input_state(trade.asset_for_sale)
        move_cmd, new_asset = trade.asset_for_sale.state.data.with_new_owner(my_key)
        tx.add_output_state(new_asset)
        tx.add_command(Command(move_cmd, (trade.asset_for_sale.state.data.owner,)))

        tx.sign_with(self.service_hub.legal_identity_key)
        ptx = tx.to_signed_transaction(check_sufficient_signatures=False)
        yield self.send(self.other_party, ptx)
        # Settlement arrives via the seller's finality broadcast.
        return ptx.id

    def _validate_offer(self, trade: SellerTradeInfo) -> SellerTradeInfo:
        if not isinstance(trade, SellerTradeInfo):
            raise FlowException("Expected SellerTradeInfo")
        if trade.price.token != self.acceptable_price.token or \
                trade.price.quantity > self.acceptable_price.quantity:
            raise UnacceptablePriceException(trade.price)
        return trade


