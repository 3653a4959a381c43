"""Whole-network simulations with latency injection.

Capability match for the reference's simulation harness (reference:
samples/irs-demo/src/main/kotlin/net/corda/simulation/Simulation.kt:37-45 —
MockNetwork-based scenarios with banks placed in cities and an injected
latency calculator — and TradeSimulation.kt — a cash-for-asset trade run
through the simulated network). The sent-message feed these simulations
produce is what the reference's network-visualiser replays
(samples/network-visualiser/.../NetworkMapVisualiser.kt); here it's
`Simulation.network.messaging_network.sent_messages`.

The port's own copy of ``corda_tpu/testing/simulation.py``. ``verifier=None`` gives
the port's ``MockNetwork`` its default verifier, the card
(``get_verifier``'s ``"torch"``); pass a ``CpuVerifier`` to run on the
host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..crypto.provider import BatchVerifier
from .mock_network import MockNetwork, MockNode


@dataclass(frozen=True)
class City:
    name: str
    latitude: float
    longitude: float


LONDON = City("London", 51.5, -0.12)
NEW_YORK = City("New York", 40.7, -74.0)
TOKYO = City("Tokyo", 35.7, 139.7)
SINGAPORE = City("Singapore", 1.35, 103.8)
ZURICH = City("Zurich", 47.4, 8.5)

_CITIES = (LONDON, NEW_YORK, TOKYO, SINGAPORE, ZURICH)


def _great_circle_km(a: City, b: City) -> float:
    phi1, phi2 = math.radians(a.latitude), math.radians(b.latitude)
    dphi = phi2 - phi1
    dlam = math.radians(b.longitude - a.longitude)
    h = math.sin(dphi / 2) ** 2 \
        + math.cos(phi1) * math.cos(phi2) * math.sin(dlam / 2) ** 2
    return 2 * 6371 * math.asin(math.sqrt(h))


class Simulation:
    """Banks in cities over a latency-injected MockNetwork
    (Simulation.kt:37-45). Latency ticks are proportional to great-circle
    distance, so message interleavings resemble a real WAN's."""

    def __init__(self, bank_count: int = 2, notary_city: City = ZURICH,
                 verifier: BatchVerifier | None = None):
        self._locations: dict[int, City] = {}
        self.network = MockNetwork(verifier=verifier)
        self.network.messaging_network.latency_calculator = self._latency
        self.notary = self.network.create_notary_node("Notary")
        self._place(self.notary, notary_city)
        self.banks: list[MockNode] = []
        for i in range(bank_count):
            city = _CITIES[i % len(_CITIES)]
            bank = self.network.create_node(f"Bank of {city.name} {i}")
            self._place(bank, city)
            self.banks.append(bank)

    def _place(self, node: MockNode, city: City) -> None:
        self._locations[node.messaging.my_address.id] = city

    def _latency(self, sender, recipient) -> int:
        a = self._locations.get(sender.id)
        b = self._locations.get(recipient.id)
        if a is None or b is None or a == b:
            return 1
        return 1 + int(_great_circle_km(a, b) / 1000)  # ~1 tick per 1000 km

    @property
    def sent_messages(self):
        """The visualiser feed (InMemoryMessagingNetwork.sentMessages)."""
        return self.network.messaging_network.sent_messages

    def run(self) -> int:
        return self.network.run_network()

    def stop(self) -> None:
        self.network.stop_nodes()


class TradeSimulation(Simulation):
    """One bank sells an asset to another for cash (TradeSimulation.kt):
    exercises issuance, DvP trade, notarisation and broadcast across the
    simulated WAN."""

    def __init__(self, verifier: BatchVerifier | None = None):
        super().__init__(bank_count=2, verifier=verifier)

    def run_trade(self, price_quantity: int = 750):
        from ..contracts.structures import Issued, now_micros
        from ..finance import Amount, Cash
        from ..finance.trade import BuyerFlow, SellerFlow
        from .dummies import DummyContract

        seller, buyer = self.banks
        asset_issue = DummyContract.generate_initial(
            seller.identity.ref(b"\x01"), 99, self.notary.identity)
        asset_issue.sign_with(seller.key)
        asset_stx = asset_issue.to_signed_transaction()
        seller.record_transaction(asset_stx)

        cash_issue = Cash.generate_issue(
            Amount(1_000, "USD"), buyer.identity.ref(b"\x02"),
            buyer.identity.owning_key, self.notary.identity)
        cash_issue.sign_with(buyer.key)
        buyer.record_transaction(cash_issue.to_signed_transaction())

        buyer.register_initiated_flow(
            "SellerFlow",
            lambda party: BuyerFlow(party, Amount(1_000, "USD"),
                                    self.notary.identity))
        handle = seller.start_flow(SellerFlow(
            buyer.identity, asset_stx.tx.out_ref(0),
            Amount(price_quantity, "USD")))
        self.run()
        return handle.result.result()
