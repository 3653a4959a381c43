"""Data vending: serving fetch/notify requests from peers.

The port's own copy of ``corda_tpu/flows/data_vending.py``.

Capability match for the reference's DataVending.Service (reference:
node/src/main/kotlin/net/corda/node/services/persistence/DataVendingService.kt):
responder flows for FetchTransactionsFlow, FetchAttachmentsFlow and
BroadcastTransactionFlow. Content addressing doubles as access control —
knowing a hash grants the right to fetch it (DataVendingService.kt:24-31).
"""

from __future__ import annotations

from ..crypto.party import Party
from .api import FlowLogic, register_flow
from .fetch import FetchRequest, FetchResponse
from .finality import NotifyTxRequest
from .resolve import ResolveTransactionsFlow


@register_flow
class FetchTransactionsHandler(FlowLogic):
    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        req = yield self.receive(self.other_party, FetchRequest)
        request = req.unwrap(lambda r: r if r.hashes else None)
        if request is None:
            return None
        storage = self.service_hub.storage_service.validated_transactions
        items = tuple(storage.get_transaction(h) for h in request.hashes)
        yield self.send(self.other_party, FetchResponse(items))
        return None


@register_flow
class FetchAttachmentsHandler(FlowLogic):
    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        req = yield self.receive(self.other_party, FetchRequest)
        request = req.unwrap(lambda r: r if r.hashes else None)
        if request is None:
            return None
        attachments = self.service_hub.storage_service.attachments
        items = []
        for h in request.hashes:
            att = attachments.open_attachment(h)
            items.append(None if att is None else att.open())
        yield self.send(self.other_party, FetchResponse(tuple(items)))
        return None


@register_flow
class NotifyTransactionHandler(FlowLogic):
    """Accept a broadcast transaction: resolve its history, then record
    (DataVendingService.kt:95-103)."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        req = yield self.receive(self.other_party, NotifyTxRequest)
        request = req.unwrap()
        yield from self.sub_flow(
            ResolveTransactionsFlow(request.tx, self.other_party),
            share_parent_sessions=True,
        )
        self.record_transactions([request.tx])
        return None


def install_data_vending(smm) -> None:
    """Register the three handlers on a node's state machine manager."""
    smm.register_flow_initiator(
        "FetchTransactionsFlow", lambda party: FetchTransactionsHandler(party)
    )
    smm.register_flow_initiator(
        "FetchAttachmentsFlow", lambda party: FetchAttachmentsHandler(party)
    )
    smm.register_flow_initiator(
        "BroadcastTransactionFlow", lambda party: NotifyTransactionHandler(party)
    )
