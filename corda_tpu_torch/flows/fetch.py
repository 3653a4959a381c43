"""Fetching content-addressed data from a peer.

The port's own copy of ``corda_tpu/flows/fetch.py``.

Capability match for the reference's FetchDataFlow / FetchTransactionsFlow /
FetchAttachmentsFlow (reference: core/src/main/kotlin/net/corda/flows/
FetchDataFlow.kt:26-99): load what we have locally, request the rest from the
counterparty, and reject responses that don't hash to what was asked for
(malicious-peer defence). The serving side is the data-vending responder
(flows/data_vending.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.hashes import SecureHash
from ..serialization.codec import register
from .api import FlowException, FlowLogic, register_flow


class BadAnswer(FlowException):
    pass


class HashNotFound(BadAnswer):
    def __init__(self, requested: SecureHash):
        super().__init__(f"Hash not found: {requested}")
        self.requested = requested


class DownloadedVsRequestedDataMismatch(BadAnswer):
    def __init__(self, requested: SecureHash, got: SecureHash):
        super().__init__(f"Got {got} but requested {requested}")
        self.requested = requested
        self.got = got


@register
@dataclass(frozen=True)
class FetchRequest:
    hashes: tuple[SecureHash, ...]


@register
@dataclass(frozen=True)
class FetchResponse:
    # Entries align with the request; None where the peer lacks the item.
    items: tuple


@dataclass(frozen=True)
class FetchResult:
    from_disk: tuple
    downloaded: tuple

    @property
    def all_items(self) -> tuple:
        return self.from_disk + self.downloaded


class _FetchFlowBase(FlowLogic):
    """Shared request/validate logic; subclasses define load/id_of/store."""

    def __init__(self, requests: tuple, other_side):
        self.requests = tuple(requests)
        self.other_side = other_side

    def _load_local(self, item_hash: SecureHash):
        raise NotImplementedError

    def _id_of(self, item) -> SecureHash:
        raise NotImplementedError

    def _store(self, items) -> None:
        pass

    def call(self):
        from_disk, to_fetch = [], []
        for h in self.requests:
            local = self._load_local(h)
            if local is not None:
                from_disk.append(local)
            else:
                to_fetch.append(h)
        if not to_fetch:
            return FetchResult(tuple(from_disk), ())
        response = yield self.send_and_receive(
            self.other_side, FetchRequest(tuple(to_fetch)), FetchResponse
        )
        items = response.unwrap().items
        if len(items) != len(to_fetch):
            raise BadAnswer("response size does not match request")
        for requested, item in zip(to_fetch, items):
            if item is None:
                raise HashNotFound(requested)
            if self._id_of(item) != requested:
                raise DownloadedVsRequestedDataMismatch(requested, self._id_of(item))
        self._store(items)
        return FetchResult(tuple(from_disk), tuple(items))


@register_flow
class FetchTransactionsFlow(_FetchFlowBase):
    """Fetch SignedTransactions by id (reference: FetchTransactionsFlow)."""

    def _load_local(self, item_hash):
        return self.service_hub.storage_service.validated_transactions.get_transaction(
            item_hash
        )

    def _id_of(self, stx):
        return stx.id


@register_flow
class FetchAttachmentsFlow(_FetchFlowBase):
    """Fetch attachment blobs by id (reference: FetchAttachmentsFlow); writes
    them into local attachment storage."""

    def _load_local(self, item_hash):
        att = self.service_hub.storage_service.attachments.open_attachment(item_hash)
        return None if att is None else att.open()

    def _id_of(self, blob: bytes):
        return SecureHash.sha256(blob)

    def _store(self, items):
        for blob in items:
            self.service_hub.storage_service.attachments.import_attachment(blob)
