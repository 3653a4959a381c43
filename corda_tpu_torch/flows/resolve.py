"""Recursive dependency resolution and verification.

The port's own copy of ``corda_tpu/flows/resolve.py``.

Capability match for the reference's ResolveTransactionsFlow (reference:
core/src/main/kotlin/net/corda/flows/ResolveTransactionsFlow.kt:31-197):
breadth-first download of the transaction dependency graph from the
counterparty (DoS-bounded at 5000), topological sort, then verify and record
each dependency deepest-first. Signature checks ride the node's micro-batched
verifier.
"""

from __future__ import annotations

from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from ..transactions.signed import SignedTransaction
from ..transactions.wire import WireTransaction
from .api import FlowException, FlowLogic, register_flow
from .fetch import FetchAttachmentsFlow, FetchTransactionsFlow


class ExcessivelyLargeTransactionGraph(FlowException):
    pass


def topological_sort(transactions: list[SignedTransaction]) -> list[SignedTransaction]:
    """Order so dependencies come before dependents
    (ResolveTransactionsFlow.kt:37-68)."""
    forward: dict[SecureHash, list[SignedTransaction]] = {}
    for stx in transactions:
        for inp in stx.tx.inputs:
            forward.setdefault(inp.txhash, []).append(stx)
    visited: set[SecureHash] = set()
    result: list[SignedTransaction] = []

    def visit(stx: SignedTransaction) -> None:
        if stx.id in visited:
            return
        visited.add(stx.id)
        for dependent in forward.get(stx.id, ()):
            visit(dependent)
        result.append(stx)

    for stx in transactions:
        visit(stx)
    result.reverse()
    if len(result) != len(transactions):
        raise FlowException("cycle in transaction graph?")
    return result


@register_flow
class ResolveTransactionsFlow(FlowLogic):
    """Verify a transaction by resolving and verifying its full history."""

    transaction_count_limit = 5000  # DoS bound (ResolveTransactionsFlow.kt:78-80)

    def __init__(self, tx, other_side: Party):
        # tx: WireTransaction (check deps only), SignedTransaction (also
        # verify the tx itself against its history), or a tuple of
        # SecureHash tx ids to fetch+verify directly (the reference's
        # Set<SecureHash> constructor, ResolveTransactionsFlow.kt:88-92).
        self.tx = tx
        self.other_side = other_side

    def call(self):
        if isinstance(self.tx, (tuple, frozenset, set)):
            downloads = yield from self._download_dependencies(set(self.tx))
            results = yield from self._verify_and_record(downloads)
            return results
        stx = self.tx if isinstance(self.tx, SignedTransaction) else None
        wtx = stx.tx if stx is not None else self.tx
        assert isinstance(wtx, WireTransaction)
        dep_hashes = {ref.txhash for ref in wtx.inputs}

        downloads = yield from self._download_dependencies(dep_hashes)
        results = yield from self._verify_and_record(downloads)

        yield from self._fetch_missing_attachments([wtx])
        if stx is not None:
            yield self.verify_signatures_batched(stx)
        ltx = wtx.to_ledger_transaction(self.service_hub)
        ltx.verify()
        results.append(ltx)
        return results

    def _verify_and_record(self, downloads):
        """Verify + record downloaded dependencies, deepest-first. Batched
        signature math + completeness; NO allowances: committed history must
        carry every required signature INCLUDING the notary's (the reference
        verifies dependencies strictly, ResolveTransactionsFlow.kt:105-111)."""
        results = []
        for dep_stx in topological_sort(downloads):
            yield self.verify_signatures_batched(dep_stx)
            ltx = dep_stx.tx.to_ledger_transaction(self.service_hub)
            ltx.verify()
            self.record_transactions([dep_stx])
            results.append(ltx)
        return results

    def _download_dependencies(self, deps_to_check: set[SecureHash]):
        """BFS with dedupe and the transaction-count DoS limit
        (ResolveTransactionsFlow.kt:131-182)."""
        next_requests = list(dict.fromkeys(deps_to_check))
        result_q: dict[SecureHash, SignedTransaction] = {}
        limit_counter = 0
        while next_requests:
            not_fetched = tuple(h for h in next_requests if h not in result_q)
            next_requests = []
            if not not_fetched:
                break
            fetched = yield from self.sub_flow(
                FetchTransactionsFlow(not_fetched, self.other_side)
            )
            # from_disk items are already verified and recorded locally;
            # only fresh downloads enter the verify queue.
            downloads = list(fetched.downloaded)
            # Batch the id recompute of the whole download wave (device
            # kernel above the crossover size) instead of hashing each
            # transaction's components on first .tx touch below.
            SignedTransaction.prime_ids(downloads)
            yield from self._fetch_missing_attachments([s.tx for s in downloads])
            for dep in downloads:
                result_q.setdefault(dep.id, dep)
            next_requests = list(
                dict.fromkeys(
                    inp.txhash for dep in downloads for inp in dep.tx.inputs
                )
            )
            limit_counter += len(next_requests)
            if limit_counter > self.transaction_count_limit:
                raise ExcessivelyLargeTransactionGraph()
        return list(result_q.values())

    def _fetch_missing_attachments(self, wtxs):
        missing = tuple(
            att
            for wtx in wtxs
            for att in wtx.attachments
            if self.service_hub.storage_service.attachments.open_attachment(att) is None
        )
        if missing:
            yield from self.sub_flow(FetchAttachmentsFlow(missing, self.other_side))
