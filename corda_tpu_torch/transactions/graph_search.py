"""Backwards search over the transaction dependency graph.

The port's own copy of ``corda_tpu/transactions/graph_search.py``.

Capability match for the reference's TransactionGraphSearch (reference:
core/src/main/kotlin/net/corda/core/contracts/TransactionGraphSearch.kt):
starting from a transaction, walk its input ancestry through local storage
and collect transactions matching a query (e.g. "which issuance introduced
this cash?" — used by the trader demo's provenance display).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..crypto.hashes import SecureHash
from .wire import WireTransaction


@dataclass
class Query:
    """Match criteria (TransactionGraphSearch.Query): command type and/or an
    arbitrary predicate over the WireTransaction."""

    with_command_of_type: type | None = None
    predicate: Callable[[WireTransaction], bool] | None = None

    def matches(self, wtx: WireTransaction) -> bool:
        if self.with_command_of_type is not None and not any(
                isinstance(cmd.value, self.with_command_of_type)
                for cmd in wtx.commands):
            return False
        if self.predicate is not None and not self.predicate(wtx):
            return False
        return True


class TransactionGraphSearch:
    def __init__(self, transaction_storage, start_points: list[WireTransaction]):
        self._storage = transaction_storage
        self._start = list(start_points)

    def run(self, query: Query) -> list[WireTransaction]:
        """BFS over input ancestry; returns matches in discovery order,
        deduplicated (TransactionGraphSearch.call)."""
        next_hashes: list[SecureHash] = [
            ref.txhash for wtx in self._start for ref in wtx.inputs]
        visited: set[SecureHash] = set()
        results: list[WireTransaction] = []
        while next_hashes:
            h = next_hashes.pop(0)
            if h in visited:
                continue
            visited.add(h)
            stx = self._storage.get_transaction(h)
            if stx is None:
                continue
            wtx = stx.tx
            if query.matches(wtx):
                results.append(wtx)
            next_hashes.extend(ref.txhash for ref in wtx.inputs)
        return results
