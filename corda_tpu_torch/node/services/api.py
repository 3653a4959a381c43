"""Service interfaces — the ServiceHub surface.

The port's own copy of ``corda_tpu/node/services/api.py``. The vault
query surface imports ``.vault`` lazily, as the original does.

Capability match for the reference's core node-services API (reference:
core/src/main/kotlin/net/corda/core/node/ServiceHub.kt:22-77 and
core/src/main/kotlin/net/corda/core/node/services/Services.kt,
UniquenessProvider.kt, NetworkMapCache.kt, IdentityService.kt,
ServiceType.kt, NodeInfo.kt): every flow and service reaches the node's
capabilities through this registry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

from ...contracts.structures import StateAndRef, StateRef, Timestamp, TransactionState
from ...crypto.composite import CompositeKey
from ...crypto.hashes import SecureHash
from ...crypto.keys import DigitalSignature, KeyPair, PublicKey
from ...crypto.party import Party
from ...serialization.codec import register
from ...utils.excheckpoint import register_flow_exception


# ---------------------------------------------------------------------------
# Service descriptors (reference: ServiceType.kt:35-60, NodeInfo.kt)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class ServiceType:
    """Hierarchical dotted service identifier (reference: ServiceType.kt)."""

    id: str

    def is_sub_type_of(self, parent: "ServiceType") -> bool:
        return self.id == parent.id or self.id.startswith(parent.id + ".")

    def get_sub_type(self, sub: str) -> "ServiceType":
        return ServiceType(f"{self.id}.{sub}")

    def __str__(self) -> str:
        return self.id


CORDA_SERVICE = ServiceType("corda")
NOTARY_TYPE = CORDA_SERVICE.get_sub_type("notary")
SIMPLE_NOTARY = NOTARY_TYPE.get_sub_type("simple")
VALIDATING_NOTARY = NOTARY_TYPE.get_sub_type("validating")
RAFT_VALIDATING_NOTARY = VALIDATING_NOTARY.get_sub_type("raft")
NETWORK_MAP_TYPE = CORDA_SERVICE.get_sub_type("network_map")


@register
@dataclass(frozen=True)
class ServiceInfo:
    """An advertised service: type plus optional cluster identity name
    (reference: ServiceInfo in ServiceType.kt)."""

    type: ServiceType
    name: str | None = None


@register
@dataclass(frozen=True)
class PhysicalLocation:
    """Approximate geography for visualisation (reference:
    core/.../node/PhysicalLocationStructures.kt)."""

    latitude: float | None = None
    longitude: float | None = None
    description: str = ""


@register
@dataclass(frozen=True)
class NodeInfo:
    """Everything the network map knows about a node (reference: NodeInfo.kt):
    its transport address, legal identity, advertised services."""

    address: Any  # a MessageRecipient understood by the messaging layer
    legal_identity: Party
    advertised_services: tuple[ServiceInfo, ...] = ()
    physical_location: PhysicalLocation | None = None

    @property
    def notary_identity(self) -> Party:
        return self.legal_identity


# ---------------------------------------------------------------------------
# Vault (reference: Services.kt:41-200)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Vault:
    """An immutable snapshot of unconsumed states (reference: Services.kt:41)."""

    states: tuple[StateAndRef, ...]

    @dataclass(frozen=True)
    class Update:
        """Delta produced by a transaction hitting the vault
        (reference: Services.kt:58-78)."""

        consumed: frozenset
        produced: frozenset

        @property
        def is_empty(self) -> bool:
            return not self.consumed and not self.produced

        def __add__(self, rhs: "Vault.Update") -> "Vault.Update":
            combined_produced = (self.produced - rhs.consumed) | rhs.produced
            return Vault.Update(
                consumed=self.consumed | (rhs.consumed - self.produced),
                produced=combined_produced,
            )


NO_UPDATE = Vault.Update(frozenset(), frozenset())


class VaultService:
    """Tracks unconsumed states relevant to the node (reference:
    Services.kt:95-200).

    The query/selection surface (query, iter_unconsumed, select_coins,
    balances) has in-memory default implementations here so every engine
    answers the same API; the indexed engine (services/vault.py)
    overrides them with sqlite pushdowns. Callers should prefer these
    over materializing current_vault — a million-state vault must never
    be copied to answer a page or pick coins."""

    @property
    def current_vault(self) -> Vault:
        raise NotImplementedError

    def notify_all(self, txns: Iterable) -> Vault:
        """Feed observed (verified) transactions into the vault."""
        raise NotImplementedError

    def notify(self, tx) -> Vault:
        return self.notify_all([tx])

    def subscribe(self, observer: Callable[[Vault.Update], None]) -> None:
        raise NotImplementedError

    def states_of_type(self, cls: type) -> list[StateAndRef]:
        return [s for s in self.current_vault.states if isinstance(s.state.data, cls)]

    # -- paginated query surface (engine-shared API) -----------------------

    @property
    def softlocks(self):
        """The engine's soft-lock table, created on first selection."""
        sl = self.__dict__.get("_softlocks")
        if sl is None:
            from .vault import SoftLockManager

            sl = self._softlocks = SoftLockManager()
        return sl

    def iter_unconsumed(self, of_type: type | None = None, batch: int = 512):
        """Iterate unconsumed states without materializing a snapshot."""
        for sar in self.current_vault.states:
            if of_type is None or isinstance(sar.state.data, of_type):
                yield sar

    def unconsumed_states(self, of_type: type | None = None) -> list:
        """Compatibility shim: a full typed listing via the iterator."""
        return list(self.iter_unconsumed(of_type))

    def query(self, q) -> Any:
        """Answer one VaultQuery page. Default: python-side predicate
        evaluation over the iterator with the same (ref_txhash,
        ref_index) keyset order as the indexed engine, so pagination
        cursors mean the same thing on both."""
        from ...obs import telemetry as _tm
        from ...obs import trace as _obs
        from .vault import (
            VaultPage,
            _participant_leaves,
            _sort_key,
            coin_of,
            record_vault_stage,
        )

        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        _tm.inc("vault_queries_total")
        after = None
        if q.after is not None:
            after = (bytes(q.after[0]), int(q.after[1]))
        want_leaves = None
        if q.participant is not None:
            want_leaves = set(_participant_leaves(q.participant))
            if not want_leaves:
                return VaultPage((), None)
        page = max(1, int(q.page_size))
        out: list[StateAndRef] = []
        for sar in sorted(self.iter_unconsumed(q.state_type), key=_sort_key):
            if after is not None and _sort_key(sar) <= after:
                continue
            if (q.currency is not None or q.min_amount is not None
                    or q.max_amount is not None):
                currency, amount = coin_of(sar.state.data)
                if q.currency is not None and currency != q.currency:
                    continue
                if q.min_amount is not None and (
                        amount is None or amount < q.min_amount):
                    continue
                if q.max_amount is not None and (
                        amount is None or amount > q.max_amount):
                    continue
            if want_leaves is not None and not any(
                    set(_participant_leaves(p)) & want_leaves
                    for p in sar.state.data.participants):
                continue
            out.append(sar)
            if len(out) > page:
                break
        more = len(out) > page
        out = out[:page]
        next_cursor = _sort_key(out[-1]) if more and out else None
        record_vault_stage(t0, attrs={"rows": len(out), "op": "query"})
        return VaultPage(tuple(out), next_cursor)

    def select_coins(self, currency: str, quantity: int,
                     holder: bytes = b"", ttl_s: float | None = None) -> list:
        """Soft-locked coin selection, largest-first. Default engine:
        scan + sort candidates in memory; same reservation semantics and
        amount-DESC order as the indexed engine's index walk. On
        insufficient funds the partial set is returned unlocked (the
        asset's generate_spend raises InsufficientBalanceException)."""
        from ...obs import telemetry as _tm
        from ...obs import trace as _obs
        from .vault import _sort_key, coin_of, record_vault_stage

        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        _tm.inc("vault_queries_total")
        locks = self.softlocks
        expired = locks.sweep()
        if expired:
            _tm.inc("vault_softlock_expired_total", expired)
        holder = bytes(holder) or b"anon"
        candidates = []
        for sar in self.iter_unconsumed():
            c, amount = coin_of(sar.state.data)
            if c == currency:
                candidates.append((-amount, _sort_key(sar), sar))
        candidates.sort(key=lambda t: t[:2])
        gathered: list[StateAndRef] = []
        covered = 0
        for neg_amount, _key, sar in candidates:
            if not locks.try_lock(sar.ref, holder, ttl_s):
                _tm.inc("vault_selection_conflicts_total")
                continue
            gathered.append(sar)
            covered += -neg_amount
            if covered >= quantity:
                break
        if covered < quantity:
            locks.release([sar.ref for sar in gathered], holder)
        record_vault_stage(t0, attrs={"rows": len(gathered), "op": "select"})
        return gathered

    def release_coins(self, refs: Iterable[StateRef],
                      holder: bytes = b"") -> None:
        """Drop this holder's reservations (a flow that selected but
        will not spend must give its coins back before the TTL)."""
        self.softlocks.release(refs, bytes(holder) or b"anon")

    def balances(self) -> dict[str, int]:
        """Per-currency unconsumed totals. Default: one pass over the
        iterator; the indexed engine answers from its aggregate table."""
        from .vault import coin_of

        out: dict[str, int] = {}
        for sar in self.iter_unconsumed():
            currency, amount = coin_of(sar.state.data)
            if currency is not None:
                out[currency] = out.get(currency, 0) + amount
        return {c: q for c, q in out.items() if q != 0}


# ---------------------------------------------------------------------------
# Identity, keys, storage (reference: Services.kt:206-260, IdentityService.kt)
# ---------------------------------------------------------------------------


class IdentityService:
    """Key → Party lookups (reference: core/.../services/IdentityService.kt)."""

    def register_identity(self, party: Party) -> None:
        raise NotImplementedError

    def party_from_key(self, key: CompositeKey) -> Party | None:
        raise NotImplementedError

    def party_from_name(self, name: str) -> Party | None:
        raise NotImplementedError


class KeyManagementService:
    """The node's signing keys (reference: Services.kt:206-224)."""

    @property
    def keys(self) -> dict[PublicKey, KeyPair]:
        raise NotImplementedError

    def fresh_key(self) -> KeyPair:
        raise NotImplementedError

    def sign(self, content: bytes, with_key: PublicKey) -> DigitalSignature.WithKey:
        raise NotImplementedError


class AttachmentStorage:
    """Content-addressed attachment blobs (reference:
    core/.../services/AttachmentStorage in Services.kt:226+)."""

    def open_attachment(self, id: SecureHash):
        raise NotImplementedError

    def import_attachment(self, data: bytes) -> SecureHash:
        raise NotImplementedError


class TransactionStorage:
    """Validated-transaction map (reference: core/.../services/
    TransactionStorage in Services.kt)."""

    def add_transaction(self, stx) -> None:
        raise NotImplementedError

    def get_transaction(self, id: SecureHash):
        raise NotImplementedError

    def subscribe(self, observer: Callable) -> None:
        raise NotImplementedError


@register
@dataclass(frozen=True)
class StateMachineTransactionMapping:
    """Which flow produced/recorded which transaction (reference:
    core/.../node/services/StateMachineRecordedTransactionMappingStorage.kt
    and the StateMachineTransactionMapping pair in Services.kt) — the join
    the explorer's transaction view uses to attribute ledger activity to
    the protocol run that caused it."""

    run_id: bytes
    tx_id: SecureHash


class TransactionMappingStorage:
    """Flow-run → transaction provenance log (reference:
    StateMachineRecordedTransactionMappingStorage.kt). Append-only and
    deduplicated on (run_id, tx_id): checkpoint-replayed flows re-record
    their transactions, which must not duplicate history or re-notify."""

    def add_mapping(self, run_id: bytes, tx_id: SecureHash) -> None:
        raise NotImplementedError

    def mappings(self) -> list[StateMachineTransactionMapping]:
        """Every recorded mapping in insertion order."""
        raise NotImplementedError

    def subscribe(self, observer: Callable) -> None:
        """observer(mapping) fires once per FRESH mapping."""
        raise NotImplementedError


@dataclass
class StorageService:
    """Bundle of storage sub-services (reference: Services.kt:226-259)."""

    validated_transactions: TransactionStorage
    attachments: AttachmentStorage
    state_machine_recorded_transaction_mapping: (
        TransactionMappingStorage | None) = None


# ---------------------------------------------------------------------------
# Uniqueness (reference: UniquenessProvider.kt:13-32)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class ConsumingTx:
    """Who consumed an input and where (reference: UniquenessProvider.kt:24-30)."""

    id: SecureHash
    input_index: int
    requesting_party: Party


@register
@dataclass(frozen=True)
class UniquenessConflict:
    """The double-spend evidence returned on conflict
    (reference: UniquenessProvider.kt:22)."""

    state_history: dict  # StateRef -> ConsumingTx


class UniquenessUnavailableException(Exception):
    """The uniqueness provider could not DECIDE in time (consensus quorum /
    leadership unavailable). Retriable, and says nothing about the
    transaction — the typed sibling of UniquenessException so callers never
    confuse "degraded service" with "double spend". Concrete providers
    subclass (raft.CommitTimeoutException)."""


@register_flow_exception
class UniquenessException(Exception):
    """Keeps its structured conflict through checkpoint replay."""

    def __init__(self, error: UniquenessConflict):
        super().__init__(f"Uniqueness conflict: {error}")
        self.error = error

    def __checkpoint_payload__(self):
        return self.error

    @classmethod
    def __from_checkpoint__(cls, message, payload):
        return cls(payload)


class UniquenessProvider:
    """First-committer-wins input commit log (reference:
    UniquenessProvider.kt:13-20)."""

    def commit(
        self,
        states: Sequence[StateRef],
        tx_id: SecureHash,
        caller_identity: Party,
    ) -> None:
        """Atomically claim all states for tx_id or raise UniquenessException."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Network map cache (reference: NetworkMapCache.kt)
# ---------------------------------------------------------------------------


class NetworkMapCache:
    """Local directory of known nodes."""

    @property
    def party_nodes(self) -> list[NodeInfo]:
        raise NotImplementedError

    @property
    def notary_nodes(self) -> list[NodeInfo]:
        return [
            n
            for n in self.party_nodes
            if any(s.type.is_sub_type_of(NOTARY_TYPE) for s in n.advertised_services)
        ]

    def get_node_by_legal_identity(self, party: Party) -> NodeInfo | None:
        for n in self.party_nodes:
            if n.legal_identity == party:
                return n
        return None

    def get_nodes_with_service(self, service_type: ServiceType) -> list[NodeInfo]:
        return [
            n
            for n in self.party_nodes
            if any(s.type.is_sub_type_of(service_type) for s in n.advertised_services)
        ]

    def get_any_notary(self) -> Party | None:
        nodes = self.notary_nodes
        return nodes[0].notary_identity if nodes else None

    def add_node(self, node: NodeInfo) -> None:
        raise NotImplementedError

    def remove_node(self, node: NodeInfo) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# The hub (reference: ServiceHub.kt:22-77)
# ---------------------------------------------------------------------------


@dataclass
class ServiceHub:
    """The service registry handed to flows and services."""

    identity_service: IdentityService
    key_management_service: KeyManagementService
    storage_service: StorageService
    vault_service: VaultService
    network_map_cache: NetworkMapCache
    clock: Any = None
    my_info: NodeInfo | None = None

    def load_state(self, ref: StateRef) -> TransactionState | None:
        """Resolve a StateRef via validated-transaction storage
        (ServiceHub.kt:59-67)."""
        stx = self.storage_service.validated_transactions.get_transaction(ref.txhash)
        if stx is None:
            return None
        return stx.tx.outputs[ref.index]

    def record_transactions(self, txs, run_id: bytes | None = None) -> None:
        """Store + vault-notify observed transactions (ServiceHub.kt:38-46).

        Idempotent: transactions already in durable storage are skipped, so
        checkpoint-replayed flows re-recording a dependency cannot resurrect
        vault states that a later transaction already consumed.

        `run_id` (when the caller is a flow — FlowLogic.record_transactions
        passes its own) lands each tx in the provenance log, the reference's
        StateMachineRecordedTransactionMappingStorage capability. Mapped for
        EVERY tx passed, not just fresh ones: a flow that records an
        already-known dependency still touched it, and the mapping store
        dedupes (run_id, tx_id) itself."""
        storage = self.storage_service.validated_transactions
        fresh = [stx for stx in txs if storage.get_transaction(stx.id) is None]
        for stx in fresh:
            storage.add_transaction(stx)
        mapping = self.storage_service.state_machine_recorded_transaction_mapping
        if mapping is not None and run_id is not None:
            for stx in txs:
                mapping.add_mapping(run_id, stx.id)
        if fresh:
            self.vault_service.notify_all(fresh)

    @property
    def legal_identity_key(self) -> KeyPair:
        assert self.my_info is not None
        key = self.my_info.legal_identity.owning_key.single_key
        return self.key_management_service.keys[key]

    @property
    def my_identity(self) -> Party:
        assert self.my_info is not None
        return self.my_info.legal_identity
