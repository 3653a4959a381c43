"""In-memory service implementations.

The port's own copy of ``corda_tpu/node/services/inmemory.py``.

Capability matches: InMemoryIdentityService (reference:
node/src/main/kotlin/net/corda/node/services/identity/InMemoryIdentityService.kt),
E2ETestKeyManagementService (node/.../keys/E2ETestKeyManagementService.kt),
in-memory transaction/attachment storage, NodeVaultService UTXO tracking
(node/.../vault/NodeVaultService.kt:39), InMemoryNetworkMapCache
(node/.../network/InMemoryNetworkMapCache.kt), InMemoryUniquenessProvider
(node/.../transactions/InMemoryUniquenessProvider.kt:14).

These are the MockNetwork-tier services; persistent (sqlite) twins live in
persistence.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from ...contracts.structures import StateAndRef, StateRef
from ...crypto.composite import CompositeKey
from ...crypto.hashes import SecureHash
from ...crypto.keys import DigitalSignature, KeyPair, PublicKey
from ...crypto.party import Party
from .api import (
    AttachmentStorage,
    ConsumingTx,
    IdentityService,
    KeyManagementService,
    NetworkMapCache,
    NodeInfo,
    StateMachineTransactionMapping,
    TransactionMappingStorage,
    TransactionStorage,
    UniquenessConflict,
    UniquenessException,
    UniquenessProvider,
    Vault,
    VaultService,
)


class InMemoryIdentityService(IdentityService):
    def __init__(self):
        self._by_key: dict[CompositeKey, Party] = {}
        self._by_name: dict[str, Party] = {}

    def register_identity(self, party: Party) -> None:
        self._by_key[party.owning_key] = party
        self._by_name[party.name] = party

    def party_from_key(self, key: CompositeKey) -> Party | None:
        direct = self._by_key.get(key)
        if direct is not None:
            return direct
        # A single raw key also identifies parties whose composite contains it.
        for owning, party in self._by_key.items():
            if owning == key or owning.keys == key.keys:
                return party
        return None

    def party_from_name(self, name: str) -> Party | None:
        return self._by_name.get(name)


class SimpleKeyManagementService(KeyManagementService):
    """Keys held in memory; fresh keys generated on demand (reference:
    E2ETestKeyManagementService.kt)."""

    def __init__(self, initial_keys: Iterable[KeyPair] = ()):
        self._keys: dict[PublicKey, KeyPair] = {kp.public: kp for kp in initial_keys}

    @property
    def keys(self) -> dict[PublicKey, KeyPair]:
        return dict(self._keys)

    def add_key(self, kp: KeyPair) -> None:
        self._keys[kp.public] = kp

    def fresh_key(self) -> KeyPair:
        kp = KeyPair.generate()
        self._keys[kp.public] = kp
        return kp

    def sign(self, content: bytes, with_key: PublicKey) -> DigitalSignature.WithKey:
        kp = self._keys.get(with_key)
        if kp is None:
            raise KeyError(f"No private key known for {with_key}")
        return kp.sign(content)


class InMemoryTransactionStorage(TransactionStorage):
    def __init__(self):
        self._txs: dict[SecureHash, object] = {}
        self._observers: list[Callable] = []

    def add_transaction(self, stx) -> None:
        if stx.id in self._txs:
            return
        self._txs[stx.id] = stx
        for obs in list(self._observers):
            obs(stx)

    def get_transaction(self, id: SecureHash):
        return self._txs.get(id)

    def all_transactions(self):
        return list(self._txs.values())  # dicts preserve insertion order

    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)

    def __len__(self):
        return len(self._txs)


class InMemoryTransactionMappingStorage(TransactionMappingStorage):
    """Flow-run → tx provenance log (reference:
    node/.../services/transactions/InMemoryStateMachineRecordedTransaction
    MappingStorage capability, via the Services.kt interface)."""

    def __init__(self):
        self._mappings: list[StateMachineTransactionMapping] = []
        self._seen: set[tuple[bytes, SecureHash]] = set()
        self._observers: list[Callable] = []

    def add_mapping(self, run_id: bytes, tx_id: SecureHash) -> None:
        key = (bytes(run_id), tx_id)
        if key in self._seen:
            return
        self._seen.add(key)
        mapping = StateMachineTransactionMapping(bytes(run_id), tx_id)
        self._mappings.append(mapping)
        for obs in list(self._observers):
            obs(mapping)

    def mappings(self) -> list[StateMachineTransactionMapping]:
        return list(self._mappings)

    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)


@dataclass(frozen=True)
class _InMemoryAttachment:
    id: SecureHash
    data: bytes

    def open(self) -> bytes:
        return self.data


class InMemoryAttachmentStorage(AttachmentStorage):
    """Content-addressed blobs (reference: NodeAttachmentService.kt, minus disk)."""

    def __init__(self):
        self._blobs: dict[SecureHash, bytes] = {}

    def import_attachment(self, data: bytes) -> SecureHash:
        att_id = SecureHash.sha256(data)
        self._blobs.setdefault(att_id, data)
        return att_id

    def open_attachment(self, id: SecureHash):
        data = self._blobs.get(id)
        return None if data is None else _InMemoryAttachment(id, data)


class NodeVaultService(VaultService):
    """UTXO tracking with relevancy filtering and update stream (reference:
    NodeVaultService.kt:39-120)."""

    def __init__(self, our_keys: Callable[[], set[PublicKey]]):
        self._our_keys = our_keys
        self._unconsumed: dict[StateRef, StateAndRef] = {}
        # Per-concrete-type secondary index: typed queries (the
        # coin-selection entry point) stop copying + isinstance-filtering
        # the whole vault. Each inner dict shares the outer insertion
        # order, so a single-type lookup returns exactly the subsequence
        # the old full scan produced.
        self._by_type: dict[type, dict[StateRef, StateAndRef]] = {}
        self._observers: list[Callable[[Vault.Update], None]] = []

    @property
    def current_vault(self) -> Vault:
        return Vault(tuple(self._unconsumed.values()))

    def unconsumed_states(self, of_type: type | None = None) -> list:
        """Typed vault query (reference: VaultService statesOfType — the
        coin-selection entry point)."""
        return list(self.iter_unconsumed(of_type))

    def iter_unconsumed(self, of_type: type | None = None, batch: int = 512):
        if of_type is None:
            yield from self._unconsumed.values()
            return
        matching = [stored for stored in self._by_type
                    if issubclass(stored, of_type)]
        if len(matching) == 1:
            yield from self._by_type[matching[0]].values()
        elif matching:
            # Several stored concrete types satisfy the query (an
            # interface/base-class lookup): fall back to the ordered
            # global scan so interleaving matches the pre-index listing
            # exactly.
            for sar in self._unconsumed.values():
                if isinstance(sar.state.data, of_type):
                    yield sar

    def _is_relevant(self, state) -> bool:
        ours = self._our_keys()
        return any(
            bool(set(participant.keys) & ours) for participant in state.data.participants
        )

    def notify_all(self, txns: Iterable) -> Vault:
        net = None
        for stx in txns:
            wtx = stx.tx if hasattr(stx, "tx") else stx
            consumed = frozenset(
                self._unconsumed[ref] for ref in wtx.inputs if ref in self._unconsumed
            )
            produced = frozenset(
                wtx.out_ref(i)
                for i, out in enumerate(wtx.outputs)
                if self._is_relevant(out)
            )
            update = Vault.Update(consumed=consumed, produced=produced)
            if update.is_empty:
                continue
            for sar in consumed:
                del self._unconsumed[sar.ref]
                bucket = self._by_type.get(type(sar.state.data))
                if bucket is not None:
                    bucket.pop(sar.ref, None)
                    if not bucket:
                        del self._by_type[type(sar.state.data)]
            for sar in produced:
                self._unconsumed[sar.ref] = sar
                self._by_type.setdefault(type(sar.state.data),
                                         {})[sar.ref] = sar
            locks = self.__dict__.get("_softlocks")
            if locks is not None:
                locks.release([sar.ref for sar in consumed])
            net = update if net is None else net + update
            for obs in list(self._observers):
                obs(update)
        return self.current_vault

    def subscribe(self, observer: Callable[[Vault.Update], None]) -> None:
        self._observers.append(observer)


class InMemoryNetworkMapCache(NetworkMapCache):
    def __init__(self):
        self._nodes: list[NodeInfo] = []
        self._observers: list[Callable] = []

    @property
    def party_nodes(self) -> list[NodeInfo]:
        return list(self._nodes)

    def add_node(self, node: NodeInfo) -> None:
        self._nodes = [n for n in self._nodes if n.legal_identity != node.legal_identity]
        self._nodes.append(node)
        for obs in list(self._observers):
            obs("add", node)

    def remove_node(self, node: NodeInfo) -> None:
        self._nodes = [n for n in self._nodes if n.legal_identity != node.legal_identity]
        for obs in list(self._observers):
            obs("remove", node)

    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)


class InMemoryUniquenessProvider(UniquenessProvider):
    """First-committer-wins commit log (reference:
    InMemoryUniquenessProvider.kt:14-40)."""

    def __init__(self):
        self._committed: dict[StateRef, ConsumingTx] = {}

    def commit(
        self, states: Sequence[StateRef], tx_id: SecureHash, caller_identity: Party
    ) -> None:
        conflicts = {
            ref: self._committed[ref]
            for ref in states
            if ref in self._committed and self._committed[ref].id != tx_id
        }
        if conflicts:
            raise UniquenessException(UniquenessConflict(dict(conflicts)))
        for i, ref in enumerate(states):
            self._committed.setdefault(ref, ConsumingTx(tx_id, i, caller_identity))

    @property
    def committed_count(self) -> int:
        return len(self._committed)
