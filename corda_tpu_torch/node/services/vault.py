"""The indexed vault plane: durable O(log n) queries over sqlite.

The port's own copy of ``corda_tpu/node/services/vault.py``.

Capability match for the reference's DB-backed vault (reference:
node/src/main/kotlin/net/corda/node/services/vault/NodeVaultService.kt:39
over Services.kt:95 — the vault is a *database projection* of the ledger,
not an in-memory dict), built for the ROADMAP item-4 scale point:
millions of unconsumed states, thousands of parties.

Three tables in the node's single sqlite file (persistence.NodeDatabase):

  * ``vault_states`` — one row per unconsumed state: the (ref_txhash,
    ref_index) primary key, pushdown columns (state_type wire name,
    currency, amount for fungibles), the canonical-codec
    TransactionState blob, and a per-record CRC32C column following the
    store's durability convention (verify-on-read, corrupt rows
    quarantined — a bitrot'd vault row becomes a visible repair event,
    never a silently wrong coin selection). Covering indexes on
    state_type and (currency, amount) make typed queries and coin
    selection index walks instead of full scans.
  * ``vault_participants`` — one row per (leaf public key, state) so
    participant-pushdown queries resolve through an index.
  * ``vault_balances`` — per-currency quantity aggregates maintained by
    delta UPSERTs on every vault update: balances are O(1) reads, the
    bounded-memory replacement for scanning observers.

**Watermark incremental boot**: every ``notify_all`` advances a
persisted ``vault_watermark`` setting to the highest ``transactions``
rowid it has folded in. A restarted node calls ``rebuild_from`` which
replays only ``rowid > watermark`` — the delta, not the ledger — in
bounded batches. Replay is idempotent by construction (produced rows
INSERT OR IGNORE, consumed rows DELETE-if-present, balance deltas only
applied when a row actually changed), so a crash between the watermark
and the vault rows re-runs cleanly.

**Soft-locked coin selection**: ``select_coins`` walks the
(currency, amount DESC) index and takes TTL'd in-process reservations on
the refs it returns, so two concurrent flows spending from the same
vault stop double-selecting (the loser skips the locked coin and picks
a different one instead of building a doomed double-spend that bounces
off the notary). Locks release on consumption, on explicit release, or
by TTL expiry — a crashed flow can never wedge a coin forever.

The legacy in-memory service stays the default engine; ``[vault]
indexed = true`` (or CORDA_TPU_VAULT_INDEXED=1) selects this one, and
tests/test_vault.py pins that both engines derive the identical
unconsumed set from the same update stream.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable

from ...contracts.structures import StateAndRef, StateRef
from ...crypto.hashes import SecureHash
from ...obs import telemetry as _tm
from ...obs import trace as _obs
from ...serialization.codec import (
    class_for_wire_name,
    deserialize,
    serialize,
    wire_name_of,
)
from . import integrity as _integrity
from .api import Vault, VaultService

__all__ = [
    "IndexedVaultService",
    "SoftLockManager",
    "VaultPage",
    "VaultQuery",
    "coin_of",
    "record_vault_stage",
    "seed_states",
]


def record_vault_stage(t0: float, attrs: dict) -> None:
    """Emit one vault_query span under the active trace (no-op when
    tracing is off); t0 came from _obs.now() at query entry."""
    if _obs.ACTIVE is None:
        return
    pctx = _obs.get_context()
    kw = {"attrs": attrs}
    if pctx is not None:
        kw.update(trace_id=pctx[0], parent=pctx[1])
    _obs.record("vault_query", t0, _obs.now(), **kw)


def coin_of(data) -> tuple[str | None, int | None]:
    """(currency, quantity) for a fungible state, (None, None) otherwise.

    Duck-typed like the schema projection: any state shaped
    ``.amount.token.product`` / ``.amount.quantity`` (CashState, every
    FungibleAsset) participates in the currency/amount pushdown columns
    and the balance aggregates with no node-tier import of finance."""
    amount = getattr(data, "amount", None)
    token = getattr(amount, "token", None)
    product = getattr(token, "product", None)
    quantity = getattr(amount, "quantity", None)
    if product is None or not isinstance(quantity, int) \
            or isinstance(quantity, bool):
        return (None, None)
    return (str(product), int(quantity))


@dataclass(frozen=True)
class VaultQuery:
    """Pushdown predicates + keyset cursor for one vault page.

    ``after`` is the keyset cursor — the (ref_txhash bytes, ref_index)
    of the last row of the previous page; pagination is stable under
    concurrent consumption because the cursor names a position in the
    (ref_txhash, ref_index) order, never an OFFSET that shifts when rows
    before it are consumed."""

    state_type: type | None = None
    currency: str | None = None
    min_amount: int | None = None
    max_amount: int | None = None
    participant: object | None = None  # PublicKey or CompositeKey
    after: tuple[bytes, int] | None = None
    page_size: int = 256


@dataclass(frozen=True)
class VaultPage:
    """One page of unconsumed states plus the cursor for the next."""

    states: tuple[StateAndRef, ...]
    next_cursor: tuple[bytes, int] | None


def _participant_leaves(key) -> tuple[bytes, ...]:
    """The leaf public-key encodings of a participant key (a CompositeKey
    exposes .keys; a bare PublicKey is its own single leaf)."""
    leaves = getattr(key, "keys", None)
    if leaves is None:
        encoded = getattr(key, "encoded", None)
        return (bytes(encoded),) if encoded is not None else ()
    return tuple(bytes(pk.encoded) for pk in leaves)


def _sort_key(sar: StateAndRef) -> tuple[bytes, int]:
    return (sar.ref.txhash.bytes, sar.ref.index)


class SoftLockManager:
    """TTL'd in-process coin reservations.

    Deliberately in-memory, not a table: a soft lock is advisory state
    scoped to the selecting process — the notary's first-committer-wins
    commit log stays the only double-spend authority, so a crash that
    loses the lock table loses nothing but a hint (and the TTL bounds
    how long a crashed flow's reservation can shadow a coin)."""

    def __init__(self, ttl_s: float = 5.0):
        self.ttl_s = float(ttl_s)
        self._locks: dict[StateRef, tuple[bytes, float]] = {}
        self._mu = threading.Lock()

    def sweep(self, now: float | None = None) -> int:
        """Drop expired reservations; returns how many were reaped."""
        now = time.monotonic() if now is None else now
        with self._mu:
            dead = [r for r, (_h, exp) in self._locks.items() if exp <= now]
            for ref in dead:
                del self._locks[ref]
        return len(dead)

    def try_lock(self, ref: StateRef, holder: bytes,
                 ttl_s: float | None = None,
                 now: float | None = None) -> bool:
        """Reserve ``ref`` for ``holder``; False if another live holder
        has it (re-locking your own reservation refreshes the TTL)."""
        now = time.monotonic() if now is None else now
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        with self._mu:
            held = self._locks.get(ref)
            if held is not None and held[1] > now and held[0] != holder:
                return False
            self._locks[ref] = (bytes(holder), now + ttl)
        return True

    def holder_of(self, ref: StateRef,
                  now: float | None = None) -> bytes | None:
        now = time.monotonic() if now is None else now
        with self._mu:
            held = self._locks.get(ref)
            return held[0] if held is not None and held[1] > now else None

    def release(self, refs: Iterable[StateRef],
                holder: bytes | None = None) -> None:
        """Drop reservations on ``refs`` (any holder when None — the
        consumption path: a spent coin's lock is moot whoever held it)."""
        with self._mu:
            for ref in refs:
                held = self._locks.get(ref)
                if held is not None and (holder is None
                                         or held[0] == holder):
                    del self._locks[ref]

    def __len__(self) -> int:
        return len(self._locks)


def _row_crc(ref_txhash: bytes, ref_index: int, blob: bytes) -> int:
    """The store's convention: one CRC32C per record, chained over the
    primary key and the payload so a row can never validate against
    another row's blob."""
    crc = _integrity.crc32c(ref_txhash)
    crc = _integrity.crc32c(ref_index.to_bytes(4, "big"), crc)
    return _integrity.crc32c(blob, crc)


_VAULT_SCHEMA = """
CREATE TABLE IF NOT EXISTS vault_states (
    ref_txhash BLOB NOT NULL,
    ref_index  INTEGER NOT NULL,
    state_type TEXT NOT NULL,
    currency   TEXT,
    amount     INTEGER,
    blob       BLOB NOT NULL,
    crc        INTEGER,
    PRIMARY KEY (ref_txhash, ref_index)
);
CREATE INDEX IF NOT EXISTS vault_states_by_type
    ON vault_states (state_type, ref_txhash, ref_index);
CREATE INDEX IF NOT EXISTS vault_states_by_coin
    ON vault_states (currency, amount DESC, ref_txhash, ref_index);
CREATE TABLE IF NOT EXISTS vault_participants (
    participant BLOB NOT NULL,
    ref_txhash  BLOB NOT NULL,
    ref_index   INTEGER NOT NULL,
    PRIMARY KEY (participant, ref_txhash, ref_index)
);
CREATE TABLE IF NOT EXISTS vault_balances (
    currency TEXT PRIMARY KEY,
    quantity INTEGER NOT NULL
);
"""

WATERMARK_KEY = "vault_watermark"


class IndexedVaultService(VaultService):
    """Durable sqlite vault engine: same notify/observe contract as the
    in-memory NodeVaultService, O(log n) queries, watermark boot."""

    def __init__(self, db, our_keys: Callable[[], set],
                 softlock_ttl_s: float = 5.0):
        self._db = db
        self._our_keys = our_keys
        self._observers: list[Callable[[Vault.Update], None]] = []
        self._softlocks = SoftLockManager(ttl_s=softlock_ttl_s)
        with db.lock:
            db.conn.executescript(_VAULT_SCHEMA)
            db.commit()

    # -- relevancy (identical semantics to the in-memory engine) --------

    def _is_relevant(self, state) -> bool:
        ours = self._our_keys()
        return any(
            bool(set(participant.keys) & ours)
            for participant in state.data.participants)

    # -- row <-> state --------------------------------------------------

    def _decode_row(self, ref_txhash, ref_index, blob, crc) \
            -> StateAndRef | None:
        ref_txhash, blob = bytes(ref_txhash), bytes(blob)
        if crc is not None and _row_crc(ref_txhash, int(ref_index),
                                        blob) != int(crc):
            self._quarantine(ref_txhash, int(ref_index), blob)
            return None
        return StateAndRef(deserialize(blob),
                           StateRef(SecureHash(ref_txhash), int(ref_index)))

    def _quarantine(self, ref_txhash: bytes, ref_index: int,
                    blob: bytes) -> None:
        """A corrupt vault row becomes a repair event, not a wrong
        answer: quarantined (counted), deleted, and its balance/
        participant shadow rows dropped with it."""
        with self._db.lock:
            _integrity.quarantine_row(
                self._db.conn, "vault_state",
                ref_txhash + ref_index.to_bytes(4, "big"), blob,
                "vault row crc mismatch")
            self._drop_row(ref_txhash, ref_index)
            self._db.commit()
        _integrity.bump("vault_rows_quarantined")

    # -- mutation -------------------------------------------------------

    def _insert_sar(self, sar: StateAndRef) -> bool:
        """INSERT one unconsumed state; False when the row already
        existed (idempotent replay). Balance/participant deltas apply
        only on a real insert so replays can never double-count."""
        conn = self._db.conn
        blob = serialize(sar.state).bytes
        currency, amount = coin_of(sar.state.data)
        key = (sar.ref.txhash.bytes, sar.ref.index)
        before = conn.total_changes
        conn.execute(
            "INSERT OR IGNORE INTO vault_states "
            "(ref_txhash, ref_index, state_type, currency, amount, blob, "
            "crc) VALUES (?, ?, ?, ?, ?, ?, ?)",
            (*key, self._type_name(type(sar.state.data)), currency, amount,
             blob, _row_crc(key[0], key[1], blob)))
        if conn.total_changes == before:
            return False
        for participant in sar.state.data.participants:
            for leaf in _participant_leaves(participant):
                conn.execute(
                    "INSERT OR IGNORE INTO vault_participants "
                    "(participant, ref_txhash, ref_index) VALUES (?, ?, ?)",
                    (leaf, *key))
        if currency is not None:
            conn.execute(
                "INSERT INTO vault_balances (currency, quantity) "
                "VALUES (?, ?) ON CONFLICT(currency) "
                "DO UPDATE SET quantity = quantity + excluded.quantity",
                (currency, amount))
        return True

    def _drop_row(self, ref_txhash: bytes, ref_index: int) -> bool:
        """DELETE one state row (+ shadows); False when absent."""
        conn = self._db.conn
        row = conn.execute(
            "SELECT currency, amount FROM vault_states "
            "WHERE ref_txhash = ? AND ref_index = ?",
            (ref_txhash, ref_index)).fetchone()
        if row is None:
            return False
        currency, amount = row
        conn.execute(
            "DELETE FROM vault_states WHERE ref_txhash = ? AND "
            "ref_index = ?", (ref_txhash, ref_index))
        conn.execute(
            "DELETE FROM vault_participants WHERE ref_txhash = ? AND "
            "ref_index = ?", (ref_txhash, ref_index))
        if currency is not None:
            conn.execute(
                "UPDATE vault_balances SET quantity = quantity - ? "
                "WHERE currency = ?", (amount, currency))
        return True

    @staticmethod
    def _type_name(cls: type) -> str:
        return wire_name_of(cls) or f"{cls.__module__}.{cls.__qualname__}"

    # -- the VaultService contract --------------------------------------

    @property
    def current_vault(self) -> Vault:
        """Full materialized snapshot — kept for the compat surface
        (RPC vault_snapshot, small tests); production paths use query()/
        iter_unconsumed() so a million-state vault is never copied."""
        return Vault(tuple(self.iter_unconsumed()))

    def iter_unconsumed(self, of_type: type | None = None,
                        batch: int = 512):
        """Bounded-memory iteration: keyset-paginated pages under the
        hood, one page of StateAndRefs in memory at a time."""
        cursor = None
        while True:
            page = self.query(VaultQuery(state_type=of_type, after=cursor,
                                         page_size=batch))
            yield from page.states
            cursor = page.next_cursor
            if cursor is None:
                return

    def unconsumed_states(self, of_type: type | None = None) -> list:
        """Compatibility shim over the paginated query API."""
        return list(self.iter_unconsumed(of_type))

    def notify_all(self, txns: Iterable) -> Vault:
        """Fold observed transactions into the vault. Same relevancy /
        update semantics as the in-memory engine; the whole call rides
        one transaction scope (the node thread's round batch when open),
        and the watermark advances with it."""
        with self._db.lock:
            max_rowid = 0
            for stx in txns:
                wtx = stx.tx if hasattr(stx, "tx") else stx
                consumed = []
                for ref in wtx.inputs:
                    sar = self._load(ref)
                    if sar is not None:
                        consumed.append(sar)
                produced = [
                    wtx.out_ref(i)
                    for i, out in enumerate(wtx.outputs)
                    if self._is_relevant(out)
                ]
                tx_id = getattr(stx, "id", None)
                if tx_id is not None:
                    row = self._db.conn.execute(
                        "SELECT rowid FROM transactions WHERE tx_id = ?",
                        (tx_id.bytes,)).fetchone()
                    if row is not None:
                        max_rowid = max(max_rowid, int(row[0]))
                update = Vault.Update(consumed=frozenset(consumed),
                                      produced=frozenset(produced))
                if update.is_empty:
                    continue
                for sar in consumed:
                    self._drop_row(sar.ref.txhash.bytes, sar.ref.index)
                fresh = []
                for sar in produced:
                    if self._insert_sar(sar):
                        fresh.append(sar)
                # A replayed tx whose rows were all already folded in
                # must not re-fire observers (the in-memory engine can't
                # see a replay; here idempotent replay is the contract).
                if not consumed and not fresh:
                    continue
                self.softlocks.release([sar.ref for sar in consumed])
                for obs in list(self._observers):
                    obs(update)
            if max_rowid:
                current = int(self._db.get_setting(WATERMARK_KEY) or 0)
                if max_rowid > current:
                    self._db.conn.execute(
                        "INSERT OR REPLACE INTO settings (key, value) "
                        "VALUES (?, ?)", (WATERMARK_KEY, str(max_rowid)))
            self._db.commit()
        return Vault(())

    def _load(self, ref: StateRef) -> StateAndRef | None:
        row = self._db.conn.execute(
            "SELECT blob, crc FROM vault_states WHERE ref_txhash = ? AND "
            "ref_index = ?", (ref.txhash.bytes, ref.index)).fetchone()
        if row is None:
            return None
        return self._decode_row(ref.txhash.bytes, ref.index, row[0], row[1])

    def subscribe(self, observer: Callable[[Vault.Update], None]) -> None:
        self._observers.append(observer)

    # -- incremental boot -----------------------------------------------

    @property
    def watermark(self) -> int:
        return int(self._db.get_setting(WATERMARK_KEY) or 0)

    def rebuild_from(self, storage, batch: int = 512) -> int:
        """Fold in the transactions the vault has not seen yet — the
        delta above the persisted watermark, streamed in bounded batches
        (never the full ledger in memory). Returns how many transactions
        were replayed. Crash-safe: each batch commits its vault rows and
        watermark atomically; a crash mid-rebuild resumes from the last
        durable watermark and replays idempotently."""
        replayed = 0
        chunk: list = []
        for _rowid, stx in storage.stream_since(self.watermark,
                                                batch=batch):
            chunk.append(stx)
            if len(chunk) >= batch:
                self.notify_all(chunk)
                replayed += len(chunk)
                chunk = []
        if chunk:
            self.notify_all(chunk)
            replayed += len(chunk)
        return replayed

    # -- queries ----------------------------------------------------------

    def _type_pushdown(self, of_type: type) \
            -> tuple[list[str], bool]:
        """(wire names to match, need_isinstance_guard). The guard stays
        on whenever some stored type name cannot be resolved to a class
        (states written by a process whose codec registered more types
        than ours) — those rows are included and filtered post-decode
        rather than silently dropped."""
        rows = self._db.conn.execute(
            "SELECT DISTINCT state_type FROM vault_states").fetchall()
        names: list[str] = []
        guard = False
        for (name,) in rows:
            cls = class_for_wire_name(name)
            if cls is None:
                names.append(name)
                guard = True
            elif issubclass(cls, of_type):
                names.append(name)
        return names, guard

    def query(self, q: VaultQuery) -> VaultPage:
        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        _tm.inc("vault_queries_total")
        wheres, params = [], []
        guard = False
        if q.state_type is not None:
            names, guard = self._type_pushdown(q.state_type)
            if not names:
                return VaultPage((), None)
            wheres.append(
                f"state_type IN ({','.join('?' * len(names))})")
            params.extend(names)
        if q.currency is not None:
            wheres.append("currency = ?")
            params.append(q.currency)
        if q.min_amount is not None:
            wheres.append("amount >= ?")
            params.append(int(q.min_amount))
        if q.max_amount is not None:
            wheres.append("amount <= ?")
            params.append(int(q.max_amount))
        if q.participant is not None:
            leaves = _participant_leaves(q.participant)
            if not leaves:
                return VaultPage((), None)
            wheres.append(
                "EXISTS (SELECT 1 FROM vault_participants p WHERE "
                "p.ref_txhash = vault_states.ref_txhash AND "
                "p.ref_index = vault_states.ref_index AND "
                f"p.participant IN ({','.join('?' * len(leaves))}))")
            params.extend(leaves)
        if q.after is not None:
            wheres.append("(ref_txhash, ref_index) > (?, ?)")
            params.extend((bytes(q.after[0]), int(q.after[1])))
        sql = ("SELECT ref_txhash, ref_index, blob, crc FROM vault_states"
               + (" WHERE " + " AND ".join(wheres) if wheres else "")
               + " ORDER BY ref_txhash, ref_index LIMIT ?")
        page = max(1, int(q.page_size))
        params.append(page + 1)
        with self._db.lock:
            rows = self._db.conn.execute(sql, params).fetchall()
        more = len(rows) > page
        rows = rows[:page]
        states = []
        for ref_txhash, ref_index, blob, crc in rows:
            sar = self._decode_row(ref_txhash, ref_index, blob, crc)
            if sar is None:
                continue
            if guard and q.state_type is not None \
                    and not isinstance(sar.state.data, q.state_type):
                continue
            states.append(sar)
        next_cursor = None
        if more and rows:
            last = rows[-1]
            next_cursor = (bytes(last[0]), int(last[1]))
        record_vault_stage(t0, attrs={"rows": len(states), "op": "query"})
        return VaultPage(tuple(states), next_cursor)

    def select_coins(self, currency: str, quantity: int,
                     holder: bytes = b"", ttl_s: float | None = None) \
            -> list[StateAndRef]:
        """Indexed coin selection: walk the (currency, amount DESC)
        covering index, skip refs soft-locked by other holders, reserve
        and return coins until ``quantity`` is covered. Insufficient
        funds release this call's reservations and return the partial
        set (the asset's generate_spend raises the same
        InsufficientBalanceException it always has)."""
        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        _tm.inc("vault_queries_total")
        expired = self.softlocks.sweep()
        if expired:
            _tm.inc("vault_softlock_expired_total", expired)
        holder = bytes(holder) or b"anon"
        gathered: list[StateAndRef] = []
        covered = 0
        with self._db.lock:
            cur = self._db.conn.execute(
                "SELECT ref_txhash, ref_index, amount, blob, crc "
                "FROM vault_states WHERE currency = ? "
                "ORDER BY amount DESC, ref_txhash, ref_index", (currency,))
            for ref_txhash, ref_index, amount, blob, crc in cur:
                ref = StateRef(SecureHash(bytes(ref_txhash)),
                               int(ref_index))
                if not self.softlocks.try_lock(ref, holder, ttl_s):
                    _tm.inc("vault_selection_conflicts_total")
                    continue
                sar = self._decode_row(ref_txhash, ref_index, blob, crc)
                if sar is None:
                    self.softlocks.release([ref], holder)
                    continue
                gathered.append(sar)
                covered += int(amount or 0)
                if covered >= quantity:
                    break
        if covered < quantity:
            # Don't shadow coins behind a selection that cannot spend.
            self.softlocks.release([sar.ref for sar in gathered], holder)
        record_vault_stage(t0, attrs={"rows": len(gathered), "op": "select"})
        return gathered

    def release_coins(self, refs: Iterable[StateRef],
                      holder: bytes = b"") -> None:
        self.softlocks.release(refs, bytes(holder) or b"anon")

    def balances(self) -> dict[str, int]:
        """Per-currency unconsumed quantities — one indexed aggregate
        read, O(#currencies), never a vault scan."""
        with self._db.lock:
            rows = self._db.conn.execute(
                "SELECT currency, quantity FROM vault_balances "
                "WHERE quantity != 0").fetchall()
        return {str(c): int(q) for c, q in rows}

    def __len__(self) -> int:
        (n,) = self._db.conn.execute(
            "SELECT COUNT(*) FROM vault_states").fetchone()
        return int(n)


def seed_states(vault: IndexedVaultService, states: Iterable[StateAndRef],
                chunk: int = 4096) -> int:
    """Bulk-load pre-built unconsumed states (bench / loadtest seeding —
    the 'bank day' pre-seed path). Rides the same idempotent insert as
    notify_all (balances and participants maintained per real insert)
    but skips update construction and observer fan-out; commits per
    chunk so a million-state seed never holds one giant transaction."""
    inserted = 0
    pending = 0
    with vault._db.lock:
        for sar in states:
            if vault._insert_sar(sar):
                inserted += 1
            pending += 1
            if pending >= chunk:
                vault._db.commit()
                pending = 0
        vault._db.commit()
    return inserted
