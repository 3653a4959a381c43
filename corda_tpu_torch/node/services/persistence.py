"""Durable (sqlite) service implementations — the node's persistence tier.

Capability match for the reference's DB-backed stores (reference:
node/src/main/kotlin/net/corda/node/services/persistence/DBCheckpointStorage.kt:17-57,
DBTransactionStorage.kt, node/.../transactions/PersistentUniquenessProvider.kt:19-82,
node/.../utilities/JDBCHashMap.kt) re-based on sqlite: one file per node, WAL
mode, every mutation committed before the call returns, so a node process can
be killed at any point and a fresh process over the same file resumes — the
crash-recovery contract the checkpoint/replay suite exercises.

Values are stored as canonical-codec blobs (corda_tpu_torch/serialization/codec.py),
the same format used for wire messages and Merkle leaves; the codec whitelist
applies to whatever is read back from disk.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Callable, Sequence

from ...crypto.hashes import SecureHash
from ...crypto.keys import KeyPair
from ...crypto.party import Party
from ...obs import trace as _obs
from ...serialization.codec import deserialize, serialize
from ...testing import faults as _faults
from ..statemachine import CheckpointStorage
from . import integrity as _integrity
from .api import (
    AttachmentStorage,
    ConsumingTx,
    StateMachineTransactionMapping,
    TransactionMappingStorage,
    TransactionStorage,
    UniquenessConflict,
    UniquenessException,
    UniquenessProvider,
)


def _sqlite_serialized() -> bool:
    """Is the sqlite C library in serialized mode (safe to share one
    connection across threads)? DB-API threadsafety 3 says yes directly;
    Python < 3.11 hardcodes the module attribute at 1 regardless of how
    the library was compiled, so fall back to asking the library itself
    (SQLITE_THREADSAFE=1 is serialized mode)."""
    if sqlite3.threadsafety == 3:
        return True
    conn = sqlite3.connect(":memory:")
    try:
        return conn.execute(
            "SELECT 1 FROM pragma_compile_options"
            " WHERE compile_options = 'THREADSAFE=1'").fetchone() is not None
    finally:
        conn.close()


class NodeDatabase:
    """One sqlite file holding every durable table of a node.

    The reference wires all stores through one H2 database per node
    (AbstractNode.kt:191, initialiseDatabasePersistence); the sqlite twin
    keeps that single-file property so "copy the file" == "copy the node".
    """

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS checkpoints (
        run_id BLOB PRIMARY KEY,
        blob   BLOB NOT NULL
    );
    CREATE TABLE IF NOT EXISTS transactions (
        tx_id BLOB PRIMARY KEY,
        blob  BLOB NOT NULL
    );
    CREATE TABLE IF NOT EXISTS tx_mappings (
        run_id BLOB NOT NULL,
        tx_id  BLOB NOT NULL,
        PRIMARY KEY (run_id, tx_id)
    );
    CREATE TABLE IF NOT EXISTS attachments (
        att_id BLOB PRIMARY KEY,
        data   BLOB NOT NULL
    );
    CREATE TABLE IF NOT EXISTS committed_states (
        state_ref   BLOB PRIMARY KEY,
        consuming   BLOB NOT NULL
    );
    CREATE TABLE IF NOT EXISTS node_identity (
        singleton INTEGER PRIMARY KEY CHECK (singleton = 1),
        name      TEXT NOT NULL,
        seed      BLOB NOT NULL
    );
    CREATE TABLE IF NOT EXISTS dedupe (
        message_id BLOB PRIMARY KEY
    );
    CREATE TABLE IF NOT EXISTS settings (
        key   TEXT PRIMARY KEY,
        value TEXT NOT NULL
    );
    CREATE TABLE IF NOT EXISTS outbox (
        seq        INTEGER PRIMARY KEY AUTOINCREMENT,
        peer       TEXT NOT NULL,
        unique_id  BLOB NOT NULL,
        blob       BLOB NOT NULL
    );
    CREATE INDEX IF NOT EXISTS outbox_peer ON outbox (peer, seq);
    """

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        # Shared across the node thread and the transport's bridge threads:
        # the sqlite C library serializes statement execution (serialized
        # mode asserted below); `lock` additionally scopes multi-statement
        # transactions (e.g. the uniqueness commit) to one thread at a time.
        assert _sqlite_serialized(), "need a serialized (threadsafe) sqlite"
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self.lock = threading.RLock()
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(self._SCHEMA)
        # Durability plane: add the nullable crc column to integrity-framed
        # tables (in-place upgrade — legacy rows keep crc NULL until the
        # scrubber backfills) and create the quarantine table.
        _integrity.ensure_integrity_schema(self._conn)
        self._conn.commit()
        self._batch_depth = 0  # node-thread round batching (see batch())
        self._batch_thread: int | None = None  # owning thread id
        self._batch_failed = False
        self._aux_conn: sqlite3.Connection | None = None
        self.aux_lock = threading.Lock()

    @property
    def conn(self) -> sqlite3.Connection:
        return self._conn

    @property
    def aux_conn(self) -> sqlite3.Connection:
        """A SECOND connection for transport bridge threads. While the node
        thread holds a round transaction open on `conn` (batch()), a bridge
        thread committing on the same connection would flush the half-built
        round; the aux connection gives bridges their own transaction scope
        (WAL handles the concurrency; busy_timeout rides out round commits).
        Reads on this connection see only COMMITTED rows — an outbox frame
        becomes sendable only once the round that produced it is durable."""
        if self._aux_conn is None:
            aux = sqlite3.connect(self.path, check_same_thread=False)
            aux.execute("PRAGMA busy_timeout=5000")
            self._aux_conn = aux
        return self._aux_conn

    @property
    def in_batch(self) -> bool:
        return (self._batch_depth > 0
                and self._batch_thread == threading.get_ident())

    def commit(self) -> None:
        """Commit now — unless the CALLING thread holds an open round batch,
        in which case the write becomes durable atomically with the whole
        round at batch() exit. Other threads (webserver uploads) keep the
        commit-before-return guarantee: batch() holds db.lock for the round,
        so a foreign thread's write+commit (done under db.lock) can never
        interleave into a half-built round transaction."""
        if self.in_batch:
            return
        self._conn.commit()

    def batch(self):
        """Context manager: coalesce every store mutation issued on the node
        thread into ONE sqlite transaction (one fsync instead of one per
        checkpoint/outbox/dedupe write). The crash contract strengthens:
        a round's checkpoint updates, outbound frames and dedupe records
        commit atomically, and inbound ACKs are sent only after that commit
        (TcpMessaging.flush_round), so a crash anywhere inside a round
        redelivers cleanly. A round that RAISES rolls back as a unit —
        committing a half-round would make dedupe records durable without
        the checkpoints they belong with. Holds db.lock for the round
        (re-entrant on the node thread); re-entrant."""
        import contextlib

        @contextlib.contextmanager
        def _batch():
            # lint: allow(no-blocking-under-lock) db.lock IS the single-writer I/O serialization lock — holding it across the round's commit/rollback is the design (one fsync per round)
            with self.lock:
                if self._batch_depth == 0:
                    self._batch_thread = threading.get_ident()
                    self._batch_failed = False
                self._batch_depth += 1
                try:
                    yield self
                except BaseException:
                    self._batch_failed = True
                    raise
                finally:
                    self._batch_depth -= 1
                    if self._batch_depth == 0:
                        self._batch_thread = None
                        try:
                            if self._batch_failed:
                                self._conn.rollback()
                            else:
                                self._conn.commit()
                        except sqlite3.ProgrammingError:
                            # close() raced the round (node.stop() from
                            # another thread): equivalent to a crash mid-
                            # round — the recovery contract (replay +
                            # redelivery) covers it.
                            pass

        return _batch()

    def close(self) -> None:
        # The aux connection is shared with bridge threads (outbox replay /
        # ack). Closing a sqlite connection while another thread is inside
        # an execute on it is a C-level crash, not an exception — so take
        # the same aux_lock every aux user holds; after close they get a
        # python-level ProgrammingError, which the bridge loop treats as
        # node shutdown.
        if self._aux_conn is not None:
            with self.aux_lock:
                self._aux_conn.close()
        self._conn.close()

    def get_setting(self, key: str) -> str | None:
        row = self._conn.execute(
            "SELECT value FROM settings WHERE key = ?", (key,)).fetchone()
        return None if row is None else row[0]

    def set_setting(self, key: str, value: str) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO settings (key, value) VALUES (?, ?)",
            (key, value))
        self.commit()

    # -- node identity (reference: AbstractNode.kt:494-527 keypair on disk) --

    def load_or_create_identity(self, name: str,
                                seed: bytes | None = None) -> KeyPair:
        row = self._conn.execute(
            "SELECT name, seed FROM node_identity WHERE singleton = 1"
        ).fetchone()
        if row is not None:
            stored_name, stored_seed = row
            if stored_name != name:
                raise ValueError(
                    f"database belongs to node {stored_name!r}, not {name!r}")
            return KeyPair.generate(bytes(stored_seed))
        seed = seed if seed is not None else os.urandom(32)
        self._conn.execute(
            "INSERT INTO node_identity (singleton, name, seed) VALUES (1, ?, ?)",
            (name, seed))
        self._conn.commit()
        return KeyPair.generate(seed)


class DBCheckpointStorage(CheckpointStorage):
    """Checkpoint blobs keyed by run id (reference: DBCheckpointStorage.kt:17-57).
    Every update commits before returning — kill-safe at any step."""

    def __init__(self, db: NodeDatabase):
        self._db = db

    def update_checkpoint(self, run_id: bytes, blob: bytes) -> None:
        self._db.conn.execute(
            "INSERT OR REPLACE INTO checkpoints (run_id, blob, crc) "
            "VALUES (?, ?, ?)",
            (run_id, blob,
             _integrity.checkpoint_crc(bytes(run_id).hex(), blob)))
        self._db.commit()

    def remove_checkpoint(self, run_id: bytes) -> None:
        self._db.conn.execute(
            "DELETE FROM checkpoints WHERE run_id = ?", (run_id,))
        self._db.commit()

    def checkpoints(self) -> list[bytes]:
        return [blob for _rid, blob in self.items()]

    def items(self) -> list[tuple[bytes, bytes]]:
        """(run_id, blob) pairs, checksum-verified: a corrupt row is
        quarantined HERE — before it can poison the SMM replay loop — and
        its flow restores as failed-by-absence (the run id is simply not
        in the returned set). Legacy rows (crc NULL) pass through
        unverified until the scrubber backfills them."""
        with self._db.lock:
            rows = self._db.conn.execute(
                "SELECT run_id, blob, crc FROM checkpoints ORDER BY run_id"
            ).fetchall()
        out = []
        for run_id, blob, crc in rows:
            run_id, blob = bytes(run_id), bytes(blob)
            if _faults.ACTIVE is not None:
                blob = _faults.fire_disk_corrupt(blob)
            if crc is not None and _integrity.checkpoint_crc(
                    run_id.hex(), blob) != int(crc):
                self.quarantine(run_id, blob, "checkpoint crc mismatch")
                continue
            out.append((run_id, blob))
        return out

    def quarantine(self, run_id: bytes, blob: bytes, reason: str) -> None:
        """Move one corrupt/undecodable checkpoint into the quarantine
        table (counted, never silently dropped) so restore can proceed
        without it."""
        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        with self._db.lock:
            _integrity.quarantine_row(
                self._db.conn, "checkpoint", bytes(run_id), blob, reason)
            self._db.conn.execute(
                "DELETE FROM checkpoints WHERE run_id = ?", (bytes(run_id),))
            self._db.commit()
        _integrity.bump("checkpoints_quarantined")
        if _obs.ACTIVE is not None:
            _obs.record("repair", t0, _obs.now(),
                        attrs={"kind": "checkpoint", "reason": reason})

    def __len__(self):
        (n,) = self._db.conn.execute(
            "SELECT COUNT(*) FROM checkpoints").fetchone()
        return n


class DBTransactionStorage(TransactionStorage):
    """Validated-transaction map (reference: DBTransactionStorage.kt) with the
    same observer stream as the in-memory twin."""

    def __init__(self, db: NodeDatabase):
        self._db = db
        self._observers: list[Callable] = []

    def add_transaction(self, stx) -> None:
        cur = self._db.conn.execute(
            "INSERT OR IGNORE INTO transactions (tx_id, blob) VALUES (?, ?)",
            (stx.id.bytes, serialize(stx).bytes))
        self._db.commit()
        if cur.rowcount:
            for obs in list(self._observers):
                obs(stx)

    def get_transaction(self, id: SecureHash):
        row = self._db.conn.execute(
            "SELECT blob FROM transactions WHERE tx_id = ?", (id.bytes,)
        ).fetchone()
        return None if row is None else deserialize(bytes(row[0]))

    def all_transactions(self):
        """Every stored transaction in insertion order (vault rebuild after
        a restart replays these through notify_all)."""
        rows = self._db.conn.execute(
            "SELECT blob FROM transactions ORDER BY rowid").fetchall()
        return [deserialize(bytes(r[0])) for r in rows]

    def stream_since(self, after_rowid: int = 0, batch: int = 512):
        """Yield (rowid, stx) for transactions stored after ``after_rowid``,
        fetched in bounded keyset pages — the vault-rebuild path that never
        materializes the ledger (a million-tx history streams through
        ``batch`` rows of memory at a time)."""
        cursor = int(after_rowid)
        while True:
            rows = self._db.conn.execute(
                "SELECT rowid, blob FROM transactions WHERE rowid > ? "
                "ORDER BY rowid LIMIT ?", (cursor, int(batch))).fetchall()
            if not rows:
                return
            for rowid, blob in rows:
                yield int(rowid), deserialize(bytes(blob))
            cursor = int(rows[-1][0])

    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)

    def __len__(self):
        (n,) = self._db.conn.execute(
            "SELECT COUNT(*) FROM transactions").fetchone()
        return n


class DBTransactionMappingStorage(TransactionMappingStorage):
    """Durable flow-run → tx provenance log (reference:
    node/.../persistence per-node DB tier of StateMachineRecordedTransaction
    MappingStorage.kt). Writes ride the node thread's round batch like every
    other store mutation; (run_id, tx_id) is the primary key, so checkpoint
    replay re-records are no-ops and observers fire once per fresh row."""

    def __init__(self, db: NodeDatabase):
        self._db = db
        self._observers: list[Callable] = []

    def add_mapping(self, run_id: bytes, tx_id: SecureHash) -> None:
        cur = self._db.conn.execute(
            "INSERT OR IGNORE INTO tx_mappings (run_id, tx_id) VALUES (?, ?)",
            (bytes(run_id), tx_id.bytes))
        self._db.commit()
        if cur.rowcount:
            mapping = StateMachineTransactionMapping(bytes(run_id), tx_id)
            for obs in list(self._observers):
                obs(mapping)

    def mappings(self) -> list[StateMachineTransactionMapping]:
        rows = self._db.conn.execute(
            "SELECT run_id, tx_id FROM tx_mappings ORDER BY rowid").fetchall()
        return [StateMachineTransactionMapping(
            bytes(r), SecureHash(bytes(t))) for r, t in rows]

    def subscribe(self, observer: Callable) -> None:
        self._observers.append(observer)

    def __len__(self):
        (n,) = self._db.conn.execute(
            "SELECT COUNT(*) FROM tx_mappings").fetchone()
        return n


class _DBAttachment:
    def __init__(self, id: SecureHash, data: bytes):
        self.id = id
        self.data = data

    def open(self) -> bytes:
        return self.data


class DBAttachmentStorage(AttachmentStorage):
    """Content-addressed blobs (reference: NodeAttachmentService.kt — files on
    disk there; one table here, same id = sha256(content) contract)."""

    def __init__(self, db: NodeDatabase):
        self._db = db

    def import_attachment(self, data: bytes) -> SecureHash:
        att_id = SecureHash.sha256(data)
        # db.lock: this is reachable from the webserver's HTTP thread; the
        # lock (held by the node thread for each round transaction) keeps a
        # foreign thread's insert+commit from interleaving into a half-built
        # round, and commit() below is immediate for non-round threads.
        with self._db.lock:
            self._db.conn.execute(
                "INSERT OR IGNORE INTO attachments (att_id, data) VALUES (?, ?)",
                (att_id.bytes, data))
            self._db.commit()
        return att_id

    def open_attachment(self, id: SecureHash):
        row = self._db.conn.execute(
            "SELECT data FROM attachments WHERE att_id = ?", (id.bytes,)
        ).fetchone()
        return None if row is None else _DBAttachment(id, bytes(row[0]))


class PersistentUniquenessProvider(UniquenessProvider):
    """Durable first-committer-wins commit log (reference:
    PersistentUniquenessProvider.kt:19-82). The whole commit is one sqlite
    transaction: either every input is claimed or none is."""

    def __init__(self, db: NodeDatabase):
        self._db = db

    def commit(self, states: Sequence, tx_id: SecureHash,
               caller_identity: Party) -> None:
        if _faults.ACTIVE is not None:
            _faults.fire_disk_full()  # disk.full: sheds at the notarise path
        with self._db.lock:  # check-then-insert must be atomic vs other threads
            conn = self._db.conn
            conflicts = {}
            for ref in states:
                row = conn.execute(
                    "SELECT consuming FROM committed_states WHERE state_ref = ?",
                    (serialize(ref).bytes,)).fetchone()
                if row is not None:
                    consuming = deserialize(bytes(row[0]))
                    if consuming.id != tx_id:
                        conflicts[ref] = consuming
            if conflicts:
                raise UniquenessException(UniquenessConflict(dict(conflicts)))
            inserted: list[bytes] = []
            try:
                for i, ref in enumerate(states):
                    ref_blob = serialize(ref).bytes
                    consuming_blob = serialize(
                        ConsumingTx(tx_id, i, caller_identity)).bytes
                    before = conn.total_changes
                    conn.execute(
                        "INSERT OR IGNORE INTO committed_states "
                        "(state_ref, consuming, crc) VALUES (?, ?, ?)",
                        (ref_blob, consuming_blob,
                         _integrity.committed_crc(ref_blob, consuming_blob)))
                    if conn.total_changes > before:
                        inserted.append(ref_blob)
                self._db.commit()
            except sqlite3.OperationalError:
                # Disk exhausted mid-claim: the all-or-nothing contract
                # must hold even inside a round batch (where rollback would
                # discard unrelated writes) — compensate by deleting only
                # the rows THIS call inserted, then let the caller shed.
                for ref_blob in inserted:
                    conn.execute(
                        "DELETE FROM committed_states WHERE state_ref = ?",
                        (ref_blob,))
                raise

    @property
    def committed_count(self) -> int:
        (n,) = self._db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        return n
