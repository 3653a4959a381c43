"""Durability plane: per-record CRC32C framing, online scrub, quarantine.

The crash-recovery contract (persistence.py docstring) assumes the bytes
sqlite returns are the bytes it stored.  For a uniqueness-consensus
service that assumption is the whole ballgame: a silently bit-flipped
committed-states row is a double-spend, a flipped raft entry is a
diverged replica — strictly worse than any outage the chaos plans can
produce.  This module is the single source of truth for the integrity
frame every durable table carries:

  table             crc covers
  ----------------  --------------------------------------------------
  raft_log          idx ‖ term ‖ blob        (``log_crc``)
  checkpoints       run_id ‖ blob            (``checkpoint_crc``)
  committed_states  state_ref ‖ consuming    (``committed_crc``)
  reserved_states   state_ref ‖ tx_id ‖ f64(expires_at) (``reserved_crc``)

The checksum rides a separate nullable ``crc`` column so every stored
blob stays byte-identical to the pre-durability format — the follower
append path inserts the leader's wire blob verbatim and the blob-mirror
equality the commit pipeline leans on survives unchanged.  ``crc IS
NULL`` marks a legacy row: existing databases upgrade in place via
:func:`ensure_integrity_schema` (pragma-checked ``ALTER TABLE``) and the
scrubber/fsck backfill checksums opportunistically.

Detection has three tiers, cheapest first:

  * inline — the raft replication/apply read paths and the checkpoint
    restore path verify rows they were about to trust anyway;
  * online — :class:`Scrubber`, a low-priority thread walking every
    table at a bounded row rate on its own sqlite connection;
  * boot — ``python -m corda_tpu_torch.tools.fsck`` (tools/fsck.py), the
    offline scan/repair built from the same helpers.

Repair routes corrupt *replaceable* state (checkpoints) into the
``quarantine`` table — never silently dropped, never allowed to poison
the SMM replay loop — and turns corrupt *replicated* state into a
lagging follower (raft.py ``_heal_corrupt_entry``).  Ledger rows
(committed/reserved) are irreplaceable locally: corruption there is
counted and surfaced, repair is a peer resync (InstallSnapshot), never a
local delete.

Everything here is stdlib-only and import-light: faults/bench/fsck load
it from bare CLI processes.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Any

__all__ = [
    "crc32c",
    "log_crc",
    "checkpoint_crc",
    "committed_crc",
    "committed_crc_many",
    "reserved_crc",
    "is_disk_full",
    "ensure_integrity_schema",
    "quarantine_row",
    "COUNTERS",
    "bump",
    "stats",
    "Scrubber",
    "INTEGRITY_TABLES",
]

# -- CRC32C (Castagnoli) ------------------------------------------------------
#
# zlib.crc32 is CRC32/IEEE; the Castagnoli polynomial (0x1EDC6F41) is the
# storage-stack standard (iSCSI, ext4, Btrfs) with strictly better error
# detection for short records.  Not in the stdlib, so the native core
# (native/_ccommit.c, a slicing-by-8 table loop) computes it: a few us for
# a 16 KB checkpoint row.  The pure-Python byte-at-a-time loop below is the
# fallback for a host that cannot build the core, at ~0.25 us a byte: ~5 ms
# for that row, more than the sqlite commit it rides next to.

_CRC32C_POLY = 0x82F63B78  # reflected 0x1EDC6F41


def _make_table() -> tuple:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_TABLE = _make_table()

# Native core (native/_ccommit.c), loaded lazily on first use:
# None = not yet tried, False = unavailable (no compiler, failed build).
_ccommit = None


def _load_ccommit():
    global _ccommit
    if _ccommit is None:
        try:
            from ...native import load_ccommit

            _ccommit = load_ccommit() or False
        except Exception:
            _ccommit = False
    return _ccommit


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of *data* (optionally continuing a running checksum)."""
    native = _load_ccommit()
    if native is not False:
        try:
            return native.crc32c(data, crc)
        except (TypeError, BufferError):
            pass  # not a contiguous buffer: the loop below takes it or raises
    c = crc ^ 0xFFFFFFFF
    table = _TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    bump("crc_bytes_python", len(data))
    return c ^ 0xFFFFFFFF


def log_crc(idx: int, term: int, blob: bytes) -> int:
    """Raft-log row checksum: covers position AND payload, so a row copied
    to the wrong index (torn page, bad sector remap) fails just like a
    flipped payload bit."""
    return crc32c(blob, crc32c(struct.pack("<qq", idx, term)))


def checkpoint_crc(run_id: str, blob: bytes) -> int:
    return crc32c(blob, crc32c(run_id.encode("utf-8")))


def committed_crc(state_ref: bytes, consuming: bytes) -> int:
    return crc32c(consuming, crc32c(state_ref))


def committed_crc_many(pairs) -> list:
    """``[committed_crc(ref, consuming), ...]`` for a whole columnar
    commit batch in one native call, the GIL released across the batch
    (so the consensus thread keeps pumping its sockets); pair by pair
    through :func:`crc32c` when the core is unavailable."""
    native = _load_ccommit()
    if native is not False and pairs:
        try:
            return native.committed_crc_many(
                pairs if isinstance(pairs, list) else list(pairs))
        # lint: allow(no-silent-except) malformed batch falls through to the Python loop, which raises the real per-pair error instead of an opaque native one
        except Exception:
            pass
    return [committed_crc(ref, con) for ref, con in pairs]


def reserved_crc(state_ref: bytes, tx_id: bytes, expires_at: float) -> int:
    return crc32c(struct.pack("<d", expires_at),
                  crc32c(tx_id, crc32c(state_ref)))


def is_disk_full(exc: BaseException) -> bool:
    """True for sqlite's disk-exhaustion OperationalError (and the
    injected ``disk.full`` fault, which raises the same message)."""
    msg = str(exc).lower()
    return "disk is full" in msg or "disk full" in msg


# -- schema upgrade -----------------------------------------------------------

# table -> key column (for quarantine/backfill row addressing).
INTEGRITY_TABLES = {
    "raft_log": "idx",
    "checkpoints": "run_id",
    "committed_states": "state_ref",
    "reserved_states": "state_ref",
}

_QUARANTINE_SCHEMA = """
CREATE TABLE IF NOT EXISTS quarantine (
    qid            INTEGER PRIMARY KEY AUTOINCREMENT,
    kind           TEXT NOT NULL,
    key            BLOB,
    blob           BLOB,
    reason         TEXT,
    quarantined_at REAL
);
"""


def ensure_integrity_schema(conn) -> None:
    """Idempotent in-place upgrade: add the nullable ``crc`` column to
    every integrity-framed table that exists and lacks it (sqlite has no
    ADD COLUMN IF NOT EXISTS), and create the quarantine table.  Rows
    predating the upgrade keep ``crc IS NULL`` — the legacy marker the
    scrubber backfills — so a pre-durability database opens cleanly."""
    for table in INTEGRITY_TABLES:
        cols = [r[1] for r in conn.execute(
            f"PRAGMA table_info({table})").fetchall()]
        if cols and "crc" not in cols:
            conn.execute(f"ALTER TABLE {table} ADD COLUMN crc INTEGER")
    conn.executescript(_QUARANTINE_SCHEMA)


def quarantine_row(conn, kind: str, key, blob, reason: str) -> None:
    """Move one corrupt row's payload into the quarantine table (caller
    deletes the source row in the same transaction and commits)."""
    conn.execute(
        "INSERT INTO quarantine (kind, key, blob, reason, quarantined_at) "
        "VALUES (?, ?, ?, ?, ?)",
        (kind, key if isinstance(key, (bytes, type(None))) else str(key),
         blob, reason, time.time()))


# -- process-wide counters ----------------------------------------------------
#
# Same idiom as faults.ACTIVE: detection sites that have no natural home
# object (checkpoint storage, notary shed path) count here; node_metrics
# exports a snapshot under the "durability" key.  Raft members keep their
# own per-member counters in RaftMember.metrics (they ride the stamp).

COUNTERS: dict[str, int] = {
    "checkpoints_quarantined": 0,
    "disk_full_sheds": 0,
    # Bytes the Python CRC32C loop checksummed: 0 wherever the native core
    # loads.  Its native twin, crc_bytes_native, is counted by the core.
    "crc_bytes_python": 0,
}
_COUNTER_LOCK = threading.Lock()


def bump(key: str, n: int = 1) -> None:
    with _COUNTER_LOCK:
        COUNTERS[key] = COUNTERS.get(key, 0) + n


def stats(scrubber: "Scrubber | None" = None) -> dict:
    """node_metrics "durability" snapshot: process counters plus the
    node's scrubber counters when one is running (plain JSON types)."""
    with _COUNTER_LOCK:
        out: dict[str, Any] = dict(COUNTERS)
    out["crc_bytes_native"] = (_ccommit.bytes_checksummed()
                               if _ccommit else 0)
    if scrubber is not None:
        out.update(scrubber.stats())
    return out


# -- row verification (shared by scrubber and fsck) ---------------------------


def _row_crc(table: str, row) -> int:
    """Recompute the checksum for one (key..., crc) row of *table* as
    selected by :data:`_SCAN_SQL`."""
    if table == "raft_log":
        return log_crc(int(row[0]), int(row[1]), bytes(row[2]))
    if table == "checkpoints":
        # run_id is a bytes key; the checksum binds its hex form (the
        # same normalization DBCheckpointStorage uses at write time).
        rid = row[0]
        rid = (bytes(rid).hex() if isinstance(rid, (bytes, memoryview))
               else str(rid))
        return checkpoint_crc(rid, bytes(row[1]))
    if table == "committed_states":
        return committed_crc(bytes(row[0]), bytes(row[1]))
    return reserved_crc(bytes(row[0]), bytes(row[1]), float(row[2]))


# table -> (select with rowid pagination, key column index, crc index)
_SCAN_SQL = {
    "raft_log": ("SELECT idx, term, blob, crc, rowid FROM raft_log "
                 "WHERE rowid > ? ORDER BY rowid LIMIT ?", 3),
    "checkpoints": ("SELECT run_id, blob, crc, rowid FROM checkpoints "
                    "WHERE rowid > ? ORDER BY rowid LIMIT ?", 2),
    "committed_states": (
        "SELECT state_ref, consuming, crc, rowid FROM committed_states "
        "WHERE rowid > ? ORDER BY rowid LIMIT ?", 2),
    "reserved_states": (
        "SELECT state_ref, tx_id, expires_at, crc, rowid "
        "FROM reserved_states WHERE rowid > ? ORDER BY rowid LIMIT ?", 3),
}

_BACKFILL_SQL = {
    "raft_log": "UPDATE raft_log SET crc=? WHERE rowid=? AND crc IS NULL",
    "checkpoints":
        "UPDATE checkpoints SET crc=? WHERE rowid=? AND crc IS NULL",
    "committed_states":
        "UPDATE committed_states SET crc=? WHERE rowid=? AND crc IS NULL",
    "reserved_states":
        "UPDATE reserved_states SET crc=? WHERE rowid=? AND crc IS NULL",
}


def _table_exists(conn, table: str) -> bool:
    return conn.execute(
        "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?",
        (table,)).fetchone() is not None


def scan_table(conn, table: str, *, repair: bool = False,
               chunk: int = 256, throttle=None) -> dict:
    """Walk one table verifying checksums. Returns ``{"scanned", "corrupt",
    "legacy", "backfilled", "corrupt_keys"}``.

    ``repair`` backfills legacy rows and, for ``checkpoints`` only,
    quarantines corrupt rows (replicated/ledger tables are never repaired
    here — raft heals through consensus, ledger rows resync from peers).
    ``throttle`` is called once per chunk with the chunk's row count (the
    scrubber's rate bound); None scans flat out (fsck)."""
    out = {"scanned": 0, "corrupt": 0, "legacy": 0, "backfilled": 0,
           "corrupt_keys": []}
    if not _table_exists(conn, table):
        return out
    sql, crc_idx = _SCAN_SQL[table]
    last_rowid = 0
    while True:
        rows = conn.execute(sql, (last_rowid, chunk)).fetchall()
        if not rows:
            break
        dirty = False
        for row in rows:
            last_rowid = row[-1]
            out["scanned"] += 1
            stored = row[crc_idx]
            want = _row_crc(table, row)
            if stored is None:
                out["legacy"] += 1
                if repair:
                    conn.execute(_BACKFILL_SQL[table], (want, row[-1]))
                    out["backfilled"] += 1
                    dirty = True
            elif int(stored) != want:
                out["corrupt"] += 1
                key = row[0] if table != "raft_log" else int(row[0])
                out["corrupt_keys"].append(
                    key.hex() if isinstance(key, (bytes, memoryview))
                    else key)
                if repair and table == "checkpoints":
                    quarantine_row(conn, "checkpoint", str(row[0]),
                                   bytes(row[1]), "crc mismatch (scrub)")
                    conn.execute("DELETE FROM checkpoints WHERE rowid=?",
                                 (row[-1],))
                    bump("checkpoints_quarantined")
                    dirty = True
        if dirty:
            conn.commit()
        if throttle is not None:
            throttle(len(rows))
    return out


class Scrubber:
    """Low-priority online scrub: a daemon thread walking every
    integrity-framed table of one node database at a bounded row rate on
    its OWN sqlite connection (WAL readers never block the node's
    writer), backfilling legacy checksums and quarantining corrupt
    checkpoints as it goes.  Counters surface via node_metrics
    ("durability" key); each full pass records a ``scrub`` span when
    tracing is armed."""

    def __init__(self, db_path, rows_per_s: float = 500.0,
                 interval_s: float = 5.0, node_name: str = ""):
        self.db_path = str(db_path)
        self.rows_per_s = max(1.0, float(rows_per_s))
        self.interval_s = max(0.1, float(interval_s))
        self.node_name = node_name
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.counters = {"integrity_scans": 0, "integrity_errors": 0,
                         "crc_backfilled": 0, "scrub_passes": 0}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"scrub-{self.node_name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)

    # -- scanning ---------------------------------------------------------

    def run_pass(self, repair: bool = True) -> dict:
        """One full scan of every table; also callable synchronously
        (tests, fsck-style gates) with the thread stopped."""
        import sqlite3

        from ...obs import trace as _obs

        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        budget = [0.0]

        def throttle(rows: int) -> None:
            # Bounded rate: sleep off the time this chunk "cost" at the
            # configured rows/s, minus what scanning actually took.
            budget[0] += rows / self.rows_per_s
            if budget[0] > 0.05 and not self._stop.is_set():
                time.sleep(min(budget[0], 0.25))
                budget[0] = 0.0

        totals = {"scanned": 0, "corrupt": 0, "legacy": 0, "backfilled": 0}
        conn = sqlite3.connect(self.db_path, timeout=5.0)
        try:
            for table in INTEGRITY_TABLES:
                if self._stop.is_set():
                    break
                res = scan_table(conn, table, repair=repair,
                                 throttle=throttle)
                for k in totals:
                    totals[k] += res[k]
        finally:
            conn.close()
        with self._lock:
            self.counters["integrity_scans"] += totals["scanned"]
            self.counters["integrity_errors"] += totals["corrupt"]
            self.counters["crc_backfilled"] += totals["backfilled"]
            self.counters["scrub_passes"] += 1
        if _obs.ACTIVE is not None:
            _obs.record("scrub", t0, _obs.now(),
                        attrs={"node": self.node_name, **totals})
        return totals

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_pass(repair=True)
            except Exception:
                # A scrub pass racing a table rebuild (snapshot install,
                # reshard purge) can lose benignly; the next pass rescans.
                # Counted so a persistently failing scrubber is visible in
                # node_metrics instead of silently scanning nothing.
                with self._lock:
                    self.counters["scrub_pass_failures"] = \
                        self.counters.get("scrub_pass_failures", 0) + 1
            self._stop.wait(self.interval_s)
