"""Offline store verifier + repairer for a node directory (boot fsck).

Walks every sqlite store under a node dir (``*.db``) and verifies the
CRC32C integrity frames written by ``node/services/integrity.py`` over the
raft log, flow checkpoints, and ledger rows. Exit status is the contract:

  0  every checked row verified (legacy NULL-crc rows count as clean)
  1  at least one corrupt row was found (or remains after --repair)

``--repair`` applies the same row-level actions the online planes use:

  * legacy rows (NULL crc) are backfilled with a freshly computed frame;
  * a corrupt checkpoint moves to the ``quarantine`` table (the flow is
    declared failed at next boot, replay is never poisoned);
  * a corrupt raft-log row truncates the log suffix from that index when
    it is beyond the applied prefix (the member rejoins as a lagging
    follower and re-replicates), or compacts the applied prefix behind
    the snapshot marker when the effects are already durable in
    committed_states — the exact decision tree of
    ``RaftMember._heal_corrupt_entry``, applied cold;
  * corrupt committed/reserved ledger rows are REPORTED only — a spent
    input must never be un-spent by a repair tool; re-replication or the
    shard audit is the recovery path.

Usage:
  python -m corda_tpu_torch.tools.fsck <node-dir> [--json] [--repair]

``fsck_paths()`` is the importable form the loadtest harnesses call as a
post-run gate (every surviving node's store must verify clean after a
chaos soak).
"""

from __future__ import annotations

import argparse
import json
import sqlite3
import sys
import time
from pathlib import Path

from ..node.services import integrity as _integrity
from ..obs import trace as _obs

__all__ = ["fsck_db", "fsck_paths", "main"]


def _heal_raft_log(conn, corrupt_keys: list) -> dict:
    """Cold-store version of RaftMember._heal_corrupt_entry: truncate an
    unapplied corrupt suffix, compact an applied corrupt prefix."""
    raw = conn.execute(
        "SELECT value FROM settings WHERE key = 'raft_last_applied'"
    ).fetchone()
    last_applied = int(raw[0]) if raw else 0
    actions = {"truncated_from": None, "compacted_upto": None}
    # corrupt_keys are raft_log idx values (see integrity._SCAN_SQL).
    bad = sorted(int(k) for k in corrupt_keys)
    applied_bad = [i for i in bad if i <= last_applied]
    suffix_bad = [i for i in bad if i > last_applied]
    if applied_bad:
        # Effects are durable in committed_states: drop the applied prefix
        # behind the snapshot marker, ONE transaction (raft.maybe_compact
        # invariant — a crash between DELETE and marker rebases indices).
        upto = last_applied
        row = conn.execute(
            "SELECT term FROM raft_log WHERE idx = ?", (upto,)).fetchone()
        term = int(row[0]) if row else 0
        if term == 0:
            raw = conn.execute(
                "SELECT value FROM settings "
                "WHERE key = 'raft_snapshot_term'").fetchone()
            term = int(raw[0]) if raw else 0
        conn.execute("DELETE FROM raft_log WHERE idx <= ?", (upto,))
        for key, value in (("raft_snapshot_index", str(upto)),
                           ("raft_snapshot_term", str(term))):
            conn.execute(
                "INSERT OR REPLACE INTO settings (key, value) VALUES (?, ?)",
                (key, value))
        actions["compacted_upto"] = upto
    if suffix_bad:
        frm = suffix_bad[0]
        conn.execute("DELETE FROM raft_log WHERE idx >= ?", (frm,))
        actions["truncated_from"] = frm
    conn.commit()
    return actions


def fsck_db(path: str | Path, *, repair: bool = False) -> dict:
    """Verify (and optionally repair) ONE sqlite store. Returns a report
    dict; report["clean"] is the gate verdict."""
    t0 = time.monotonic()
    conn = sqlite3.connect(str(path), timeout=5.0)
    try:
        # A pre-durability store has no crc columns yet: apply the same
        # idempotent in-place upgrade the node does at open (rows become
        # legacy NULL-crc rows, which verify clean and backfill under
        # --repair). No-op on an already-upgraded store.
        _integrity.ensure_integrity_schema(conn)
        conn.commit()
        tables = {}
        total_corrupt = 0
        healed = {}
        for table in _integrity.INTEGRITY_TABLES:
            res = _integrity.scan_table(conn, table, repair=repair)
            tables[table] = res
            total_corrupt += res["corrupt"]
            if repair and table == "raft_log" and res["corrupt_keys"]:
                healed["raft_log"] = _heal_raft_log(
                    conn, res["corrupt_keys"])
        # Checkpoint quarantines count as repaired, not still-corrupt: the
        # damage is contained and boot proceeds. Raft heals likewise. A
        # corrupt LEDGER row is never auto-repaired and keeps the store
        # dirty — that demands re-replication, not a local rewrite.
        unrepaired = total_corrupt
        if repair:
            unrepaired = (tables["committed_states"]["corrupt"]
                          + tables["reserved_states"]["corrupt"])
        return {
            "path": str(path),
            "clean": (unrepaired == 0 if repair else total_corrupt == 0),
            "corrupt": total_corrupt,
            "scanned": sum(t["scanned"] for t in tables.values()),
            "legacy": sum(t["legacy"] for t in tables.values()),
            "backfilled": sum(t["backfilled"] for t in tables.values()),
            "repaired": healed if repair else None,
            "tables": tables,
            "elapsed_s": round(time.monotonic() - t0, 6),
        }
    finally:
        conn.close()


def fsck_paths(path: str | Path, *, repair: bool = False) -> dict:
    """Verify every ``*.db`` store under a node dir (or one file). The
    harness gate: report["clean"] over all stores."""
    path = Path(path)
    dbs = [path] if path.is_file() else sorted(path.glob("**/*.db"))
    t0 = _obs.now()
    reports = [fsck_db(db, repair=repair) for db in dbs]
    if _obs.ACTIVE is not None:
        _obs.record("scrub", t0, _obs.now(),
                    attrs={"stores": len(reports), "tool": "fsck"})
    return {
        "path": str(path),
        "stores": len(reports),
        "clean": all(r["clean"] for r in reports),
        "corrupt": sum(r["corrupt"] for r in reports),
        "scanned": sum(r["scanned"] for r in reports),
        "backfilled": sum(r["backfilled"] for r in reports),
        "reports": reports,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m corda_tpu_torch.tools.fsck",
        description="verify (and repair) a node dir's integrity frames")
    ap.add_argument("path", help="node base dir or a single .db file")
    ap.add_argument("--json", action="store_true",
                    help="one-line JSON report on stdout")
    ap.add_argument("--repair", action="store_true",
                    help="backfill legacy frames, quarantine corrupt "
                         "checkpoints, truncate/compact corrupt raft rows")
    args = ap.parse_args(argv)
    report = fsck_paths(args.path, repair=args.repair)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        for r in report["reports"]:
            verdict = "clean" if r["clean"] else "CORRUPT"
            print(f"{r['path']}: {verdict} "
                  f"(scanned={r['scanned']} corrupt={r['corrupt']} "
                  f"legacy={r['legacy']} backfilled={r['backfilled']})")
        print(f"{report['stores']} store(s): "
              + ("clean" if report["clean"] else "CORRUPT"))
    return 0 if report["clean"] else 1


if __name__ == "__main__":  # pragma: no cover - CLI shim
    sys.exit(main())
