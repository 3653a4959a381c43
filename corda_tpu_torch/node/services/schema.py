"""Queryable state projections — typed rows from vault updates.

Capability match for the reference's schema tier (reference:
core/src/main/kotlin/net/corda/core/schemas/PersistentTypes.kt —
QueryableState/MappedSchema — node/.../schema/NodeSchemaService.kt and
HibernateObserver.kt:28 — vault updates map queryable states to ORM rows):
states that implement `to_schema_row()` get a relational projection in the
node's sqlite database, maintained on every vault update, so operational
queries ("all cash over X", "deals fixing this week") run as SQL instead of
deserializing the whole vault.

Row contract: (table_name, {column: int | float | str | bytes}). The
projection table gains `ref_txhash`/`ref_index`/`consumed` columns; rows are
marked consumed rather than deleted, preserving history for audit queries
(the reference keeps consumed rows the same way via vault state status).
"""

from __future__ import annotations

import re

# The projection protocol is duck-typed: a state participates by defining
# to_schema_row() -> (table_name, {column: value}) — no base class to
# inherit, so finance states need no node-tier import.

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _check_ident(name: str) -> str:
    if not _IDENT.match(name):
        raise ValueError(f"invalid SQL identifier {name!r}")
    return name


class SchemaObserver:
    """Maintains the projections from vault updates (HibernateObserver.kt
    capability, sqlite instead of Hibernate)."""

    def __init__(self, vault_service, db):
        self._db = db
        self._tables: set[str] = set()
        vault_service.subscribe(self._on_update)
        with self._db.lock:
            for sar in vault_service.iter_unconsumed():
                self._produce(sar)
            self._db.conn.commit()

    def _on_update(self, update) -> None:
        # One sqlite commit per vault update, not per state: this runs
        # synchronously inside record_transactions.
        with self._db.lock:
            for sar in update.produced:
                self._produce(sar)
            for sar in update.consumed:
                self._consume(sar)
            self._db.conn.commit()

    def _ensure_table(self, table: str, row: dict) -> None:
        if table in self._tables:
            return
        cols = ", ".join(
            f"{_check_ident(k)} {self._sql_type(v)}" for k, v in row.items())
        self._db.conn.execute(
            f"CREATE TABLE IF NOT EXISTS {_check_ident(table)} "
            f"(ref_txhash BLOB, ref_index INTEGER, consumed INTEGER "
            f"DEFAULT 0, {cols}, PRIMARY KEY (ref_txhash, ref_index))")
        self._tables.add(table)

    @staticmethod
    def _sql_type(value) -> str:
        if isinstance(value, bool) or isinstance(value, int):
            return "INTEGER"
        if isinstance(value, float):
            return "REAL"
        if isinstance(value, bytes):
            return "BLOB"
        return "TEXT"

    def _produce(self, sar) -> None:
        state = sar.state.data
        if not hasattr(state, "to_schema_row"):  # duck-typed: finance states
            return                               # need no node-tier import
        table, row = state.to_schema_row()
        self._ensure_table(table, row)
        cols = ", ".join(_check_ident(k) for k in row)
        marks = ", ".join("?" for _ in row)
        self._db.conn.execute(
            f"INSERT OR REPLACE INTO {_check_ident(table)} "
            f"(ref_txhash, ref_index, consumed, {cols}) "
            f"VALUES (?, ?, 0, {marks})",
            (sar.ref.txhash.bytes, sar.ref.index, *row.values()))

    def _consume(self, sar) -> None:
        state = sar.state.data
        if not hasattr(state, "to_schema_row"):
            return
        table, _row = state.to_schema_row()
        if table not in self._tables:
            return
        self._db.conn.execute(
            f"UPDATE {_check_ident(table)} SET consumed = 1 "
            f"WHERE ref_txhash = ? AND ref_index = ?",
            (sar.ref.txhash.bytes, sar.ref.index))

    def query(self, table: str, where: str = "", params: tuple = ()) -> list:
        """Read projection rows (dicts). `where` is a SQL fragment over the
        projection's own columns — operational tooling, not a wire surface."""
        sql = f"SELECT * FROM {_check_ident(table)}"
        if where:
            sql += f" WHERE {where}"
        with self._db.lock:
            cur = self._db.conn.execute(sql, params)
            names = [d[0] for d in cur.description]
            return [dict(zip(names, r)) for r in cur.fetchall()]
