"""The port's persistence, integrity frames, fsck and disk fault hooks,
held to the JAX package's.

Every case runs the same operations through ``corda_tpu`` and
``corda_tpu_torch`` (each over its own sqlite file) and compares what they
store and answer: CRC32C on the RFC 3720 vector and on seeded random
batches (the port's ``_ccommit`` core, the JAX package's, and both Python
paths), the storages' rows byte for byte, the uniqueness provider's commit
log and conflicts, legacy-store upgrade, checkpoint quarantine, the
scrubber's counters, ``fsck``'s exit codes and reports, and the
``disk.corrupt`` / ``disk.full`` hooks under one seeded plan.
"""

import importlib
import json
import random
import sqlite3
from types import SimpleNamespace

import pytest


def _package(root):
    p = SimpleNamespace()
    for attr, mod in (("integrity", "node.services.integrity"),
                      ("persistence", "node.services.persistence"),
                      ("api", "node.services.api"),
                      ("faults", "testing.faults"),
                      ("fsck", "tools.fsck"),
                      ("native", "native"),
                      ("keys", "crypto.keys"),
                      ("party", "crypto.party"),
                      ("hashes", "crypto.hashes"),
                      ("dummies", "testing.dummies"),
                      ("structures", "contracts.structures")):
        setattr(p, attr, importlib.import_module(f"{root}.{mod}"))
    return p


JAX = _package("corda_tpu")
PORT = _package("corda_tpu_torch")
BOTH = pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _disarm():
    for p in (JAX, PORT):
        p.faults.disarm()
    yield
    for p in (JAX, PORT):
        p.faults.disarm()


def _rows(path, table):
    conn = sqlite3.connect(str(path))
    try:
        return [tuple(bytes(v) if isinstance(v, (bytes, memoryview)) else v
                      for v in row)
                for row in conn.execute(f"SELECT * FROM {table} ORDER BY 1")]
    finally:
        conn.close()


# -- CRC32C -----------------------------------------------------------------


@BOTH
def test_crc32c_reference_vector(p):
    assert p.integrity.crc32c(b"123456789") == 0xE3069283
    assert p.integrity.crc32c(
        b"6789", p.integrity.crc32c(b"12345")) == 0xE3069283


def _pairs(seed, n):
    rng = random.Random(seed)
    pairs = [(b"123456789", b"")]
    pairs += [(rng.randbytes(rng.randrange(0, 96)),
               rng.randbytes(rng.randrange(0, 96))) for _ in range(n)]
    return pairs


@pytest.mark.parametrize("seed", [0x18, 7, 2026])
def test_ccommit_and_python_crc_equal_the_jax_package(seed):
    pairs = _pairs(seed, 200)
    want = [JAX.integrity.committed_crc(r, c) for r, c in pairs]
    assert [PORT.integrity.committed_crc(r, c) for r, c in pairs] == want
    assert PORT.integrity.committed_crc_many(pairs) == want
    port_core = PORT.native.load_ccommit()
    assert port_core is not None, "gcc builds _ccommit.c on this host"
    assert list(port_core.committed_crc_many(pairs)) == want
    jax_core = JAX.native.load_ccommit()
    if jax_core:
        assert list(jax_core.committed_crc_many(pairs)) == want
    assert port_core.committed_crc_many([]) == [] or \
        list(port_core.committed_crc_many([])) == []


def test_python_fallback_equals_native(monkeypatch):
    pairs = _pairs(3, 64)
    native = PORT.integrity.committed_crc_many(pairs)
    monkeypatch.setattr(PORT.integrity, "_ccommit", False)
    assert PORT.integrity.committed_crc_many(pairs) == native


@pytest.mark.parametrize("seed", [1, 2])
def test_frame_checksums_equal_the_jax_package(seed):
    rng = random.Random(seed)
    for _ in range(50):
        blob = rng.randbytes(rng.randrange(0, 300))
        idx, term = rng.randrange(1 << 40), rng.randrange(1 << 20)
        assert PORT.integrity.log_crc(idx, term, blob) == \
            JAX.integrity.log_crc(idx, term, blob)
        run_id = rng.randbytes(8).hex()
        assert PORT.integrity.checkpoint_crc(run_id, blob) == \
            JAX.integrity.checkpoint_crc(run_id, blob)
        expires = rng.random() * 1e9
        assert PORT.integrity.reserved_crc(blob[:33], blob[33:65], expires) \
            == JAX.integrity.reserved_crc(blob[:33], blob[33:65], expires)


# -- storages and the uniqueness provider ------------------------------------


def _signed_pair(p, magic):
    key = p.keys.KeyPair.generate(b"\x41" * 32)
    notary = p.party.Party.of("N", p.keys.KeyPair.generate(b"\x42" * 32).public)
    me = p.party.Party.of("Alice", key.public)
    builder = p.dummies.DummyContract.generate_initial(
        me.ref(bytes([magic])), magic, notary)
    builder.sign_with(key)
    issue = builder.to_signed_transaction()
    move = p.dummies.DummyContract.move(issue.tx.out_ref(0), me.owning_key)
    move.sign_with(key)
    return me, issue, move.to_signed_transaction(
        check_sufficient_signatures=False)


def _drive_storages(p, path):
    db = p.persistence.NodeDatabase(path)
    key = db.load_or_create_identity("Alice", b"\x07" * 32)
    txs = p.persistence.DBTransactionStorage(db)
    atts = p.persistence.DBAttachmentStorage(db)
    maps = p.persistence.DBTransactionMappingStorage(db)
    cps = p.persistence.DBCheckpointStorage(db)
    me, issue, move = _signed_pair(p, 5)
    txs.add_transaction(issue)
    txs.add_transaction(move)
    txs.add_transaction(issue)  # idempotent
    att = atts.import_attachment(b"attachment-bytes")
    maps.add_mapping(b"run-1", move.id)
    maps.add_mapping(b"run-1", move.id)
    cps.update_checkpoint(b"\x01" * 8, b"checkpoint-one")
    cps.update_checkpoint(b"\x02" * 8, b"checkpoint-two")
    cps.remove_checkpoint(b"\x01" * 8)
    uniq = p.persistence.PersistentUniquenessProvider(db)
    refs = list(move.tx.inputs)
    uniq.commit(refs, move.id, me)
    uniq.commit(refs, move.id, me)  # the same tx again: no conflict
    with pytest.raises(p.api.UniquenessException) as err:
        uniq.commit(refs, issue.id, me)
    conflict = err.value.error.state_history
    out = {
        "key": bytes(key.public.encoded),
        "tx_ids": [bytes(s.id.bytes) for _r, s in txs.stream_since(0)],
        "got": bytes(txs.get_transaction(move.id).id.bytes),
        "att": bytes(att.bytes),
        "att_data": atts.open_attachment(att).open(),
        "maps": [(m.run_id, bytes(m.tx_id.bytes)) for m in maps.mappings()],
        "cps": cps.items(),
        "committed_count": uniq.committed_count,
        "conflict": sorted((bytes(r.txhash.bytes), r.index,
                            bytes(c.id.bytes), c.input_index)
                           for r, c in conflict.items()),
    }
    db.close()
    return out


def test_storages_and_uniqueness_equal_the_jax_package(tmp_path):
    jax_out = _drive_storages(JAX, tmp_path / "jax.db")
    port_out = _drive_storages(PORT, tmp_path / "port.db")
    assert port_out == jax_out
    assert port_out["committed_count"] == 1 and len(port_out["conflict"]) == 1
    for table in ("transactions", "attachments", "tx_mappings",
                  "checkpoints", "committed_states", "node_identity"):
        assert _rows(tmp_path / "port.db", table) == \
            _rows(tmp_path / "jax.db", table), table


def test_stored_blob_round_trips_across_packages(tmp_path):
    """A transaction the JAX package stored reads back in the port (the
    codec's wire names carry no package prefix), and the other way."""
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        path = tmp_path / f"{writer is JAX}.db"
        db = writer.persistence.NodeDatabase(path)
        _me, issue, _move = _signed_pair(writer, 9)
        writer.persistence.DBTransactionStorage(db).add_transaction(issue)
        db.close()
        db = reader.persistence.NodeDatabase(path)
        got = reader.persistence.DBTransactionStorage(db).get_transaction(
            reader.hashes.SecureHash(bytes(issue.id.bytes)))
        assert bytes(got.id.bytes) == bytes(issue.id.bytes)
        db.close()


# -- legacy stores, quarantine, scrubber, fsck ---------------------------------


def _legacy_store(path):
    conn = sqlite3.connect(str(path))
    conn.executescript("""
        CREATE TABLE settings (key TEXT PRIMARY KEY, value TEXT);
        CREATE TABLE raft_log (idx INTEGER PRIMARY KEY, term INTEGER,
                               blob BLOB);
        CREATE TABLE checkpoints (run_id BLOB PRIMARY KEY, blob BLOB);
        CREATE TABLE committed_states (state_ref BLOB PRIMARY KEY,
                                       consuming BLOB);
        CREATE TABLE reserved_states (state_ref BLOB PRIMARY KEY,
                                      tx_id BLOB, expires_at REAL);
    """)
    conn.execute("INSERT INTO raft_log VALUES (1, 1, ?)", (b"old-entry",))
    conn.execute("INSERT INTO checkpoints VALUES (?, ?)",
                 (b"\x0a" * 8, b"old-checkpoint"))
    conn.execute("INSERT INTO committed_states VALUES (?, ?)",
                 (b"\x11" * 33, b"\x22" * 32))
    conn.commit()
    conn.close()


def _strip(report):
    """A report without what differs between two runs: paths and times."""
    if isinstance(report, dict):
        return {k: _strip(v) for k, v in report.items()
                if k not in ("path", "elapsed_s")}
    if isinstance(report, list):
        return [_strip(v) for v in report]
    return report


def test_legacy_store_fsck_and_backfill_equal_the_jax_package(tmp_path):
    reports = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        path = tmp_path / f"{name}.db"
        _legacy_store(path)
        first = p.fsck.fsck_db(path)
        repaired = p.fsck.fsck_db(path, repair=True)
        again = p.fsck.fsck_db(path)
        reports[name] = [_strip(first), _strip(repaired), _strip(again)]
        assert first["clean"] and first["legacy"] == 3
        assert repaired["backfilled"] == 3 and again["legacy"] == 0
    assert reports["port"] == reports["jax"]
    assert _rows(tmp_path / "port.db", "raft_log") == \
        _rows(tmp_path / "jax.db", "raft_log")
    db = PORT.persistence.NodeDatabase(tmp_path / "port.db")
    assert "crc" in {r[1] for r in db.conn.execute(
        "PRAGMA table_info(checkpoints)").fetchall()}
    db.close()


@BOTH
def test_checkpoint_crc_mismatch_quarantined(p, tmp_path):
    db = p.persistence.NodeDatabase(tmp_path / "node.db")
    cs = p.persistence.DBCheckpointStorage(db)
    cs.update_checkpoint(b"\x01" * 8, b"good-checkpoint")
    cs.update_checkpoint(b"\x02" * 8, b"doomed-checkpoint")
    db.conn.execute("UPDATE checkpoints SET blob = ? WHERE run_id = ?",
                    (b"damaged!", b"\x02" * 8))
    db.conn.commit()
    before = p.integrity.stats().get("checkpoints_quarantined", 0)
    assert [rid for rid, _ in cs.items()] == [b"\x01" * 8]
    assert db.conn.execute(
        "SELECT COUNT(*) FROM quarantine WHERE kind = 'checkpoint'"
    ).fetchone() == (1,)
    assert p.integrity.stats()["checkpoints_quarantined"] == before + 1
    db.close()


def _framed_store(p, path, n=8, last_applied=4):
    db = p.persistence.NodeDatabase(path)
    db.conn.execute(
        "CREATE TABLE IF NOT EXISTS raft_log (idx INTEGER PRIMARY KEY, "
        "term INTEGER NOT NULL, blob BLOB NOT NULL, crc INTEGER)")
    for i in range(1, n + 1):
        blob = b"entry-%04d" % i
        db.conn.execute(
            "INSERT INTO raft_log (idx, term, blob, crc) VALUES (?,?,?,?)",
            (i, 1, blob, p.integrity.log_crc(i, 1, blob)))
    ref, con = b"\x11" * 33, b"\x22" * 32
    db.conn.execute(
        "INSERT INTO committed_states (state_ref, consuming, crc) "
        "VALUES (?, ?, ?)", (ref, con, p.integrity.committed_crc(ref, con)))
    db.conn.commit()
    db.set_setting("raft_last_applied", str(last_applied))
    db.close()


def _fsck_session(p, base, capsys):
    _framed_store(p, base / "node.db", n=8, last_applied=4)
    codes = [p.fsck.main([str(base)])]
    capsys.readouterr()
    conn = sqlite3.connect(str(base / "node.db"))
    conn.execute("UPDATE raft_log SET blob = ? WHERE idx = 2", (b"bad",))
    conn.execute("UPDATE raft_log SET blob = ? WHERE idx = 6", (b"bad",))
    conn.commit()
    conn.close()
    codes.append(p.fsck.main([str(base), "--json"]))
    report = json.loads(capsys.readouterr().out.strip())
    codes.append(p.fsck.main([str(base), "--repair"]))
    capsys.readouterr()
    codes.append(p.fsck.main([str(base)]))
    capsys.readouterr()
    return codes, _strip(report), _rows(base / "node.db", "raft_log"), \
        _rows(base / "node.db", "settings")


def test_fsck_detect_and_repair_equal_the_jax_package(tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_out = _fsck_session(JAX, tmp_path / "jax", capsys)
    port_out = _fsck_session(PORT, tmp_path / "port", capsys)
    assert port_out[0] == jax_out[0] == [0, 1, 0, 0]
    assert port_out[1]["corrupt"] == 2 and port_out[1]["clean"] is False
    assert port_out[1] == jax_out[1]
    assert port_out[2] == jax_out[2]
    assert [r[0] for r in port_out[2]] == [5]
    assert port_out[3] == jax_out[3]


def test_scrubber_counters_equal_the_jax_package(tmp_path):
    stats = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        path = tmp_path / f"{name}.db"
        _framed_store(p, path, n=6, last_applied=6)
        conn = sqlite3.connect(str(path))
        conn.execute("UPDATE raft_log SET crc = NULL WHERE idx = 1")
        conn.execute("UPDATE raft_log SET blob = ? WHERE idx = 3", (b"rot",))
        conn.commit()
        conn.close()
        scrubber = p.integrity.Scrubber(path, rows_per_s=1e6, node_name="t")
        scrubber.run_pass(repair=True)
        scrubber.run_pass(repair=True)
        stats[name] = scrubber.stats()
        json.dumps(p.integrity.stats(scrubber))
    keys = ("scrub_passes", "integrity_scans", "crc_backfilled",
            "integrity_errors")
    assert {k: stats["port"][k] for k in keys} == \
        {k: stats["jax"][k] for k in keys}
    assert stats["port"]["crc_backfilled"] == 1
    assert stats["port"]["integrity_errors"] == 2


# -- the disk fault hooks -----------------------------------------------------


def test_fault_points_equal_the_jax_package():
    assert PORT.faults.POINTS == JAX.faults.POINTS
    for name in ("fire_disk_corrupt", "fire_disk_full"):
        assert name in PORT.faults.__all__


@pytest.mark.parametrize("seed", [3, 23])
def test_disk_corrupt_flips_the_same_bits(seed):
    blobs = [random.Random(seed + i).randbytes(40 + i) for i in range(12)]
    out = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        p.faults.arm(p.faults.FaultPlan(seed, [
            p.faults.FaultRule("disk.corrupt", "flip", p=0.5, max_fires=6)]))
        out[name] = [p.faults.fire_disk_corrupt(b) for b in blobs]
        out[name + "_injected"] = p.faults.injected()
        p.faults.disarm()
    assert out["port"] == out["jax"]
    assert out["port_injected"] == out["jax_injected"]
    flipped = [a != b for a, b in zip(out["port"], blobs)]
    assert 0 < sum(flipped) <= 6
    for a, b in zip(out["port"], blobs):
        diff = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
        assert diff == 0 or diff & (diff - 1) == 0  # one bit at most


@BOTH
def test_disk_full_sheds_the_commit_all_or_nothing(p, tmp_path):
    db = p.persistence.NodeDatabase(tmp_path / "node.db")
    uniq = p.persistence.PersistentUniquenessProvider(db)
    me, _issue, move = _signed_pair(p, 11)
    p.faults.arm(p.faults.FaultPlan(5, [
        p.faults.FaultRule("disk.full", "full", max_fires=1)]))
    with pytest.raises(sqlite3.OperationalError, match="disk is full"):
        uniq.commit(list(move.tx.inputs), move.id, me)
    assert p.integrity.is_disk_full(sqlite3.OperationalError(
        "database or disk is full"))
    assert uniq.committed_count == 0
    uniq.commit(list(move.tx.inputs), move.id, me)  # the rule is spent
    assert uniq.committed_count == 1
    assert p.faults.injected() == {"disk.full:full": 1}
    db.close()


@BOTH
def test_disk_corrupt_on_restore_quarantines(p, tmp_path):
    db = p.persistence.NodeDatabase(tmp_path / "node.db")
    cs = p.persistence.DBCheckpointStorage(db)
    cs.update_checkpoint(b"\x01" * 8, b"checkpoint-one")
    cs.update_checkpoint(b"\x02" * 8, b"checkpoint-two")
    p.faults.arm(p.faults.FaultPlan(9, [
        p.faults.FaultRule("disk.corrupt", "flip", max_fires=1)]))
    items = cs.items()
    assert [rid for rid, _ in items] == [b"\x02" * 8]
    assert db.conn.execute("SELECT COUNT(*) FROM quarantine").fetchone() \
        == (1,)
    db.close()
