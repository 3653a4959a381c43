"""The judge of ``raft-notary-3`` (reference/judge.py) on planted outcomes,
and its frozen decoder against the program's codec."""

from __future__ import annotations

import sqlite3

import pytest

from benchmark.reference import ed25519, judge

SEEDS = [bytes([k + 1]) * 32 for k in range(4)]
NOTARY = SEEDS[0]
MEMBER_KEYS = {ed25519.public_key(seed) for seed in SEEDS[:3]}


def _id(i: int) -> bytes:
    return bytes([i]) * 32


def _acked(i: int, honest: bool = True, seed: bytes = NOTARY) -> dict:
    tx = _id(i)
    return {"honest": honest, "acked": True, "tx_id": tx,
            "inputs": [(_id(100 + i), 0)],
            "notary_pk": ed25519.public_key(seed),
            "notary_sig": ed25519.sign(seed, tx)}


def _refused(i: int, honest: bool = False) -> dict:
    return {"honest": honest, "acked": False, "tx_id": _id(i),
            "inputs": [(_id(100 + i), 0)]}


def _stores(moves, on=(0, 1, 2)):
    """Three members' stores holding every acknowledged move's inputs on
    the members ``on``."""
    stores = [{}, {}, {}]
    for m in moves:
        if m["acked"]:
            for s in on:
                for ref in m["inputs"]:
                    stores[s][ref] = m["tx_id"]
    return stores


def _verify_many(lanes):
    return [ed25519.verify(pk, msg, sig) for pk, msg, sig in lanes]


def _judge(moves, stores):
    return judge.judge(moves, stores, 2, MEMBER_KEYS, _verify_many)


def _sound():
    return [_acked(1), _acked(2), _refused(3), _refused(4)]


def test_a_sound_run_reads_zero_everywhere():
    moves = _sound()
    assert set(_judge(moves, _stores(moves)).values()) == {0}


def test_an_acknowledged_tampered_move_is_a_wrong_outcome():
    moves = _sound() + [_acked(5, honest=False)]
    checks = _judge(moves, _stores(moves))
    assert checks["flows_wrong_outcome"] == 1
    assert checks["acked_not_on_majority"] == 0


def test_a_refused_honest_move_and_a_missing_outcome_are_wrong():
    moves = _sound() + [_refused(6, honest=True),
                        dict(_refused(7, honest=True), acked=None)]
    assert _judge(moves, _stores(moves))["flows_wrong_outcome"] == 2


def test_an_acknowledged_id_on_one_member_only():
    moves = _sound()
    stores = _stores(moves)
    del stores[1][(_id(101), 0)]
    del stores[2][(_id(101), 0)]
    checks = _judge(moves, stores)
    assert checks["acked_not_on_majority"] == 1
    del stores[2][(_id(102), 0)]
    assert _judge(moves, stores)["acked_not_on_majority"] == 1
    stores[2][(_id(101), 0)] = _id(99)  # committed under another id
    assert _judge(moves, stores)["acked_not_on_majority"] == 1


def test_a_refused_move_committed_on_any_member():
    moves = _sound()
    stores = _stores(moves)
    stores[2][(_id(103), 0)] = _id(3)
    assert _judge(moves, stores)["refused_committed_anywhere"] == 1
    stores[2][(_id(103), 0)] = _id(1)  # another move's id: not this one's
    assert _judge(moves, stores)["refused_committed_anywhere"] == 0


@pytest.mark.parametrize("fault", ["flipped", "other_id", "missing",
                                   "short", "foreign_key"])
def test_a_bad_notary_signature(fault):
    bad = _acked(8)
    if fault == "flipped":
        sig = bytearray(bad["notary_sig"])
        sig[5] ^= 1
        bad["notary_sig"] = bytes(sig)
    elif fault == "other_id":
        bad["notary_sig"] = ed25519.sign(NOTARY, _id(9))
    elif fault == "missing":
        del bad["notary_sig"]
    elif fault == "short":
        bad["notary_pk"] = bad["notary_pk"][:31]
    else:
        # A valid signature over the id, by a key no member holds.
        bad = _acked(8, seed=SEEDS[3])
    moves = _sound() + [bad]
    checks = _judge(moves, _stores(moves))
    assert checks["notary_sigs_wrong"] == 1
    assert checks["flows_wrong_outcome"] == 0


def test_the_frozen_decoder_reads_the_programs_rows(tmp_path):
    from corda_tpu_torch.contracts.structures import StateRef
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.crypto.keys import KeyPair
    from corda_tpu_torch.crypto.party import Party
    from corda_tpu_torch.node.services.api import ConsumingTx
    from corda_tpu_torch.serialization.codec import serialize

    party = Party.of("Raft0", KeyPair.generate(SEEDS[1]).public)
    rows = []
    for i in range(5):
        ref = StateRef(SecureHash.sha256(bytes([i])), i)
        tx = SecureHash.sha256(bytes([50 + i]))
        rows.append((serialize(ref).bytes,
                     serialize(ConsumingTx(tx, i, party)).bytes))
    db = tmp_path / "node.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE committed_states (state_ref BLOB PRIMARY KEY,"
                 " consuming BLOB NOT NULL, crc INTEGER)")
    conn.executemany("INSERT INTO committed_states (state_ref, consuming) "
                     "VALUES (?, ?)", rows)
    conn.commit()
    conn.close()
    got = judge.committed(db)
    assert got == {(SecureHash.sha256(bytes([i])).bytes, i):
                   SecureHash.sha256(bytes([50 + i])).bytes
                   for i in range(5)}
    with pytest.raises(ValueError):
        judge.state_ref(rows[0][1])
    with pytest.raises(ValueError):
        judge.consuming_id(rows[0][0])
