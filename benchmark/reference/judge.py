"""The plain reference of ``raft-notary-3``: what the deployment's
guarantees say of every move a run started, judged from the clients'
records, the labels the seed fixed and each member's durable store.

It imports nothing of the program. A member's ``committed_states`` rows
(``state_ref`` and ``consuming`` blobs, in the codec's wire format) are
read with ``sqlite3`` after the member has stopped, through the frozen
decoder below, which knows the format's tags and nothing of its classes:

  StateRef    object "contracts.structures.StateRef"
              (object "crypto.hashes.SecureHash" (bytes), int index)
  ConsumingTx object "node.services.api.ConsumingTx"
              (SecureHash id, int input index, requesting party)

The four numbers, each with limit 0:

  flows_wrong_outcome         moves whose outcome is not their label's:
                              an honest move not acknowledged, a tampered
                              move or a second spend acknowledged, a move
                              that never got an outcome
  notary_sigs_wrong           acknowledged moves without a signature over
                              their id, by one of the members' notary keys,
                              that the oracle accepts
  acked_not_on_majority       acknowledged moves whose inputs are not all
                              committed under their id on a majority of the
                              members' stores, read once every member has
                              applied the leader's commits and stopped: it
                              shows that a majority came to hold each
                              acknowledged move, not that it held it by the
                              time of the acknowledgement
  refused_committed_anywhere  refused moves with an input committed under
                              their id on any member's store
"""

from __future__ import annotations

import sqlite3

# Wire tags of the codec's format (frozen).
_NONE, _FALSE, _TRUE, _INT, _BYTES, _STR = 0, 1, 2, 3, 4, 5
_LIST, _DICT, _OBJECT, _FROZENSET, _FLOAT = 6, 7, 8, 9, 10

STATE_REF = "contracts.structures.StateRef"
SECURE_HASH = "crypto.hashes.SecureHash"
CONSUMING_TX = "node.services.api.ConsumingTx"


def _varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode(data: bytes, pos: int = 0):
    """(value, next position): objects decode to (wire name, fields)."""
    tag = data[pos]
    pos += 1
    if tag in (_NONE, _FALSE, _TRUE):
        return (None, False, True)[tag], pos
    if tag == _INT:
        n, pos = _varint(data, pos)
        return (n >> 1) ^ -(n & 1), pos
    if tag == _FLOAT:
        return data[pos:pos + 8], pos + 8
    if tag in (_BYTES, _STR):
        n, pos = _varint(data, pos)
        raw = bytes(data[pos:pos + n])
        return (raw if tag == _BYTES else raw.decode("utf-8")), pos + n
    if tag in (_LIST, _FROZENSET, _DICT):
        n, pos = _varint(data, pos)
        items = []
        for _ in range(n * (2 if tag == _DICT else 1)):
            item, pos = decode(data, pos)
            items.append(item)
        return tuple(items), pos
    if tag == _OBJECT:
        n, pos = _varint(data, pos)
        name = bytes(data[pos:pos + n]).decode("utf-8")
        pos += n
        count, pos = _varint(data, pos)
        fields = []
        for _ in range(count):
            item, pos = decode(data, pos)
            fields.append(item)
        return (name, tuple(fields)), pos
    raise ValueError(f"unknown wire tag {tag} at {pos - 1}")


def _hash_bytes(value) -> bytes:
    name, fields = value
    if name != SECURE_HASH:
        raise ValueError(f"expected a SecureHash, got {name}")
    return fields[0]


def state_ref(blob: bytes) -> tuple[bytes, int]:
    (name, fields), _ = decode(blob)
    if name != STATE_REF:
        raise ValueError(f"expected a StateRef, got {name}")
    return _hash_bytes(fields[0]), fields[1]


def consuming_id(blob: bytes) -> bytes:
    (name, fields), _ = decode(blob)
    if name != CONSUMING_TX:
        raise ValueError(f"expected a ConsumingTx, got {name}")
    return _hash_bytes(fields[0])


def committed(db_path) -> dict:
    """{(tx hash, output index): consuming tx id} of one member's store."""
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True, timeout=30.0)
    try:
        rows = conn.execute(
            "SELECT state_ref, consuming FROM committed_states").fetchall()
    finally:
        conn.close()
    return {state_ref(bytes(r)): consuming_id(bytes(c)) for r, c in rows}


def judge(moves: list[dict], stores: list[dict], majority: int,
          notary_keys, verify_many) -> dict:
    """The four numbers over ``moves``: dicts with ``honest`` (the label:
    whether the move must be acknowledged), ``acked`` (True, False, or None
    for no outcome), ``tx_id`` and ``inputs`` ([(tx hash, index)], bytes
    and int), and for an acknowledged move ``notary_pk`` and
    ``notary_sig``. ``stores``: each member's ``committed()``;
    ``notary_keys``: the members' notary public keys (32 bytes each).
    ``verify_many(lanes)`` gives the oracle's verdict on each (public key,
    message, signature)."""
    wrong = sum(1 for m in moves if m["acked"] is not m["honest"])
    acked = [m for m in moves if m["acked"] is True]
    lanes = [(m.get("notary_pk") or b"", m["tx_id"], m.get("notary_sig")
              or b"") for m in acked]
    well_formed = [pk in notary_keys and len(sig) == 64
                   for pk, _, sig in lanes]
    verdicts = verify_many([lane for lane, ok in zip(lanes, well_formed)
                            if ok])
    it = iter(verdicts)
    sigs_wrong = sum(1 for ok in well_formed if not (ok and next(it)))

    def holding(m) -> int:
        return sum(1 for s in stores
                   if all(s.get(ref) == m["tx_id"] for ref in m["inputs"]))

    not_majority = sum(1 for m in acked if holding(m) < majority)
    refused_committed = sum(
        1 for m in moves if m["acked"] is False
        and any(s.get(ref) == m["tx_id"] for s in stores
                for ref in m["inputs"]))
    return {"flows_wrong_outcome": wrong, "notary_sigs_wrong": sigs_wrong,
            "acked_not_on_majority": not_majority,
            "refused_committed_anywhere": refused_committed}
