"""Vectorized ingest plane: columnar tx build/sign and multi-tx frames.

Round-15 mirror of the verify plane's columnar design, pointed the other
way: instead of one Python loop iteration per transaction (build a
TransactionBuilder, sign each key with a per-call `fast_ed25519.sign`,
serialize, send one frame), the ingest path batches each per-item cost
into one columnar pass over the whole chunk:

  * **build** — construct every issue/move builder for the chunk first
    (plain object graph work, no crypto);
  * **sign** — collect every (seed, wire-id) job across the chunk into
    two contiguous n*32-byte buffers and sign them in ONE GIL-released
    native call (crypto/batch_sign.py over `_cverify.c` sign_many),
    byte-identical to the per-tx `TransactionBuilder.sign_with` loop;
  * **serialize** — one codec pass per chunk packing N SignedTransactions
    into a single length-prefixed multi-tx frame (`pack_frame`) for
    shared-corpus handoff to replay workers, so worker processes never
    rebuild or re-sign anything.

The multi-tx frame is all-or-nothing: `unpack_frame` re-validates magic,
counts and exact length consumption and raises DeserializationError on
any junk or truncation — a damaged corpus blob loudly rejects, it never
partially applies.

The port's own copy of ``corda_tpu/tools/ingest.py``: the same CTI1 frame
and the same corpus bytes for the same keys and firehose.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

from ..serialization.codec import DeserializationError, deserialize, serialize

# -- multi-tx frame ---------------------------------------------------------

FRAME_MAGIC = b"CTI1"  # corda_tpu ingest frame, version 1
_U32 = struct.Struct("<I")
MAX_FRAME_ENTRIES = 1 << 22  # oversize-frame guard: reject before allocating


def pack_frame(payloads) -> bytes:
    """N serialized payloads -> one multi-tx frame: magic, u32 count, then
    u32-length-prefixed entries. One buffer, one write, one read."""
    parts = [FRAME_MAGIC, _U32.pack(len(payloads))]
    for p in payloads:
        b = bytes(p)
        parts.append(_U32.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


def unpack_frame(blob: bytes) -> list[bytes]:
    """Inverse of pack_frame, loud on damage: bad magic, an oversize
    count, a truncated entry or trailing junk all raise
    DeserializationError. Returns every payload or none — a partially
    valid frame never partially applies."""
    blob = bytes(blob)
    if len(blob) < 8 or blob[:4] != FRAME_MAGIC:
        raise DeserializationError(
            "not an ingest multi-tx frame (bad magic)")
    (count,) = _U32.unpack_from(blob, 4)
    if count > MAX_FRAME_ENTRIES:
        raise DeserializationError(
            f"ingest frame claims {count} entries "
            f"(max {MAX_FRAME_ENTRIES}) — oversize frame rejected")
    out: list[bytes] = []
    off = 8
    for i in range(count):
        if off + 4 > len(blob):
            raise DeserializationError(
                f"ingest frame truncated in entry {i} length "
                f"(offset {off} of {len(blob)})")
        (ln,) = _U32.unpack_from(blob, off)
        off += 4
        if off + ln > len(blob):
            raise DeserializationError(
                f"ingest frame truncated in entry {i} body "
                f"(need {ln} bytes at offset {off} of {len(blob)})")
        out.append(blob[off:off + ln])
        off += ln
    if off != len(blob):
        raise DeserializationError(
            f"ingest frame carries {len(blob) - off} trailing junk bytes")
    return out


# -- columnar corpus build --------------------------------------------------


@dataclass
class IngestStats:
    """Client-plane throughput attribution for one prepared corpus."""

    n_tx: int = 0
    sigs_signed: int = 0
    build_s: float = 0.0  # builder/object-graph construction (incl. wire)
    sign_s: float = 0.0  # columnar batch sign + attach
    serialize_s: float = 0.0  # codec pass packing the multi-tx frame(s)
    prepare_s: float = 0.0  # whole prepare wall (build + sign + record)
    cpu_s: float = 0.0  # process CPU consumed by prepare

    @property
    def tx_built_per_s(self) -> float:
        return round(self.n_tx / self.prepare_s, 1) if self.prepare_s else 0.0

    @property
    def sigs_signed_per_s(self) -> float:
        return round(self.sigs_signed / self.sign_s, 1) if self.sign_s \
            else 0.0

    @property
    def serialize_ms(self) -> float:
        return round(1e3 * self.serialize_s, 3)

    def stamp(self) -> dict:
        return {"n_tx": self.n_tx, "sigs_signed": self.sigs_signed,
                "build_s": round(self.build_s, 4),
                "sign_s": round(self.sign_s, 4),
                "serialize_ms": self.serialize_ms,
                "prepare_s": round(self.prepare_s, 4),
                "cpu_s": round(self.cpu_s, 4),
                "tx_built_per_s": self.tx_built_per_s,
                "sigs_signed_per_s": self.sigs_signed_per_s}


def build_chunk_columnar(firehose, start: int, count: int,
                         stats: IngestStats) -> list:
    """Columnar replacement for the firehose's per-tx prepare loop: build
    `count` corpus entries (each an issue-or-two + a width-signed move)
    in three batch phases — build every builder, ONE columnar sign over
    every (key, wire-id) job in the chunk, then one record_transactions
    call for every issuance. Output entries `(stx, route, cross)` are
    byte-identical to the retired `_build_one` loop (parity-tested):
    deterministic RFC 8032 signing over identical wire bytes.

    `firehose` is the loadgen._Firehose engine (duck-typed: uses its
    flow/keys/issuer/owners/notary/directory and cross bookkeeping).
    """
    from ..contracts.structures import Command
    from ..crypto.batch_sign import sign_builders
    from ..testing.dummies import (
        DummyCreate,
        DummyMove,
        DummyMultiOwnerState,
    )
    from ..transactions.builder import TransactionBuilder

    t0 = time.perf_counter()
    cpu0 = time.process_time()
    fh = firehose
    issuer_cmd = (fh.issuer.public.composite,)

    def issue_builder(marker: int):
        b = TransactionBuilder(notary=fh.notary)
        b.add_output_state(DummyMultiOwnerState(marker, fh.owners))
        b.add_command(Command(DummyCreate(), issuer_cmd))
        return b

    # Phase 1: BUILD. Object-graph construction only — the cross-shard
    # retry needs each issue's wire id (shard_of hashes the out-ref), which
    # the unsigned wire already carries; nothing here signs.
    issues: list = []  # builders, one record_transactions batch later
    entries: list = []  # (move_builder, route_ref, cross)
    for i in range(start, start + count):
        cross = bool(fh._cross_every) and i % fh._cross_every == 0
        first = issue_builder(i * 1_000_003)
        issues.append(first)
        refs = [first._wire_cached().out_ref(0)]
        if cross:
            fh.cross_requested += 1
            for attempt in range(1, 17):
                second = issue_builder(i * 1_000_003 + attempt)
                ref2 = second._wire_cached().out_ref(0)
                if fh.directory is None:
                    break
                from ..node.services.sharding import shard_of

                cnt = fh.directory[0]
                if shard_of(ref2.ref, cnt) != shard_of(refs[0].ref, cnt):
                    break  # spans two groups (expected ~n/(n-1) tries)
            issues.append(second)
            refs.append(ref2)
        move = TransactionBuilder(notary=fh.notary)
        for ref in refs:
            move.add_input_state(ref)
        move.add_command(Command(DummyMove(), fh.owners))
        move.add_output_state(DummyMultiOwnerState(i, fh.owners))
        entries.append((move, refs[0], cross))
    stats.build_s += time.perf_counter() - t0

    # Phase 2: SIGN. One columnar batch over issue jobs (1 sig each) and
    # move jobs (width sigs each) — the GIL-released native hot loop.
    t1 = time.perf_counter()
    builders = issues + [mv for mv, _, _ in entries]
    keysets = [(fh.issuer,)] * len(issues) + [fh.keys] * len(entries)
    signed = sign_builders(builders, keysets)
    fh.sigs_signed += signed
    stats.sigs_signed += signed
    stats.sign_s += time.perf_counter() - t1

    # Phase 3: RECORD + ASSEMBLE. Issue provenance lands in one
    # record_transactions call (one storage batch instead of `count`).
    issue_stxs = [b.to_signed_transaction() for b in issues]
    fh.flow.record_transactions(issue_stxs)
    out = []
    for move, route_ref, cross in entries:
        stx = move.to_signed_transaction(check_sufficient_signatures=False)
        out.append((stx, fh._route(route_ref), cross))
    stats.n_tx += count
    stats.prepare_s += time.perf_counter() - t0
    stats.cpu_s += time.process_time() - cpu0
    return out


def serialize_corpus(stxs, stats: "IngestStats | None" = None) -> bytes:
    """One codec pass: N SignedTransactions -> one multi-tx frame. Used
    for the pre-serialized corpus handoff to replay worker processes."""
    t0 = time.perf_counter()
    frame = pack_frame([serialize(stx).bytes for stx in stxs])
    if stats is not None:
        stats.serialize_s += time.perf_counter() - t0
    return frame


def deserialize_corpus(blob: bytes) -> list:
    """Inverse of serialize_corpus: the whole corpus or a loud reject."""
    return [deserialize(p) for p in unpack_frame(blob)]
