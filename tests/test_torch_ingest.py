"""The port's ingest plane (corda_tpu_torch/tools/ingest.py) against the
JAX package's (corda_tpu/tools/ingest.py).

The CTI1 multi-transaction frame must be byte-equal across the packages
for the same payloads and refuse the same damage with the same error;
``build_chunk_columnar`` over one seeded firehose (the same keys, issuer,
notary and markers) must give a byte-identical ``serialize_corpus`` blob
in both packages, and each package must read the other's blob back.
Tolerance everywhere: exact equality.
"""

import struct

import numpy as np
import pytest

import corda_tpu.testing.dummies  # noqa: F401  (registers the types)
import corda_tpu.transactions.signed  # noqa: F401
from corda_tpu.serialization import codec as jcodec
from corda_tpu.testing import identities as jidentities
from corda_tpu.tools import ingest as jingest
from corda_tpu_torch.serialization import codec
from corda_tpu_torch.testing import identities
from corda_tpu_torch.tools import ingest

PACKAGES = {"port": (ingest, codec, identities),
            "jax": (jingest, jcodec, jidentities)}


def _payloads(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 700, 12)
    return [b"", b"x", *(rng.integers(0, 256, int(n), dtype=np.uint8)
                         .tobytes() for n in sizes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_equal_jax(seed):
    payloads = _payloads(seed)
    frame = ingest.pack_frame(payloads)
    assert frame == jingest.pack_frame(payloads)
    assert ingest.unpack_frame(frame) == payloads
    assert jingest.unpack_frame(frame) == ingest.unpack_frame(frame)
    assert ingest.pack_frame([]) == jingest.pack_frame([])
    assert ingest.FRAME_MAGIC == jingest.FRAME_MAGIC == b"CTI1"
    assert ingest.MAX_FRAME_ENTRIES == jingest.MAX_FRAME_ENTRIES


def _damaged(mod):
    frame = mod.pack_frame([b"abc", b"defgh"])
    return {
        "bad magic": b"JUNK" + frame[4:],
        "empty": b"",
        "truncated body": frame[:-1],
        "truncated length": frame[:8 + 2],
        "count over entries": (mod.FRAME_MAGIC + struct.pack("<I", 2)
                               + frame[8:8 + 4 + 3]),
        "trailing junk": frame + b"!",
        "oversize count": (mod.FRAME_MAGIC
                           + struct.pack("<I", mod.MAX_FRAME_ENTRIES + 1)),
    }


@pytest.mark.parametrize("case", ["bad magic", "empty", "truncated body",
                                  "truncated length", "count over entries",
                                  "trailing junk", "oversize count"])
def test_damaged_frame_refused_alike(case):
    messages = {}
    for name, (mod, cod, _) in PACKAGES.items():
        with pytest.raises(cod.DeserializationError) as err:
            mod.unpack_frame(_damaged(mod)[case])
        messages[name] = str(err.value)
    assert messages["port"] == messages["jax"]


class _Flow:
    """The firehose's flow as build_chunk_columnar reads it: issuances
    are recorded, nothing else."""

    def __init__(self):
        self.recorded = []

    def record_transactions(self, stxs):
        self.recorded.extend(stxs)


class _Firehose:
    """loadgen._Firehose's fields that build_chunk_columnar reads, from
    seeded keys: the same identities in either package."""

    def __init__(self, ids, width: int, seed: int, cross_every: int = 0):
        self.flow = _Flow()
        self.keys = [ids.entropy_keypair(seed + 1 + i) for i in range(width)]
        self.owners = tuple(k.public.composite for k in self.keys)
        self.issuer = ids.entropy_keypair(seed)
        self.notary = ids.DUMMY_NOTARY
        self.directory = None
        self._cross_every = cross_every
        self.cross_requested = 0
        self.sigs_signed = 0

    def _route(self, state_and_ref):
        return None


def _corpus(pkg: str, width: int, seed: int, n: int, cross_every: int):
    mod, _, ids = PACKAGES[pkg]
    fh = _Firehose(ids, width, seed, cross_every)
    stats = mod.IngestStats()
    out = []
    for start in range(0, n, 7):  # chunked, as the firehose prepares
        out += mod.build_chunk_columnar(fh, start, min(7, n - start), stats)
    blob = mod.serialize_corpus([stx for stx, _, _ in out], stats)
    return blob, fh, stats, out


@pytest.mark.parametrize("width,cross_every", [(1, 0), (4, 0), (32, 0),
                                               (4, 3)])
def test_columnar_corpus_byte_identical_jax(width, cross_every):
    n = 20
    blob, fh, stats, out = _corpus("port", width, 9000 + width, n,
                                   cross_every)
    jblob, jfh, jstats, jout = _corpus("jax", width, 9000 + width, n,
                                       cross_every)
    assert blob == jblob
    assert len(ingest.unpack_frame(blob)) == n
    issues = n + (n + cross_every - 1) // cross_every if cross_every else n
    assert stats.n_tx == jstats.n_tx == n
    assert stats.sigs_signed == jstats.sigs_signed == issues + n * width
    assert fh.sigs_signed == jfh.sigs_signed == stats.sigs_signed
    assert fh.cross_requested == jfh.cross_requested
    assert [c for _, _, c in out] == [c for _, _, c in jout]
    assert [codec.serialize(s).bytes for s in fh.flow.recorded] == [
        jcodec.serialize(s).bytes for s in jfh.flow.recorded]
    assert stats.stamp().keys() == jstats.stamp().keys()


def test_corpus_reads_back_in_either_package():
    from corda_tpu_torch.crypto import provider

    blob, _, _, out = _corpus("port", 4, 777, 9, 0)
    mine = ingest.deserialize_corpus(blob)
    theirs = jingest.deserialize_corpus(blob)
    assert [codec.serialize(s).bytes for s in mine] == [
        jcodec.serialize(s).bytes for s in theirs] == [
        codec.serialize(s).bytes for s, _, _ in out]
    provider.set_verifier(provider.CpuVerifier())
    try:
        for stx in mine:
            stx.check_signatures_are_valid()
    finally:
        provider.set_verifier(None)


def test_columnar_signatures_equal_sign_with():
    """The columnar pass signs byte-identically to the per-transaction
    TransactionBuilder.sign_with loop it replaced."""
    from corda_tpu_torch.contracts.structures import Command
    from corda_tpu_torch.testing.dummies import (DummyCreate, DummyMove,
                                                 DummyMultiOwnerState)
    from corda_tpu_torch.transactions.builder import TransactionBuilder

    n, width = 5, 3
    blob, fh, _, _ = _corpus("port", width, 4242, n, 0)
    fresh = _Firehose(identities, width, 4242)
    stxs = []
    for i in range(n):
        issue = TransactionBuilder(notary=fresh.notary)
        issue.add_output_state(DummyMultiOwnerState(i * 1_000_003,
                                                    fresh.owners))
        issue.add_command(Command(DummyCreate(),
                                  (fresh.issuer.public.composite,)))
        move = TransactionBuilder(notary=fresh.notary)
        move.add_input_state(issue._wire_cached().out_ref(0))
        move.add_command(Command(DummyMove(), fresh.owners))
        move.add_output_state(DummyMultiOwnerState(i, fresh.owners))
        for key in fresh.keys:
            move.sign_with(key)
        stxs.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    assert ingest.serialize_corpus(stxs) == blob
