"""The port's transaction layer against the JAX package's, byte for byte.

Transactions cross between the packages as their serialized bytes, so
every copied class must encode identically and register under the same
wire name (the codec strips each package's own prefix). Held here: equal
encodings of keys, parties, composite-key trees, the dummy states and
commands, WireTransaction and SignedTransaction in both directions; the
registries; the same rejections of non-canonical blobs; prime_ids' ids on
a JAX-made wave and its tampered-id error; and signature answers through
TorchVerifier(device="cpu") against the JAX CpuVerifier.
"""

import dataclasses

import pytest
import torch

import corda_tpu.crypto.provider as jprov
import corda_tpu.serialization.codec as jcodec
import corda_tpu.testing.dummies as jdum
from corda_tpu.crypto.composite import CompositeKey as JCompositeKey
from corda_tpu.crypto.hashes import SecureHash as JSecureHash
from corda_tpu.crypto.keys import DigitalSignature as JDigitalSignature
from corda_tpu.crypto.keys import KeyPair as JKeyPair
from corda_tpu.crypto.keys import SignatureError as JSignatureError
from corda_tpu.crypto.party import Party as JParty
from corda_tpu.transactions.signed import SignedTransaction as JSignedTransaction

import corda_tpu_torch.crypto.provider as tprov
import corda_tpu_torch.serialization.codec as tcodec
import corda_tpu_torch.testing.dummies as tdum
from corda_tpu_torch.crypto.composite import CompositeKey
from corda_tpu_torch.crypto.hashes import SecureHash
from corda_tpu_torch.crypto.keys import DigitalSignature, KeyPair, SignatureError
from corda_tpu_torch.crypto.party import Party
from corda_tpu_torch.transactions.signed import SignedTransaction
from corda_tpu_torch.transactions.wire import WireTransaction

# One set of constructors per package, so every case builds the same value
# in both from the same seeds.
JAX = dict(KeyPair=JKeyPair, Party=JParty, CompositeKey=JCompositeKey,
           SecureHash=JSecureHash, dummies=jdum, codec=jcodec)
PORT = dict(KeyPair=KeyPair, Party=Party, CompositeKey=CompositeKey,
            SecureHash=SecureHash, dummies=tdum, codec=tcodec)


def _keys(pkg, n=3):
    return [pkg["KeyPair"].generate(bytes([0x40 + i]) * 32) for i in range(n)]


def _tree(pkg):
    k = _keys(pkg)
    ck = pkg["CompositeKey"]
    inner = ck.Builder().add_keys(k[0].public, k[1].public).build(1)
    return ck.node(2, [inner, ck.leaf(k[2].public)], [1, 2])


def _wave(pkg, n_tx, outputs_per_tx=8, tamper=()):
    """bench.py's bench_resolve_ids wave: DummyContract.generate_initial plus
    outputs_per_tx - 1 more DummySingleOwnerState outputs, one signature a
    transaction; the signature of each index in ``tamper`` has a bit
    flipped (its id still matches)."""
    d = pkg["dummies"]
    notary = pkg["Party"].of("N", pkg["KeyPair"].generate(b"\x61" * 32).public)
    party = pkg["Party"].of("P", pkg["KeyPair"].generate(b"\x62" * 32).public)
    key = pkg["KeyPair"].generate(b"\x62" * 32)
    stxs = []
    for i in range(n_tx):
        b = d.DummyContract.generate_initial(
            party.ref(i.to_bytes(4, "big")), i, notary)
        for j in range(outputs_per_tx - 1):
            b.add_output_state(d.DummySingleOwnerState(
                i * 1000 + j, party.owning_key))
        b.sign_with(key)
        stx = b.to_signed_transaction(check_sufficient_signatures=False)
        if i in tamper:
            sig = stx.sigs[0]
            bad = bytearray(sig.bytes)
            bad[7] ^= 0x10
            stx = dataclasses.replace(stx, sigs=(type(sig)(
                bytes=bytes(bad), by=sig.by),))
        stxs.append(stx)
    return stxs


def _values(pkg):
    d = pkg["dummies"]
    k = _keys(pkg)
    party = pkg["Party"].of("Alice", k[0].public)
    tree = _tree(pkg)
    stx = _wave(pkg, 1)[0]
    return {
        "secure_hash": pkg["SecureHash"].sha256(b"leaf"),
        "public_key": k[1].public,
        "signature": k[1].sign(b"\x05" * 32),
        "party": party,
        "party_and_reference": party.ref(b"\x01\x02"),
        "composite_key_tree": tree,
        "single_owner_state": d.DummySingleOwnerState(7, tree),
        "multi_owner_state": d.DummyMultiOwnerState(
            9, (tree, k[2].public.composite)),
        "create_command": d.DummyCreate(),
        "move_command": d.DummyMove(),
        "wire_transaction": stx.tx,
        "signed_transaction": stx,
    }


CASES = sorted(_values(PORT))


@pytest.mark.parametrize("case", CASES)
def test_encodings_are_byte_equal_both_ways(case):
    jv, tv = _values(JAX)[case], _values(PORT)[case]
    jb, tb = jcodec.serialize(jv).bytes, tcodec.serialize(tv).bytes
    assert jb == tb
    # JAX bytes through the port and back, and the reverse.
    assert tcodec.serialize(tcodec.deserialize(jb)).bytes == jb
    assert jcodec.serialize(jcodec.deserialize(tb)).bytes == tb


def _registered_port_names():
    import corda_tpu_torch.transactions  # noqa: F401  (registers its types)

    return sorted(tcodec._BY_NAME)


@pytest.mark.parametrize("wire_name", _registered_port_names())
def test_wire_names_and_fields_match_the_jax_package(wire_name):
    tcls = tcodec._BY_NAME[wire_name]
    jcls = jcodec.class_for_wire_name(wire_name)
    assert jcls is not None, wire_name
    assert tcls.__qualname__ == jcls.__qualname__
    assert tcls.__module__ == "corda_tpu_torch." + wire_name.rsplit(
        ".", tcls.__qualname__.count(".") + 1)[0]
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert tcodec.wire_name_of(tcls) == jcodec.wire_name_of(jcls)


def test_port_registers_the_jax_core_set_on_import():
    # corda_tpu/__init__.py whitelists the core types through
    # serialization.wire; the port does the same in its own __init__.
    import corda_tpu.serialization.wire  # noqa: F401

    core = {n for n in jcodec._BY_NAME
            if n.startswith(("crypto.", "utils.", "serialization."))}
    assert core <= set(tcodec._BY_NAME)


NON_CANONICAL = {
    "non_minimal_varint": bytes([0x03, 0x80, 0x00]),
    "unsorted_dict": bytes([0x07, 0x02, 0x03, 0x04, 0x00, 0x03, 0x02, 0x00]),
    "duplicate_dict_key": bytes([0x07, 0x02, 0x03, 0x02, 0x00, 0x03, 0x02, 0x01]),
    "unsorted_frozenset": bytes([0x09, 0x02, 0x03, 0x04, 0x03, 0x02]),
    "negative_zero_float": bytes([0x0A, 0x80]) + bytes(7),
    "trailing_bytes": bytes([0x00, 0x00]),
    "unknown_tag": bytes([0x42]),
    "truncated_bytes": bytes([0x04, 0x05, 0x01]),
    "unregistered_type": bytes([0x08, 0x03]) + b"x.Y" + bytes([0x00]),
    "wrong_field_count": bytes([0x08, 24]) + b"crypto.hashes.SecureHash"
    + bytes([0x00]),
    "short_digest": bytes([0x08, 24]) + b"crypto.hashes.SecureHash"
    + bytes([0x01, 0x04, 0x01, 0xAA]),
}


@pytest.mark.parametrize("case", sorted(NON_CANONICAL))
def test_non_canonical_blobs_rejected_by_both(case):
    blob = NON_CANONICAL[case]
    with pytest.raises(jcodec.DeserializationError):
        jcodec.deserialize(blob)
    with pytest.raises(tcodec.DeserializationError):
        tcodec.deserialize(blob)


def test_port_built_wave_equals_the_jax_built_wave():
    # Deterministic Ed25519 signing: the same builder calls give the same
    # blobs, ids and signatures in both packages.
    jw, tw = _wave(JAX, 4), _wave(PORT, 4)
    assert [jcodec.serialize(s).bytes for s in jw] == \
        [tcodec.serialize(s).bytes for s in tw]
    assert [s.id.bytes for s in jw] == [s.id.bytes for s in tw]


@pytest.mark.parametrize("device_min,backend", [(10**9, "host"), (0, "device")])
def test_prime_ids_on_a_jax_made_wave(device_min, backend):
    jw = _wave(JAX, 64)
    blobs = [jcodec.serialize(s).bytes for s in jw]
    batch = [tcodec.deserialize(b) for b in blobs]
    got = SignedTransaction.prime_ids(batch, device_min=device_min,
                                      device="cpu")
    assert got == backend
    assert [s.tx.id.bytes for s in batch] == [s.id.bytes for s in jw]
    # The leaves were seeded by the bulk hash, not recomputed on touch.
    assert all(getattr(s.tx, "_leaves", None) is not None for s in batch)
    assert len(batch[0].tx.all_leaves_hashes) == 9
    assert [tcodec.serialize(s).bytes for s in batch] == blobs


@pytest.mark.parametrize("device_min", [10**9, 0])
def test_a_tampered_id_raises_the_jax_error(device_min):
    jw = _wave(JAX, 3)
    bad = dataclasses.replace(jw[0], id=jw[1].id)
    blobs = [jcodec.serialize(s).bytes for s in (jw[2], bad)]
    with pytest.raises(ValueError) as jerr:
        JSignedTransaction.prime_ids([jcodec.deserialize(b) for b in blobs],
                                     device_min=device_min)
    with pytest.raises(ValueError) as terr:
        SignedTransaction.prime_ids([tcodec.deserialize(b) for b in blobs],
                                    device_min=device_min, device="cpu")
    assert "does not match" in str(terr.value)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not match"):
        _ = tcodec.deserialize(blobs[1]).tx


@pytest.fixture
def verifiers():
    tprov.set_verifier(tprov.TorchVerifier(device="cpu", device_min_sigs=0))
    jprov.set_verifier(jprov.CpuVerifier())
    yield
    tprov.set_verifier(None)
    jprov.set_verifier(None)


def test_signature_answers_match_the_jax_cpu_verifier(verifiers):
    tamper = {1, 4}
    jw = _wave(JAX, 6, outputs_per_tx=2, tamper=tamper)
    blobs = [jcodec.serialize(s).bytes for s in jw]
    tw = [tcodec.deserialize(b) for b in blobs]
    SignedTransaction.prime_ids(tw, device_min=0, device="cpu")
    # The resolve path's shape: every signature of the wave in one batch.
    jobs = [tprov.VerifyJob(sig.by.encoded, s.id.bytes, sig.bytes)
            for s in tw for sig in s.sigs]
    got = tprov.get_verifier().verify_batch(jobs)
    want = jprov.get_verifier().verify_batch(
        [jprov.VerifyJob(j.pubkey, j.message, j.sig) for j in jobs])
    assert got.tolist() == want.tolist() == [i not in tamper for i in range(6)]
    # Per transaction, through check_signatures_are_valid.
    for i in (0, 1):
        if i in tamper:
            with pytest.raises(JSignatureError):
                jw[i].check_signatures_are_valid()
            with pytest.raises(SignatureError, match="did not match"):
                tw[i].check_signatures_are_valid()
        else:
            jw[i].check_signatures_are_valid()
            assert isinstance(tw[i].verify_signatures(), WireTransaction)


def test_default_verifier_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tprov.set_verifier(None)
    with pytest.raises(RuntimeError, match="cuda"):
        tprov.get_verifier()
    tprov.set_verifier(tprov.CpuVerifier())
    assert tprov.get_verifier().name == "cpu-openssl"
    tprov.set_verifier(None)


def test_signatures_are_outside_the_id():
    stx = _wave(PORT, 1)[0]
    extra = KeyPair.generate(b"\x07" * 32).sign(stx.id.bytes)
    more = stx + extra
    assert more.id == stx.id and len(more.sigs) == 2
    assert isinstance(more.sigs[1], DigitalSignature.WithKey)
    assert JDigitalSignature.WithKey.__qualname__ == \
        DigitalSignature.WithKey.__qualname__
