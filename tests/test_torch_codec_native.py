"""The port's native codec core (corda_tpu_torch/native/_ccodec.c) against the
port's pure-Python codec, its semantic authority, and against the JAX
package's C core, on tests/test_native_codec.py's corpus and its hostile
inputs: byte-equal encodings, equal decoded values, and every mutated,
truncated or too-deep blob rejected by all three with DeserializationError
(the same message from both C cores). Exact comparisons.
"""

import random

import pytest

from corda_tpu.serialization import codec as jcodec
from corda_tpu_torch.serialization import codec


@pytest.fixture(scope="module")
def cores():
    if not codec._load_native() or not jcodec._load_native():
        pytest.skip("native codec unavailable here (no gcc or Python.h)")
    return codec._ccodec, jcodec._ccodec


def _decode_py(raw: bytes):
    value, pos = codec._decode(raw, 0)
    if pos != len(raw):
        raise codec.DeserializationError("trailing")
    return value


def _encode_py(v) -> bytes:
    out = bytearray()
    codec._encode(out, v)
    return bytes(out)


def _corpus(pkg):
    if pkg == "port":
        from corda_tpu_torch.crypto.hashes import SecureHash
        from corda_tpu_torch.crypto.keys import KeyPair
        from corda_tpu_torch.crypto.party import Party
        from corda_tpu_torch.testing.dummies import DummyContract
    else:
        from corda_tpu.crypto.hashes import SecureHash
        from corda_tpu.crypto.keys import KeyPair
        from corda_tpu.crypto.party import Party
        from corda_tpu.testing.dummies import DummyContract
    kp = KeyPair.generate(b"\x42" * 32)
    party = Party.of("P", kp.public)
    notary = Party.of("N", KeyPair.generate(b"\x43" * 32).public)
    builder = DummyContract.generate_initial(party.ref(b"\x01"), 7, notary)
    builder.sign_with(kp)
    stx = builder.to_signed_transaction(check_sufficient_signatures=False)
    return [
        None, True, False, 0, 1, -1, 63, 64, -64, -65, 2**63, -(2**63),
        2**255 - 19, -(2**200), 0.0, 1.5, -2.25, 1e300,
        b"", b"\x00" * 33, "", "ascii", "unié中",
        (), (1, (2, (3, (4,)))), {"a": 1, "zz": {"n": ()}},
        frozenset(), frozenset({1, "x", b"y"}),
        SecureHash.sha256(b"leaf"), party, stx,
    ]


def test_backend_is_native_and_entry_points_use_it(cores):
    core, _ = cores
    assert codec.codec_backend() == "native"
    stx = _corpus("port")[-1]
    raw = codec.serialize(stx).bytes
    assert raw == core.encode(stx)
    assert codec.deserialize(raw) == core.decode(raw) == stx


def test_backend_python_when_the_core_cannot_build(monkeypatch):
    monkeypatch.setattr(codec, "_ccodec", None)
    monkeypatch.setattr(codec, "_native_tried", True)
    assert codec.codec_backend() == "python"
    v = {"k": (1, b"x", frozenset({2}))}
    assert codec.deserialize(codec.serialize(v)) == v


def test_values_agree_with_pure_and_jax_core(cores):
    core, jcore = cores
    for v, jv in zip(_corpus("port"), _corpus("jax")):
        c_raw = core.encode(v)
        # Memoized types cache their encoding: clear it so the pure encoder
        # really re-encodes.
        if getattr(v, "_codec_enc", None) is not None:
            object.__setattr__(v, "_codec_enc", None)
        assert c_raw == _encode_py(v), type(v)
        # The wire names carry no package prefix: the JAX core encodes the
        # JAX package's twin of each value to the same bytes.
        assert c_raw == jcore.encode(jv), type(v)
        assert core.decode(c_raw) == _decode_py(c_raw) == v
        assert jcore.decode(c_raw) == jv


def _outcome(decode, raw):
    try:
        return "ok", decode(raw)
    except (codec.DeserializationError, jcodec.DeserializationError) as e:
        return "reject", str(e)


def test_mutation_fuzz_agreement(cores):
    core, jcore = cores
    rng = random.Random(11)
    corpus = [codec.serialize(v).bytes for v in _corpus("port")]
    checked = rejected = 0
    for raw in corpus:
        for _ in range(40):
            buf = bytearray(raw)
            op = rng.randrange(3)
            if op == 0 and buf:
                buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            elif op == 1 and len(buf) > 1:
                del buf[rng.randrange(len(buf))]
            else:
                buf.insert(rng.randrange(len(buf) + 1), rng.randrange(256))
            mutated = bytes(buf)
            py_kind, py_val = _outcome(_decode_py, mutated)
            c_kind, c_val = _outcome(core.decode, mutated)
            j_kind, j_val = _outcome(jcore.decode, mutated)
            assert py_kind == c_kind == j_kind, mutated.hex()
            if c_kind == "ok":
                assert py_val == c_val, mutated.hex()
            else:
                assert c_val == j_val, mutated.hex()  # the same message
                rejected += 1
            checked += 1
    assert checked >= 1000 and rejected > 100


def test_truncation_sweep_agreement(cores):
    core, jcore = cores
    for v in _corpus("port"):
        raw = codec.serialize(v).bytes
        for cut in range(len(raw)):
            prefix = raw[:cut]
            assert _outcome(_decode_py, prefix)[0] == "reject"
            kind, msg = _outcome(core.decode, prefix)
            assert kind == "reject"
            assert _outcome(jcore.decode, prefix) == ("reject", msg)


def test_deep_nesting_rejected_by_all(cores):
    core, jcore = cores
    raw = codec.serialize(1).bytes
    for _ in range(70):  # deeper than the codec's limit
        raw = bytes([0x06, 0x01]) + raw  # a list of one
    for decode in (_decode_py, core.decode, jcore.decode):
        kind, msg = _outcome(decode, raw)
        assert kind == "reject" and "deep" in msg


def test_trailing_bytes_rejected_by_both_entry_points(cores):
    raw = codec.serialize((1, 2)).bytes + b"\x00"
    with pytest.raises(codec.DeserializationError, match="trailing"):
        codec.deserialize(raw)
    with pytest.raises(codec.DeserializationError, match="trailing"):
        _decode_py(raw)
