"""The port's Ed25519 verify path against the JAX package and the oracle.

The golden corpus of tests/test_ed25519_jax.py (valid signatures,
corruptions, S + L accepted, non-canonical A, non-canonical R rejected, an
invalid point, wrong lengths, a mixed large batch) goes through
corda_tpu_torch on the CPU (the plain PyTorch version of the verify
kernel) and through corda_tpu.ops.ed25519_jax.verify_arrays, and both are
held to the oracle. Every comparison is exact: accept masks and packed
words are integers. JAX compiles one bucket shape (64) only.
"""

import numpy as np
import pytest
import torch

from corda_tpu.crypto import ref_ed25519 as jref
from corda_tpu.crypto.provider import JaxVerifier
from corda_tpu.ops import ed25519_jax as jed
from corda_tpu_torch import ops
from corda_tpu_torch.crypto import provider
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import ed25519 as ted

BUCKET = 64
rng = np.random.default_rng(99)


def _keypair():
    seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    return seed, ref.public_key(seed)


def _flip(b: bytes, idx: int, bit: int = 1) -> bytes:
    out = bytearray(b)
    out[idx] ^= bit
    return bytes(out)


def _small_y_point():
    for y in range(19):
        x = ref._recover_x(y, 0)
        if x is not None:
            return (x, y)
    raise AssertionError("no small-y point")


def _corpus():
    """(pk, msg, sig) cases of tests/test_ed25519_jax.py:40-153."""
    cases = []
    for _ in range(8):  # valid, variable-length messages
        seed, pk = _keypair()
        msg = bytes(rng.integers(0, 256, int(rng.integers(0, 200)),
                                 dtype=np.uint8))
        cases.append((pk, msg, ref.sign(seed, msg)))
    seed, pk = _keypair()  # corruptions
    msg = b"notarise me"
    sig = ref.sign(seed, msg)
    cases += [(pk, msg, sig), (pk, msg + b"x", sig), (pk, msg, _flip(sig, 0)),
              (pk, msg, _flip(sig, 40)), (_flip(pk, 3), msg, sig),
              (pk, b"", sig), (pk, msg, _flip(sig, 63, 0x80))]
    seed, pk = _keypair()  # S + L: accepted (no range check)
    msg = b"malleable"
    sig = ref.sign(seed, msg)
    s2 = int.from_bytes(sig[32:], "little") + ref.L
    cases.append((pk, msg, sig[:32] + s2.to_bytes(32, "little")))
    pt = _small_y_point()  # non-canonical A
    enc = int.from_bytes(ref.compress(pt), "little")
    noncanon = (enc + ref.P).to_bytes(32, "little")
    cases += [(ref.compress(pt), b"m", bytes(64)), (noncanon, b"m", bytes(64))]
    seed, pk = _keypair()  # non-canonical R: rejected by the byte compare
    msg = b"R games"
    sig = ref.sign(seed, msg)
    cases.append((pk, msg, noncanon + sig[32:]))
    for y in range(2, 100):  # invalid point
        if ref._recover_x(y, 0) is None:
            seed, pk = _keypair()
            cases.append((y.to_bytes(32, "little"), b"x", ref.sign(seed, b"x")))
            break
    seed, pk = _keypair()  # wrong lengths
    sig = ref.sign(seed, b"len")
    cases += [(pk[:31], b"len", sig), (pk, b"len", sig[:63])]
    for i in range(40):  # mixed large batch
        seed, pk = _keypair()
        msg = bytes([i]) * (i % 7)
        sig = ref.sign(seed, msg)
        if i % 3 == 1:
            sig = _flip(sig, i % 64)
        if i % 5 == 2:
            msg = msg + b"!"
        cases.append((pk, msg, sig))
    return cases


CASES = _corpus()
WANT = [ref.verify(*c) for c in CASES]
GOOD = [i for i, c in enumerate(CASES) if len(c[0]) == 32 and len(c[2]) == 64]


def _cols(cases):
    return [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases]


def test_oracle_copy_agrees_with_jax_package_oracle():
    assert (ref.P, ref.L, ref.D, ref.B) == (jref.P, jref.L, jref.D, jref.B)
    assert WANT == [jref.verify(*c) for c in CASES]
    assert any(WANT) and not all(WANT)


def test_bucket_64_matches_jax_verify_arrays_and_oracle():
    pks, msgs, sigs = _cols([CASES[i] for i in GOOD])
    jarrays, n = jed.precompute_batch(pks, msgs, sigs, bucket=BUCKET)
    want_jax = np.asarray(jed.verify_arrays(*jarrays))
    got = ted.verify_arrays(*ted.from_jax_words(*jarrays, device="cpu"))
    assert got.dtype == torch.bool and got.shape == (BUCKET,)
    assert got.numpy().tolist() == want_jax.tolist()
    assert got[:n].tolist() == [WANT[i] for i in GOOD]
    assert ted.last_backend() == "torch-cpu"
    assert ops.last_backend_if_loaded() == "torch-cpu"


def test_ragged_batch_matches_oracle():
    # The port packs to the exact batch size (no bucket): N = len(CASES)
    # well-formed lanes, not a multiple of anything.
    got = ted.verify_batch(*_cols(CASES), device="cpu")
    assert len(GOOD) % 8 != 0
    assert got.tolist() == WANT


def test_device_hashed_path_matches_jax_and_oracle():
    cases = []
    for i in range(6):
        seed, pk = _keypair()
        msg = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = ref.sign(seed, msg)
        cases.append((pk, msg, sig if i % 2 else _flip(sig, 45)))
    pt = _small_y_point()
    noncanon = (int.from_bytes(ref.compress(pt), "little")
                + ref.P).to_bytes(32, "little")
    cases.append((noncanon, bytes(32), bytes(64)))
    jarrays, n = jed.precompute_batch_device(*_cols(cases), bucket=BUCKET)
    want_jax = np.asarray(jed.verify_arrays_hashed(*jarrays))
    got = ted.verify_arrays_hashed(*ted.from_jax_words(*jarrays, device="cpu"))
    assert got.numpy().tolist() == want_jax.tolist()
    assert got[:n].tolist() == [ref.verify(*c) for c in cases]


def test_packers_byte_equal_to_jax():
    pks, msgs, sigs = _cols([CASES[i] for i in GOOD])
    for bucket in (None, BUCKET, 70):
        (tw, tn), (jw, jn) = (ted.precompute_batch(pks, msgs, sigs, bucket),
                              jed.precompute_batch(pks, msgs, sigs, bucket))
        assert tn == jn
        for t, j in zip(tw, jw):
            assert t.dtype == np.uint32 and np.array_equal(t, np.asarray(j))
    tx = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in pks]
    for bucket in (None, BUCKET, 70):
        (tw, tn), (jw, jn) = (ted.precompute_batch_device(pks, tx, sigs, bucket),
                              jed.precompute_batch_device(pks, tx, sigs, bucket))
        assert tn == jn
        for t, j in zip(tw, jw):
            assert np.array_equal(t, np.asarray(j))


@pytest.mark.parametrize("mutate", ["lengths", "bucket", "pk", "msg", "sig",
                                    "pk_and_msg"])
def test_device_packer_rejects_like_jax(mutate, monkeypatch):
    monkeypatch.setattr(jed, "_CPACK_CACHE", [None])  # JAX's numpy packer
    pks, msgs, sigs = [], [], []
    for i in range(4):
        seed, pk = _keypair()
        m = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        pks.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(seed, m))
    bucket = 8
    if mutate == "lengths":
        pks = pks[:-1]
    elif mutate == "bucket":
        bucket = 2
    if mutate in ("pk", "pk_and_msg"):
        pks = [b"\x00" * 31] + pks[1:]
    if mutate in ("msg", "pk_and_msg"):
        msgs = [b"short"] + msgs[1:]
    if mutate == "sig":
        sigs = [b"\x00" * 63] + sigs[1:]
    with pytest.raises(ValueError) as want:
        jed.precompute_batch_device(pks, msgs, sigs, bucket=bucket)
    with pytest.raises(ValueError) as got:
        ted.precompute_batch_device(pks, msgs, sigs, bucket=bucket)
    assert str(got.value) == str(want.value)


def test_b_table_equals_jax():
    assert ted._B_TABLE.dtype == np.int32
    assert np.array_equal(ted._B_TABLE, jed._B_TABLE)


def test_from_jax_words_round_trip():
    jarrays, _ = jed.precompute_batch(*_cols([CASES[i] for i in GOOD]),
                                      bucket=BUCKET)
    tensors = ted.from_jax_words(*jarrays, device="cpu")
    for t, w in zip(tensors, jarrays):
        assert t.dtype == torch.int32 and t.shape == (8, BUCKET)
        assert np.array_equal(t.numpy().view(np.uint32), w)


def test_pick_bucket_and_eligibility_match_jax():
    for n in (0, 1, 64, 65, 1000, 65536, 65537, 200000):
        assert ted.pick_bucket(n) == jed.pick_bucket(n)
    for msgs in ([bytes(32)] * 3, [bytes(32), b"x"], []):
        assert ted.device_hash_eligible(msgs) == jed.device_hash_eligible(msgs)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk, msg, sig = CASES[0]
    with pytest.raises(RuntimeError, match="cuda"):
        ted.verify_batch([pk], [msg], [sig])  # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        ted.from_jax_words(*[np.zeros((8, 4), np.uint32)] * 4)
    with pytest.raises(RuntimeError, match="cuda"):
        provider.TorchVerifier()
    with pytest.raises(RuntimeError, match="cuda"):
        provider.make_verifier("torch")


def test_torch_verifier_cpu_matches_oracle_and_jax_verifier():
    # The ecdsa-p256 job carries an ed25519 key and signature: the JAX
    # package's host ECDSA path rejects it, and so must the port's.
    jobs = [provider.VerifyJob(*CASES[i]) for i in range(len(CASES))]
    jobs.append(provider.VerifyJob(CASES[0][0], CASES[0][1], CASES[0][2],
                                   scheme="ecdsa-p256"))
    v = provider.TorchVerifier(device="cpu", shadow_rate=0.2,
                               device_min_sigs=0)
    got = v.verify_batch(jobs)
    from corda_tpu.crypto.provider import VerifyJob as JaxJob

    jax_got = JaxVerifier(device_min_sigs=0).verify_batch(
        [JaxJob(*c) for c in CASES]
        + [JaxJob(CASES[0][0], CASES[0][1], CASES[0][2], scheme="ecdsa-p256")])
    assert got.tolist() == jax_got.tolist() == WANT + [False]
    assert (v.device_batches, v.host_batches) == (1, 0)
    assert v.kernel_backend == "torch-cpu"
    assert provider.OracleVerifier().verify_batch(jobs).tolist() == got.tolist()


def test_shadow_sampling_detects_divergence(monkeypatch):
    seed, pk = _keypair()
    msg = bytes(32)
    jobs = [provider.VerifyJob(pk, msg, ref.sign(seed, msg))]
    v = provider.TorchVerifier(device="cpu", shadow_rate=1.0,
                               device_min_sigs=0)
    assert v.verify_batch(jobs).tolist() == [True]
    monkeypatch.setattr(ted, "verify_arrays_hashed",
                        lambda *w: torch.zeros(w[0].shape[1], dtype=torch.bool))
    with pytest.raises(RuntimeError, match="divergence"):
        v.verify_batch(jobs)


def test_make_verifier_names():
    assert isinstance(provider.make_verifier("oracle"),
                      provider.OracleVerifier)
    v = provider.make_verifier("torch-shadow", device="cpu")
    assert isinstance(v, provider.TorchVerifier) and v.shadow_rate > 0
    assert isinstance(provider.make_verifier("cpu"), provider.CpuVerifier)
    with pytest.raises(ValueError, match="unknown verifier"):
        provider.make_verifier("jax")
    assert provider.TorchVerifier(device="cpu").verify_batch([]).tolist() == []
