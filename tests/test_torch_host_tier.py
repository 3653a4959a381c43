"""The port's host tier and routing against the JAX package's.

CpuVerifier (native accept-fast, rejects re-checked through fast_ed25519
and the oracle), the mixed-scheme split, the size crossover, the device
gate with degrade_device and its re-probe, and the sidecar's tier byte,
each held to the JAX package's answers and counters and to the oracle.
Every comparison is exact.
"""

import threading
import time

import numpy as np
import pytest

from corda_tpu.crypto import fast_ecdsa_p256 as jfast_ecdsa
from corda_tpu.crypto import fast_ed25519 as jfast
from corda_tpu.crypto import provider as jprov
from corda_tpu.crypto import ref_ecdsa_p256 as jref_ecdsa
from corda_tpu_torch.crypto import fast_ecdsa_p256, fast_ed25519, provider
from corda_tpu_torch.crypto import ref_ecdsa_p256, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref


def _ed(i, msg_len=32):
    seed = bytes([i + 1]) * 32
    msg = (b"m%d" % i).ljust(msg_len, b".")[:msg_len]
    return ref.public_key(seed), msg, ref.sign(seed, msg)


def _ecdsa():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)

    key = ec.derive_private_key(0x1234, ec.SECP256R1())
    pub = key.public_key().public_bytes(Encoding.X962,
                                        PublicFormat.UncompressedPoint)
    msg = b"tls-handshake-blob"
    return pub, msg, key.sign(msg, ec.ECDSA(hashes.SHA256()))


def _corpus():
    """(pk, msg, sig, scheme): valid ed25519 over tx ids and other lengths,
    S + L and S | 2^255, tampered, malformed lengths, ecdsa-p256 valid and
    tampered and crossed, and an unknown scheme."""
    cases = [(*_ed(i), "ed25519") for i in range(4)]
    cases.append((*_ed(4, msg_len=7), "ed25519"))
    pk, msg, sig = _ed(5)
    s = int.from_bytes(sig[32:], "little")
    cases += [
        (pk, msg, sig[:32] + (s + ref.L).to_bytes(32, "little"), "ed25519"),
        (pk, msg, sig[:63] + bytes([sig[63] | 0x80]), "ed25519"),
        (pk, msg, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], "ed25519"),
        (pk[:31], msg, sig, "ed25519"),
        (pk, msg, sig[:63], "ed25519"),
        (pk, msg, sig, "rsa-4096"),
    ]
    ec_pub, ec_msg, ec_sig = _ecdsa()
    cases += [(ec_pub, ec_msg, ec_sig, "ecdsa-p256"),
              (ec_pub, b"other", ec_sig, "ecdsa-p256"),
              (ec_pub, ec_msg, sig, "ecdsa-p256"),
              (pk, msg, ec_sig, "ed25519")]
    return cases


def _jobs(cases, mod=provider):
    return [mod.VerifyJob(pk, m, s, scheme=sc) for pk, m, s, sc in cases]


def test_copies_equal_their_originals():
    assert (ref_ecdsa_p256.P, ref_ecdsa_p256.N, ref_ecdsa_p256.GX) == (
        jref_ecdsa.P, jref_ecdsa.N, jref_ecdsa.GX)
    assert fast_ed25519.available() == jfast.available()
    assert fast_ecdsa_p256.available() == jfast_ecdsa.available()
    seed = bytes(range(32))
    assert fast_ed25519.public_key(seed) == jfast.public_key(seed)
    assert fast_ed25519.sign(seed, b"x") == jfast.sign(seed, b"x")
    for pk, m, s, sc in _corpus():
        fn, jfn = ((fast_ed25519.verify, jfast.verify) if sc == "ed25519"
                   else (fast_ecdsa_p256.verify, jfast_ecdsa.verify))
        assert fn(pk, m, s) == jfn(pk, m, s)


def test_cpu_verifier_equals_jax_cpu_verifier_and_the_oracle():
    cases = _corpus()
    got = provider.CpuVerifier().verify_batch(_jobs(cases))
    want = jprov.CpuVerifier().verify_batch(_jobs(cases, jprov))
    oracle = provider.OracleVerifier().verify_batch(_jobs(cases))
    jax_oracle = jprov.OracleVerifier().verify_batch(_jobs(cases, jprov))
    assert got.tolist() == want.tolist() == oracle.tolist() \
        == jax_oracle.tolist()
    # S + L verifies (no range check), S | 2^255 does not
    assert got.tolist() == [True] * 5 + [True, False] + [False] * 4 \
        + [True] + [False] * 3
    assert provider.make_verifier("cpu").verify_batch([]).tolist() == []


def test_cpu_verifier_without_the_native_core(monkeypatch):
    from corda_tpu_torch import native

    monkeypatch.setattr(native, "load_cverify", lambda: None)
    cases = _corpus()
    want = provider.OracleVerifier().verify_batch(_jobs(cases))
    assert provider.CpuVerifier().verify_batch(_jobs(cases)).tolist() \
        == want.tolist()


def test_device_min_sigs_default_and_env(monkeypatch):
    """The port's crossover is the one measured on an H100 (4), set only
    through the constructor; the JAX package's environment knob does not
    reach it."""
    assert provider.DEVICE_MIN_SIGS_DEFAULT == 4
    monkeypatch.setenv("CORDA_TPU_DEVICE_MIN_SIGS", "7")
    assert provider.TorchVerifier(device="cpu").device_min_sigs == 4
    assert provider.TorchVerifier(device="cpu",
                                  device_min_sigs=3).device_min_sigs == 3
    jobs = _routing_jobs(provider)
    v = provider.TorchVerifier(device="cpu")
    assert v.verify_batch(jobs[:3]).tolist() == [True] * 3
    assert v.verify_batch(jobs[:4]).tolist() == [True] * 4
    assert (v.host_batches, v.device_batches) == (1, 1)


def _routing_jobs(mod):
    jobs = []
    for i in range(8):
        pk, msg, sig = _ed(i)
        if i == 5:
            sig = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        jobs.append(mod.VerifyJob(pk, msg, sig))
    return jobs


def test_size_crossover_routes_like_jax():
    """tests/test_crypto_host.py's crossover test, on the port: under
    device_min_sigs the host tier, at it the device path (the plain
    versions here); same verdicts, every batch counted."""
    want = [i != 5 for i in range(8)]
    jobs, jjobs = _routing_jobs(provider), _routing_jobs(jprov)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=8)
    jv = jprov.JaxVerifier(device_min_sigs=8)
    for batch, jbatch in ((jobs[:3], jjobs[:3]), (jobs, jjobs)):
        assert v.verify_batch(batch).tolist() \
            == jv.verify_batch(jbatch).tolist() == want[:len(batch)]
        assert (v.host_batches, v.device_batches) == (
            jv.host_batches, jv.device_batches)
    assert (v.host_batches, v.device_batches) == (1, 1)

    always = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    assert always.verify_batch(jobs[:3]).tolist() == want[:3]
    assert (always.host_batches, always.device_batches) == (0, 1)


def test_pack_device_returns_none_where_the_routing_says_host():
    jobs = _routing_jobs(provider)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=4)
    assert v.pack_device([]) is None
    assert v.pack_device(jobs[:3]) is None                  # under crossover
    mixed = jobs[:4] + [provider.VerifyJob(*_ed(9), scheme="ecdsa-p256")]
    assert v.pack_device(mixed) is None                     # mixed schemes
    bad = [provider.VerifyJob(j.pubkey[:31], j.message, j.sig)
           for j in jobs]
    assert v.pack_device(bad) is None                       # none well-formed
    v.device_gate = threading.Event()
    assert v.pack_device(jobs) is None                      # gate closed
    v.device_gate.set()
    packed = v.pack_device(jobs + bad[:1])
    assert packed is not None and packed.n == 8
    assert v.verify_packed(packed).tolist() == [i != 5 for i in range(8)] \
        + [False]
    assert (v.host_batches, v.device_batches) == (0, 1)


class FlakyDevice(provider.DeviceRoutedVerifier):
    """A device tier that raises ``fail_times`` times, then answers."""

    name = "flaky"

    def __init__(self, fail_times, **kw):
        super().__init__(**kw)
        self.fail_times = fail_times
        self.device_calls = 0

    def _verify_ed25519_device(self, jobs):
        self.device_calls += 1
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("device down (test)")
        return np.zeros(len(jobs), dtype=bool)


def _wait_gate(v, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not v.device_gate.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    return v.device_gate.is_set()


def test_degrade_device_gates_then_reprobes_back():
    """tests/test_chaos_recovery.py's degrade test, on the port."""
    v = FlakyDevice(fail_times=1, device_min_sigs=4)
    assert provider.degrade_device(v, cooldown_s=0.25) is True
    assert v.degraded == 1 and not v.device_gate.is_set()
    jobs = [provider.VerifyJob(bytes(32), bytes(32), bytes(64))] * 8
    v.verify_batch(jobs)
    assert v.host_batches == 1 and v.device_calls == 0
    assert _wait_gate(v), "re-probe never reopened the gate"
    assert (v.reprobes_failed, v.reprobes_ok) == (1, 1)
    before = v.device_calls
    v.verify_batch(jobs)
    assert v.device_calls == before + 1 and v.device_batches == 1


def test_degrade_device_noop_without_device_tier_and_repeat_only_counts():
    assert provider.degrade_device(provider.CpuVerifier(),
                                   cooldown_s=0.01) is False
    v = FlakyDevice(fail_times=10_000, device_min_sigs=4)
    assert provider.degrade_device(v, cooldown_s=30.0) is True
    first = v._reprobe_thread
    assert provider.degrade_device(v, cooldown_s=30.0) is True
    assert v.degraded == 2 and v._reprobe_thread is first


def test_degraded_torch_verifier_answers_on_host_then_reopens():
    """A real TorchVerifier: degraded, a batch at the crossover takes the
    host tier with the oracle's answers; the re-probe runs the real device
    path (plain versions here) and reopens the gate; the next batch is a
    device batch with the same answers."""
    jobs = _routing_jobs(provider)
    want = [i != 5 for i in range(8)]
    v = provider.TorchVerifier(device="cpu", device_min_sigs=2)
    assert provider.degrade_device(v, cooldown_s=0.2)
    assert v.verify_batch(jobs).tolist() == want
    assert (v.host_batches, v.device_batches) == (1, 0)
    assert _wait_gate(v, timeout=120.0)
    assert v.reprobes_ok == 1 and v.reprobes_failed == 0
    assert v.verify_batch(jobs).tolist() == want
    assert (v.host_batches, v.device_batches) == (1, 1)


def _tier_of(address, jobs, req_id):
    sock = sidecar.connect(address, timeout=60)
    try:
        sidecar.send_frame(sock, sidecar.encode_verify_request(req_id, jobs))
        reply = sidecar.recv_frame(sock)
    finally:
        sock.close()
    op, rid, status, tier, _w, _v = sidecar._VERIFY_REPLY_HDR.unpack_from(
        reply)
    assert (op, rid, status) == (sidecar.OP_VERIFY, req_id, sidecar.STATUS_OK)
    body = reply[sidecar._VERIFY_REPLY_HDR.size:]
    return tier, np.frombuffer(body, np.uint8).astype(bool).tolist()


def test_sidecar_answers_a_host_routed_request_with_tier_0(tmp_path):
    path = str(tmp_path / "h.sock")
    address = path if len(path) < 100 else "127.0.0.1:0"
    srv = sidecar.SidecarServer(address, device="cpu", coalesce_us=0,
                                max_sigs=64, device_min_sigs=8).start(
                                    warm=False)
    try:
        jobs = _routing_jobs(provider)
        want = [i != 5 for i in range(8)]
        assert _tier_of(srv.address, jobs[:3], 1) == (0, want[:3])
        stats = srv.stats()
        assert (stats["host_batches"], stats["device_batches"]) == (1, 0)
        assert stats["device_min_sigs"] == 8 and stats["packed_batches"] == 0
        assert _tier_of(srv.address, jobs, 2) == (1, want)
        stats = srv.stats()
        assert (stats["host_batches"], stats["device_batches"]) == (1, 1)
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="device_min_sigs"):
        sidecar.SidecarServer(address, verifier=provider.CpuVerifier(),
                              device_min_sigs=8)
