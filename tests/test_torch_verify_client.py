"""The port's own sidecar client (corda_tpu_torch/node/verify_client.py):
against the port's server and against the JAX package's server, with the
oracle's answers; the JAX package's client sending OP_VERIFY_QOS to the
port's server (wire compatibility only); a dead server demoting the
client to its host tier (one fallback, oracle-exact answers) and the
re-probe reopening the gate once a server answers again. Exact
comparisons.
"""

import time

import pytest

from corda_tpu.crypto import provider as jprov
from corda_tpu.crypto import sidecar as jwire
from corda_tpu.node import verify_client as jclient
from corda_tpu.obs import export as jexport
from corda_tpu_torch.crypto import provider, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.node import verify_client as client
from corda_tpu_torch.obs import export


def _address(tmp_path, name: str) -> str:
    path = str(tmp_path / name)
    return path if len(path) < 100 else "127.0.0.1:0"


def _tuples(n: int, tamper=()):
    out = []
    for i in range(n):
        seed = bytes([i % 9 + 1]) * 32
        msg = bytes([i % 9, 5]) * 16
        sig = ref.sign(seed, msg)
        if i in tamper:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        out.append((ref.public_key(seed), msg, sig))
    return out


def _oracle(tuples):
    return [ref.verify(*t) for t in tuples]


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    address = _address(tmp_path_factory.mktemp("vc"), "p.sock")
    srv = sidecar.SidecarServer(address, device="cpu", coalesce_us=0,
                                max_sigs=4096, device_min_sigs=0).start(
                                    warm=False)
    yield srv
    srv.stop()


def test_defaults_equal_jax_and_come_from_the_constructor(monkeypatch):
    """The constructor's crossover wins; without one both packages read
    CORDA_TPU_SIDECAR_MIN_SIGS (the autotuner's env knob), else 16."""
    assert client.SIDECAR_MIN_SIGS_DEFAULT == jclient.SIDECAR_MIN_SIGS_DEFAULT
    monkeypatch.delenv("CORDA_TPU_SIDECAR_MIN_SIGS", raising=False)
    assert client.SidecarVerifier("/tmp/none.sock").device_min_sigs == 16
    monkeypatch.setenv("CORDA_TPU_SIDECAR_MIN_SIGS", "3")
    assert client.SidecarVerifier("/tmp/none.sock").device_min_sigs == \
        jclient.SidecarVerifier("/tmp/none.sock").device_min_sigs == 3
    assert client.SidecarVerifier("/tmp/none.sock",
                                  device_min_sigs=5).device_min_sigs == 5
    assert client.SidecarVerifier.name == jclient.SidecarVerifier.name


def test_port_client_against_port_server(port_server):
    tuples = _tuples(40, tamper={2, 31})
    jobs = [provider.VerifyJob(*t) for t in tuples]
    jobs.append(provider.VerifyJob(tuples[0][0][:31], *tuples[0][1:]))
    v = client.SidecarVerifier(port_server.address, device_min_sigs=16,
                               deadline_ms=60_000)
    try:
        got = v.verify_batch(jobs)
        assert got.tolist() == _oracle(tuples) + [False]
        assert (v.device_batches, v.host_batches, v.fallbacks) == (1, 0, 0)
        assert v.last_tier == "device" and v.sidecar_sigs == 40
        assert v.last_wait_s >= 0 and v.last_verify_s >= 0
        # Under the crossover: the host tier answers, no round trip.
        small = v.verify_batch(jobs[:5])
        assert small.tolist() == _oracle(tuples[:5])
        assert (v.device_batches, v.host_batches) == (1, 1)
        v.warm()  # OP_PING
        stats = v.sidecar_stats()
        assert stats["server"]["kernel_backend"] == "torch-cpu"
        assert stats["batches"] == 1 and stats["fallbacks"] == 0
        assert stats["gate_open"] is None
    finally:
        v.close()


def test_port_client_qos_hint_rides_op_verify_qos(port_server):
    tuples = _tuples(20, tamper={7})
    v = client.SidecarVerifier(port_server.address, device_min_sigs=0,
                               deadline_ms=60_000)
    before = port_server.stats()
    try:
        v.qos_hint = (sidecar.LANE_CODE_INTERACTIVE,
                      time.time_ns() + 10**9)
        got = v.verify_batch([provider.VerifyJob(*t) for t in tuples])
        assert got.tolist() == _oracle(tuples)
        v.qos_hint = (sidecar.LANE_CODE_BULK, 0)
        got = v.verify_batch([provider.VerifyJob(*t) for t in tuples])
        assert got.tolist() == _oracle(tuples)
    finally:
        v.close()
    after = port_server.stats()
    assert after["qos_interactive_requests"] == \
        before["qos_interactive_requests"] + 1
    assert after["qos_bulk_requests"] == before["qos_bulk_requests"] + 1


def test_port_client_against_jax_server(tmp_path):
    srv = jwire.SidecarServer(_address(tmp_path, "j.sock"),
                              verifier=jprov.CpuVerifier(),
                              coalesce_us=0).start()
    tuples = _tuples(24, tamper={0, 23})
    v = client.SidecarVerifier(srv.address, device_min_sigs=0,
                               deadline_ms=60_000)
    try:
        got = v.verify_batch([provider.VerifyJob(*t) for t in tuples])
        assert got.tolist() == _oracle(tuples)
        v.qos_hint = (sidecar.LANE_CODE_INTERACTIVE, time.time_ns() + 10**9)
        got = v.verify_batch([provider.VerifyJob(*t) for t in tuples])
        assert got.tolist() == _oracle(tuples)
        assert v.fallbacks == 0 and v.device_batches == 2
        assert client.fetch_sidecar_stats(srv.address)[
            "qos_interactive_requests"] == 1
    finally:
        v.close()
        srv.stop()


def test_jax_client_op_verify_qos_against_port_server(port_server):
    tuples = _tuples(18, tamper={5})
    v = jclient.SidecarVerifier(port_server.address, device_min_sigs=0,
                                deadline_ms=60_000)
    before = port_server.stats()["qos_interactive_requests"]
    try:
        v.qos_hint = (jwire.LANE_CODE_INTERACTIVE, time.time_ns() + 10**9)
        got = v.verify_batch([jprov.VerifyJob(*t) for t in tuples])
        assert got.tolist() == _oracle(tuples)
        assert v.fallbacks == 0 and v.last_tier == "device"
    finally:
        v._drop_connection()
    assert port_server.stats()["qos_interactive_requests"] == before + 1


def test_metrics_fetch_from_the_port_server(port_server):
    # Nothing else talks to the server meanwhile, and OP_METRICS counts
    # nothing itself: both packages' fetchers read the same text.
    text = export.fetch_sidecar_metrics(port_server.address)
    assert text == jexport.fetch_sidecar_metrics(port_server.address)
    parsed = export.parse_prometheus(text)
    assert parsed == jexport.parse_prometheus(text)
    assert "sidecar_sigs_total" in parsed["counters"]
    with pytest.raises(client.SidecarError):
        export.fetch_sidecar_metrics("/tmp/nobody-here.sock", timeout=1.0)


def test_dead_server_falls_back_once_then_reprobe_reopens(tmp_path):
    address = _address(tmp_path, "d.sock")
    srv = sidecar.SidecarServer(address, verifier=provider.CpuVerifier(),
                                coalesce_us=0).start()
    address = srv.address
    tuples = _tuples(32, tamper={3, 30})
    jobs = [provider.VerifyJob(*t) for t in tuples]
    v = client.SidecarVerifier(address, device_min_sigs=0,
                               deadline_ms=60_000, reprobe_cooldown_s=0.05)
    try:
        assert v.verify_batch(jobs).tolist() == _oracle(tuples)
        srv.stop()
        got = v.verify_batch(jobs)  # the server is gone: the host tier
        assert got.tolist() == _oracle(tuples)
        assert v.fallbacks == 1 and v.degraded == 1
        assert v.host_batches == 1 and v.device_batches == 1
        assert not v.device_gate.is_set()
        assert v.verify_batch(jobs).tolist() == _oracle(tuples)
        assert v.fallbacks == 1 and v.host_batches == 2  # gate closed
        srv = sidecar.SidecarServer(address, verifier=provider.CpuVerifier(),
                                    coalesce_us=0).start()
        deadline = time.monotonic() + 60
        while not v.device_gate.is_set():
            assert time.monotonic() < deadline, "the re-probe never reopened"
            time.sleep(0.01)
        assert v.reprobes_ok == 1
        assert v.verify_batch(jobs).tolist() == _oracle(tuples)
        assert v.device_batches == 2 and v.fallbacks == 1
    finally:
        v.close()
        srv.stop()


def test_fetch_stats_of_a_dead_server_raises_sidecar_error(tmp_path):
    with pytest.raises(client.SidecarError):
        client.fetch_sidecar_stats(str(tmp_path / "nobody.sock"),
                                   timeout=1.0)
    v = client.SidecarVerifier(str(tmp_path / "nobody.sock"))
    assert v.sidecar_stats()["server"] is None
    with pytest.raises(client.SidecarError):
        v.warm()
