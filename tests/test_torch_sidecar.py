"""The port's verify sidecar: wire codec identical to the JAX package's, and
a CPU server answering the port's wire helpers and the JAX package's
SidecarVerifier (wire compatibility with the existing notary cluster).
The QoS lanes, the metrics op and adaptive coalescing are covered by
tests/test_torch_sidecar_qos.py, the port's own client by
tests/test_torch_verify_client.py. Exact comparisons.
"""

import socket
import struct

import pytest

from corda_tpu.crypto import provider as jprov
from corda_tpu.crypto import sidecar as jwire
from corda_tpu.node.verify_client import SidecarVerifier
from corda_tpu_torch.crypto import provider, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref


def _address(tmp_path, name: str) -> str:
    """A unix socket under tmp_path, or localhost TCP when that path would
    exceed the unix socket path limit."""
    path = str(tmp_path / name)
    return path if len(path) < 100 else "127.0.0.1:0"


def _signed(i: int, msg_len: int = 32):
    seed = bytes([i + 1]) * 32
    msg = bytes([i, 7]) * (msg_len // 2)
    return ref.public_key(seed), msg, ref.sign(seed, msg)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    address = _address(tmp_path_factory.mktemp("sc"), "s.sock")
    srv = sidecar.SidecarServer(address, device="cpu", coalesce_us=0,
                                max_sigs=64, device_min_sigs=0).start(
                                    warm=False)
    yield srv
    srv.stop()


def test_wire_constants_equal_jax():
    for name in ("OP_VERIFY", "OP_STATS", "OP_PING", "OP_VERIFY_QOS",
                 "OP_METRICS", "STATUS_OK", "STATUS_ERR", "MAX_FRAME",
                 "BUCKETS"):
        assert getattr(sidecar, name) == getattr(jwire, name), name
    for name in ("_FRAME_HDR", "_REQ_HDR", "_VERIFY_REQ_HDR", "_REPLY_HDR",
                 "_VERIFY_REPLY_HDR"):
        assert getattr(sidecar, name).format == getattr(jwire, name).format
    for n in (0, 1, 64, 65, 4096, 4097, 65536, 70000):
        assert sidecar.bucket_for(n) == jwire.bucket_for(n)
    for addr in ("/tmp/x.sock", "127.0.0.1:9000", ":9000", "host:1"):
        assert sidecar.parse_address(addr) == jwire.parse_address(addr)


def test_codec_byte_equal_to_jax():
    tuples = [_signed(i, msg_len=2 * i) for i in range(5)]
    ours = [provider.VerifyJob(*t) for t in tuples]
    theirs = [jprov.VerifyJob(*t) for t in tuples]
    payload = sidecar.encode_verify_request(77, ours)
    assert payload == jwire.encode_verify_request(77, theirs)
    req_id, decoded = sidecar.decode_verify_request(payload)
    j_req_id, j_decoded = jwire.decode_verify_request(payload)
    assert req_id == j_req_id == 77
    assert [(bytes(j.pubkey), bytes(j.message), bytes(j.sig))
            for j in decoded] == [(bytes(j.pubkey), bytes(j.message),
                                   bytes(j.sig)) for j in j_decoded]
    with pytest.raises(ValueError):
        sidecar.decode_verify_request(payload[:-3])


def test_frames_interoperate_with_jax():
    a, b = socket.socketpair()
    try:
        sidecar.send_frame(a, b"port->jax")
        assert jwire.recv_frame(b) == b"port->jax"
        jwire.send_frame(b, b"jax->port")
        assert sidecar.recv_frame(a) == b"jax->port"
        a.sendall(struct.pack("<I", sidecar.MAX_FRAME + 1))
        with pytest.raises(ConnectionError):
            sidecar.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_port_client_gets_oracle_answers(server):
    good = [_signed(i) for i in range(3)]
    pk, msg, sig = good[0]
    jobs = [provider.VerifyJob(*t) for t in good]
    jobs += [provider.VerifyJob(pk, msg, sig[:10] + bytes([sig[10] ^ 1])
                                + sig[11:]),          # tampered
             provider.VerifyJob(pk[:31], msg, sig),   # malformed key
             provider.VerifyJob(*_signed(5, msg_len=9))]  # host-hashed length
    got = sidecar.verify_remote(server.address, jobs)
    assert got.tolist() == [True, True, True, False, False, True]
    stats = sidecar.fetch_stats(server.address)
    assert stats["kernel_backend"] == "torch-cpu"
    assert stats["device_batches"] >= 1 and stats["requests"] >= 1
    assert stats["pad_lanes"] == 0


def test_jax_sidecar_verifier_gets_true_false(server):
    """The JAX package's notary-side client, unchanged, against this
    server: a signed tx id and its tampered copy."""
    pk, txid, sig = _signed(9)
    tampered = bytes([txid[0] ^ 1]) + txid[1:]
    client = SidecarVerifier(server.address, device_min_sigs=0,
                             deadline_ms=60_000)
    try:
        got = client.verify_batch([jprov.VerifyJob(pk, txid, sig),
                                   jprov.VerifyJob(pk, tampered, sig)])
        assert got.tolist() == [True, False]
        assert client.fallbacks == 0 and client.last_tier == "device"
        client.warm()  # OP_PING round trip
    finally:
        client._drop_connection()


def test_requests_coalesce_across_clients(tmp_path):
    """Two clients' requests inside one coalescing window ride one device
    batch; each gets its own slice of the answers."""
    import threading

    srv = sidecar.SidecarServer(_address(tmp_path, "c.sock"), device="cpu",
                                coalesce_us=1_500_000, max_sigs=4).start(
                                    warm=False)
    try:
        tuples = [_signed(i) for i in range(4)]
        bad = (tuples[3][0], tuples[3][1], bytes(64))
        reqs = [[tuples[0], tuples[1]], [tuples[2], bad]]
        out = [None, None]

        def run(k):
            out[k] = sidecar.verify_remote(
                srv.address, [provider.VerifyJob(*t) for t in reqs[k]]).tolist()

        threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert out == [[True, True], [True, False]]
        stats = srv.stats()
        assert stats["cross_request_batches"] == 1 and stats["batches"] == 1
        assert stats["batch_sigs_hist"] == {"64": 1}
    finally:
        srv.stop()


def test_cuda_default_raises_without_cuda(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sidecar.SidecarServer(str(tmp_path / "x.sock"))
    with pytest.raises(RuntimeError, match="cuda"):
        sidecar.main(["--socket", str(tmp_path / "y.sock")])


def test_cli_banner(tmp_path):
    import subprocess
    import sys

    address = _address(tmp_path, "cli.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "corda_tpu_torch.crypto.sidecar", "--socket",
         address, "--device", "cpu"], stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("sidecar up at ")
        bound = line[len("sidecar up at "):]
        assert bound == address or address.endswith(":0")
        pk, msg, sig = _signed(2)
        got = sidecar.verify_remote(bound, [provider.VerifyJob(pk, msg, sig)])
        assert got.tolist() == [True]
    finally:
        proc.terminate()
        proc.wait(30)
