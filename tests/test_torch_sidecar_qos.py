"""The port's sidecar QoS lanes, metrics op and adaptive coalescing, held to
the JAX package's server (corda_tpu/crypto/sidecar.py): the same
interactive-first batch cuts on seeded pending sets, the same adaptive
coalesce_us trajectory on one batch sequence, the deadline flush, and
OP_VERIFY_QOS / OP_METRICS served over the wire with oracle answers.
Exact comparisons; no test depends on a wall-clock budget (a missing
deadline flush shows as a stalled reply, not as a slow one).
"""

import random
import time

import numpy as np
import pytest

from corda_tpu.crypto import provider as jprov
from corda_tpu.crypto import sidecar as jwire
from corda_tpu_torch.crypto import provider, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.obs import export, telemetry


def _address(tmp_path, name: str) -> str:
    path = str(tmp_path / name)
    return path if len(path) < 100 else "127.0.0.1:0"


def _signed(i: int, msg_len: int = 32):
    seed = bytes([i + 1]) * 32
    msg = bytes([i, 3]) * (msg_len // 2)
    return ref.public_key(seed), msg, ref.sign(seed, msg)


def _jobs(n: int, tamper=()):
    out = []
    for i in range(n):
        pk, msg, sig = _signed(i % 7)
        if i in tamper:
            sig = sig[:20] + bytes([sig[20] ^ 1]) + sig[21:]
        out.append(provider.VerifyJob(pk, msg, sig))
    return out


def _oracle(jobs):
    return [ref.verify(j.pubkey, j.message, j.sig) for j in jobs]


def _unstarted(mod, prov, **kw):
    # The constructor binds nothing; start() is never called.
    return mod.SidecarServer("/tmp/unused-qos.sock",
                             verifier=prov.CpuVerifier(), **kw)


def test_wire_constants_and_qos_codec_equal_jax():
    assert (sidecar.LANE_CODE_INTERACTIVE, sidecar.LANE_CODE_BULK) == (
        jwire.LANE_CODE_INTERACTIVE, jwire.LANE_CODE_BULK)
    assert sidecar._VERIFY_QOS_REQ_HDR.format == \
        jwire._VERIFY_QOS_REQ_HDR.format
    for name in ("ADAPT_WINDOW", "ADAPT_GROW", "ADAPT_SHRINK",
                 "ADAPT_SEED_US", "ADAPT_CEILING_US"):
        assert getattr(sidecar, name) == getattr(jwire, name), name
    tuples = [_signed(i, msg_len=2 * i) for i in range(4)]
    deadline = time.time_ns() + 50_000_000
    payload = sidecar.encode_verify_request_qos(
        9, [provider.VerifyJob(*t) for t in tuples],
        sidecar.LANE_CODE_INTERACTIVE, deadline)
    assert payload == jwire.encode_verify_request_qos(
        9, [jprov.VerifyJob(*t) for t in tuples],
        jwire.LANE_CODE_INTERACTIVE, deadline)
    req_id, jobs, lane, dl = sidecar.decode_verify_request_qos(payload)
    assert (req_id, lane, dl) == (9, sidecar.LANE_CODE_INTERACTIVE, deadline)
    assert [(j.pubkey, j.message, j.sig) for j in jobs] == tuples
    bad = bytearray(payload)
    bad[sidecar._VERIFY_REQ_HDR.size] = 7  # an unknown lane code
    with pytest.raises(ValueError, match="lane"):
        sidecar.decode_verify_request_qos(bytes(bad))
    with pytest.raises(ValueError):
        jwire.decode_verify_request_qos(bytes(bad))


def _seeded_pending(mod, kind: str, seed: int):
    rng = random.Random(seed)
    lanes = {"bulk": [mod.LANE_CODE_BULK],
             "interactive": [mod.LANE_CODE_INTERACTIVE],
             "mixed": [None, mod.LANE_CODE_INTERACTIVE, mod.LANE_CODE_BULK]}
    out = []
    for req_id in range(40):
        n = rng.randrange(1, 300)
        lane = rng.choice(lanes[kind])
        out.append(mod._Pending(None, req_id, [None] * n, lane=lane,
                                deadline_ns=rng.randrange(0, 10**9)))
    return out


def _cuts(mod, prov, kind, seed, max_sigs):
    srv = _unstarted(mod, prov, max_sigs=max_sigs)
    srv._pending.extend(_seeded_pending(mod, kind, seed))
    cuts = []
    while srv._pending:
        dl = srv._min_interactive_deadline_ns()
        batch = srv._form_batch()
        if mod is jwire:  # the reference also returns a flag nothing reads
            batch = batch[0]
        cuts.append(([p.req_id for p in batch], dl))
    return cuts


@pytest.mark.parametrize("kind", ["bulk", "interactive", "mixed"])
@pytest.mark.parametrize("seed,max_sigs", [(1, 256), (2, 1024), (3, 4096)])
def test_form_batch_order_equal_jax(kind, seed, max_sigs):
    ours = _cuts(sidecar, provider, kind, seed, max_sigs)
    theirs = _cuts(jwire, jprov, kind, seed, max_sigs)
    assert ours == theirs
    # Every request is cut exactly once; with no bulk waiting the order is
    # the arrival order.
    assert sorted(r for ids, _ in ours for r in ids) == list(range(40))
    if kind == "interactive":
        assert [r for ids, _ in ours for r in ids] == list(range(40))


def test_form_batch_interactive_first_then_bulk_in_arrival_order():
    srv = _unstarted(sidecar, provider, max_sigs=2)
    b1 = sidecar._Pending(None, 1, [None], lane=sidecar.LANE_CODE_BULK)
    i1 = sidecar._Pending(None, 2, [None], lane=sidecar.LANE_CODE_INTERACTIVE)
    b2 = sidecar._Pending(None, 3, [None], lane=sidecar.LANE_CODE_BULK)
    i2 = sidecar._Pending(None, 4, [None], lane=sidecar.LANE_CODE_INTERACTIVE)
    srv._pending.extend([b1, i1, b2, i2])
    assert srv._form_batch() == [i1, i2]
    assert srv._form_batch() == [b1, b2]


def _trajectory(mod, prov, coalesce_us, max_sigs, seq):
    srv = _unstarted(mod, prov, coalesce_us=coalesce_us, max_sigs=max_sigs,
                     adaptive_coalesce=True)
    out = []
    for n_requests, n_sigs in seq:
        with srv._lock:
            srv._adapt_observe(n_requests, n_sigs)
        out.append(srv.coalesce_us)
    return out, srv


@pytest.mark.parametrize("coalesce_us,max_sigs", [(0, 4096), (2000, 16384),
                                                  (19_000, 1024)])
def test_adapt_observe_trajectory_equal_jax(coalesce_us, max_sigs):
    # Phases of small coalescing batches (grow), full ones (shrink), lone
    # small ones and mid-size ones (no change), in seeded turns.
    rng = random.Random(coalesce_us + max_sigs)
    phases = [lambda: (rng.randrange(2, 5), rng.randrange(1, max_sigs // 8)),
              lambda: (rng.randrange(1, 5),
                       rng.randrange(max_sigs // 2, max_sigs + 1)),
              lambda: (1, rng.randrange(1, max_sigs // 8)),
              lambda: (rng.randrange(1, 5), rng.randrange(
                  max_sigs // 4 + 1, max_sigs // 2))]
    seq = []
    for _ in range(40):
        phase = rng.choice(phases)
        seq += [phase() for _ in range(rng.randrange(1, 40))]
    ours, srv = _trajectory(sidecar, provider, coalesce_us, max_sigs, seq)
    theirs, jsrv = _trajectory(jwire, jprov, coalesce_us, max_sigs, seq)
    assert ours == theirs
    assert srv.coalesce_adjustments == jsrv.coalesce_adjustments > 0
    assert all(0 <= c <= max(sidecar.ADAPT_CEILING_US, coalesce_us)
               for c in ours)


def test_reset_window_restores_the_configured_value():
    seq = [(3, 64)] * (3 * sidecar.ADAPT_WINDOW)  # small, coalescing: grow
    ours, srv = _trajectory(sidecar, provider, 1000, 4096, seq)
    theirs, jsrv = _trajectory(jwire, jprov, 1000, 4096, seq)
    assert ours == theirs and srv.coalesce_us > 1000
    adjustments = srv.coalesce_adjustments
    for _ in range(3):  # a partly filled adaptation window
        srv._adapt_observe(3, 64)
        jsrv._adapt_observe(3, 64)
    srv.reset_window()
    jsrv.reset_window()
    assert srv.coalesce_us == jsrv.coalesce_us == 1000
    assert srv._win_batches == srv._win_requests == srv._win_sigs == 0
    assert srv.coalesce_adjustments == adjustments  # the audit trail stays
    # The next decision needs a full window of its own traffic.
    for _ in range(sidecar.ADAPT_WINDOW - 1):
        srv._adapt_observe(3, 64)
    assert srv.coalesce_us == 1000
    srv._adapt_observe(3, 64)
    assert srv.coalesce_us == 1500


def test_stats_carry_the_jax_keys_of_this_slice():
    ours = _unstarted(sidecar, provider, qos_guard_us=1500,
                      adaptive_coalesce=True).stats()
    theirs = _unstarted(jwire, jprov, qos_guard_us=1500,
                        adaptive_coalesce=True).stats()
    keys = {"adaptive_coalesce", "coalesce_us", "coalesce_us_initial",
            "coalesce_adjustments", "qos_guard_us", "qos_early_flushes",
            "qos_interactive_requests", "qos_bulk_requests"}
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["qos_guard_us"] == 1500 and ours["adaptive_coalesce"] is True
    assert "unsupported_ops" not in ours


def _round_trip(sock, payload, req_id):
    sidecar.send_frame(sock, payload)
    reply = sidecar.recv_frame(sock)
    op, rid, status, tier, _w, _v = sidecar._VERIFY_REPLY_HDR.unpack_from(
        reply)
    assert (op, rid, status) == (sidecar.OP_VERIFY, req_id,
                                 sidecar.STATUS_OK)
    return tier, np.frombuffer(reply, np.uint8,
                               offset=sidecar._VERIFY_REPLY_HDR.size)


@pytest.fixture(scope="module")
def cpu_server(tmp_path_factory):
    address = _address(tmp_path_factory.mktemp("qos"), "q.sock")
    srv = sidecar.SidecarServer(address, device="cpu", coalesce_us=0,
                                max_sigs=256, device_min_sigs=0).start(
                                    warm=False)
    yield srv
    srv.stop()


@pytest.mark.parametrize("op", ["interactive", "bulk", "metrics"])
def test_qos_and_metrics_ops_are_served(cpu_server, op):
    """OP_VERIFY_QOS answers each lane with the oracle mask (the batch runs
    the device path's plain versions); OP_METRICS answers with Prometheus
    text the port's parser reads. The connection stays usable."""
    sock = sidecar.connect(cpu_server.address, timeout=60)
    try:
        if op == "metrics":
            sidecar.send_frame(sock, sidecar._REQ_HDR.pack(
                sidecar.OP_METRICS, 6))
            reply = sidecar.recv_frame(sock)
            assert sidecar._REPLY_HDR.unpack_from(reply) == (
                sidecar.OP_METRICS, 6, sidecar.STATUS_OK)
            parsed = export.parse_prometheus(
                reply[sidecar._REPLY_HDR.size:].decode())
            assert "sidecar_requests_total" in parsed["counters"]
            assert "sidecar_batch_sigs" in parsed["histograms"]
        else:
            lane = (sidecar.LANE_CODE_INTERACTIVE if op == "interactive"
                    else sidecar.LANE_CODE_BULK)
            jobs = _jobs(12, tamper={3, 8})
            deadline = (time.time_ns() + 10**9
                        if op == "interactive" else 0)
            tier, mask = _round_trip(sock, sidecar.encode_verify_request_qos(
                5, jobs, lane, deadline), 5)
            assert mask.astype(bool).tolist() == _oracle(jobs)
            assert tier == 1  # device_min_sigs=0: the device path ran
        sidecar.send_frame(sock, sidecar._REQ_HDR.pack(sidecar.OP_PING, 7))
        assert sidecar._REPLY_HDR.unpack_from(sidecar.recv_frame(sock)) == (
            sidecar.OP_PING, 7, sidecar.STATUS_OK)
    finally:
        sock.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_deadline_flush_cuts_an_open_window(tmp_path, package):
    """A bulk request opens a 120 s coalescing window; an interactive
    request with a deadline 50 ms out flushes both in one batch long
    before the window closes. Both servers count it the same way."""
    mod, prov = (sidecar, provider) if package == "port" else (jwire, jprov)
    srv = mod.SidecarServer(_address(tmp_path, "f.sock"),
                            verifier=prov.CpuVerifier(),
                            coalesce_us=120_000_000, max_sigs=4096,
                            qos_guard_us=2000).start()
    bulk_jobs = _jobs(20, tamper={4})
    inter_jobs = _jobs(5, tamper={1})
    try:
        bulk = sidecar.connect(srv.address, timeout=60)
        inter = sidecar.connect(srv.address, timeout=60)
        try:
            sidecar.send_frame(bulk, sidecar.encode_verify_request_qos(
                1, bulk_jobs, sidecar.LANE_CODE_BULK, 0))
            deadline = time.monotonic() + 30
            while srv.stats()["requests"] < 1:  # the bulk request is queued
                assert time.monotonic() < deadline
                time.sleep(0.005)
            _tier, mask = _round_trip(inter, sidecar.encode_verify_request_qos(
                2, inter_jobs, sidecar.LANE_CODE_INTERACTIVE,
                time.time_ns() + 50_000_000), 2)
            assert mask.astype(bool).tolist() == _oracle(inter_jobs)
            reply = sidecar.recv_frame(bulk)
            assert np.frombuffer(
                reply, np.uint8, offset=sidecar._VERIFY_REPLY_HDR.size
            ).astype(bool).tolist() == _oracle(bulk_jobs)
        finally:
            bulk.close()
            inter.close()
        stats = srv.stats()
        assert stats["qos_early_flushes"] == 1
        assert stats["batches"] == 1 and stats["cross_request_batches"] == 1
        assert (stats["qos_bulk_requests"],
                stats["qos_interactive_requests"]) == (1, 1)
    finally:
        srv.stop()


def test_telemetry_counts_requests_batches_and_sigs(tmp_path):
    reg = telemetry.arm()
    srv = sidecar.SidecarServer(_address(tmp_path, "t.sock"),
                                verifier=provider.CpuVerifier(),
                                coalesce_us=0).start()
    try:
        for k, n in enumerate((3, 9, 17)):
            got = sidecar.verify_remote(srv.address, _jobs(n), req_id=k + 1)
            assert got.all()
        stats = srv.stats()
        snap = reg.snapshot()
        assert snap["counters"]["sidecar_requests_total"] == stats["requests"]
        assert snap["counters"]["sidecar_batches_total"] == stats["batches"]
        assert snap["counters"]["sidecar_sigs_total"] == stats["sigs"] == 29
        assert snap["histograms"]["sidecar_batch_sigs"]["count"] == 3
    finally:
        srv.stop()
        telemetry.arm()


def test_cli_takes_qos_guard_and_adaptive_coalesce(tmp_path):
    import subprocess
    import sys

    address = _address(tmp_path, "cli.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "corda_tpu_torch.crypto.sidecar", "--socket",
         address, "--device", "cpu", "--qos-guard-us", "1234",
         "--adaptive-coalesce", "--coalesce-us", "0"],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("sidecar up at ")
        stats = sidecar.fetch_stats(line[len("sidecar up at "):])
        assert stats["qos_guard_us"] == 1234
        assert stats["adaptive_coalesce"] is True
        assert stats["coalesce_us"] == 0
    finally:
        proc.terminate()
        proc.wait(30)
