"""The port's federated verify plane (corda_tpu_torch/crypto/federation.py)
against the JAX package's: the mirror of tests/test_federation.py, every
case run on both packages through the router's test seams (``pick_host``
directly; ``_channel_verify`` stubbed). The hedge and the quarantine are
driven by events, not by a race against the clock: a slow primary is one
that waits for the test to release it. Then the routing decisions over a
script of depths, lanes and health, equal between the packages, and a
two-host federation of the port's sidecar processes through the port's
driver, including a host killed mid-run."""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("corda_tpu", "corda_tpu_torch")
_NS: dict = {}


def ns(pkg) -> SimpleNamespace:
    if pkg not in _NS:
        m = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa
        fed, sc = m("crypto.federation"), m("crypto.sidecar")
        _NS[pkg] = SimpleNamespace(
            FederatedVerifier=fed.FederatedVerifier,
            BULK_STICK_CAP_SIGS=fed.BULK_STICK_CAP_SIGS,
            VerifyJob=m("crypto.provider").VerifyJob,
            LANE_CODE_BULK=sc.LANE_CODE_BULK,
            LANE_CODE_INTERACTIVE=sc.LANE_CODE_INTERACTIVE,
            verify_client=m("node.verify_client"),
            SidecarError=m("node.verify_client").SidecarError,
            config=m("node.config"), node=m("node.node"))
    return _NS[pkg]


def _fed(p, n_hosts=3, **kw):
    kw.setdefault("device_min_sigs", 0)
    return p.FederatedVerifier([f"/nonexistent/host{i}.sock"
                                for i in range(n_hosts)], **kw)


def _jobs(p, n=4):
    return [p.VerifyJob(b"\x01" * 32, b"m%d" % i, b"\x02" * 64)
            for i in range(n)]


def _raise(exc):
    raise exc


@pytest.fixture(params=PKGS)
def p(request):
    return ns(request.param)


# -- routing policy ----------------------------------------------------------


def test_interactive_routes_to_least_depth_with_index_tiebreak(p):
    fed = _fed(p, 3)
    fed.channels[0].in_flight_sigs = 100
    fed.channels[1].in_flight_sigs = 10
    fed.channels[2].in_flight_sigs = 10
    assert fed.pick_host(8, p.LANE_CODE_INTERACTIVE) is fed.channels[1]
    assert fed.pick_host(8, None) is fed.channels[1]
    fed.channels[1].in_flight_sigs = 200
    assert fed.pick_host(8, None) is fed.channels[2]


def test_bulk_sticks_to_busiest_open_window_under_cap(p):
    fed = _fed(p, 3)
    fed.channels[0].in_flight_sigs = 50
    fed.channels[1].in_flight_sigs = 300
    fed.channels[2].in_flight_sigs = 0
    assert fed.pick_host(8, p.LANE_CODE_BULK) is fed.channels[1]
    assert fed.pick_host(8, p.LANE_CODE_INTERACTIVE) is fed.channels[2]
    fed.channels[1].in_flight_sigs = p.BULK_STICK_CAP_SIGS
    fed.channels[0].in_flight_sigs = p.BULK_STICK_CAP_SIGS
    assert fed.pick_host(8, p.LANE_CODE_BULK) is fed.channels[2]


def test_bulk_with_no_open_window_routes_least_depth(p):
    fed = _fed(p, 2)
    assert fed.pick_host(8, p.LANE_CODE_BULK) is fed.channels[0]


def test_unhealthy_hosts_are_skipped_and_none_when_all_down(p):
    fed = _fed(p, 2)
    fed.channels[0].healthy.clear()
    assert fed.pick_host(8, None) is fed.channels[1]
    fed.channels[1].healthy.clear()
    assert fed.pick_host(8, None) is None


# -- hedged re-dispatch ------------------------------------------------------


def test_hedge_fires_exactly_once_and_first_answer_wins(p, monkeypatch):
    fed = _fed(p, 3, hedge_ms=40.0, reprobe_cooldown_s=60.0)
    jobs = _jobs(p)
    calls = []
    release = threading.Event()

    def channel_verify(channel, jb, hint):
        calls.append(channel.index)
        if channel.index == 0:
            release.wait(30.0)  # parked until the test has its answer
            return np.ones(len(jb), bool)
        return np.zeros(len(jb), bool)

    monkeypatch.setattr(fed, "_channel_verify", channel_verify)
    out = fed._verify_ed25519_device(jobs)
    release.set()
    assert not out.any()
    assert calls == [0, 1]
    assert fed.hedges == 1
    assert fed.channels[0].hedges == 1
    assert fed.channels[1].hedge_wins == 1
    assert fed.channels[2].dispatches == 0
    calls.clear()
    monkeypatch.setattr(fed, "_channel_verify",
                        lambda c, jb, h: np.zeros(len(jb), bool))
    fed._verify_ed25519_device(jobs)
    assert fed.hedges == 1


def test_slow_primary_verdict_discarded_not_double_applied(p, monkeypatch):
    fed = _fed(p, 2, hedge_ms=30.0, reprobe_cooldown_s=60.0)
    jobs = _jobs(p)
    release, primary_done = threading.Event(), threading.Event()

    def channel_verify(channel, jb, hint):
        if channel.index == 0:
            release.wait(30.0)
            primary_done.set()
            return np.ones(len(jb), bool)  # the LOSING verdict
        return np.zeros(len(jb), bool)

    monkeypatch.setattr(fed, "_channel_verify", channel_verify)
    out = fed._verify_ed25519_device(jobs)
    release.set()  # the primary answers only after the hedge has won
    assert not out.any()
    assert primary_done.wait(5.0)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and fed.channels[0].in_flight_sigs:
        time.sleep(0.01)
    assert fed.channels[0].in_flight_sigs == 0
    assert fed.channels[1].in_flight_sigs == 0


# -- failure: quarantine, failover, re-admit ---------------------------------


def test_host_failure_quarantines_and_batch_answers_locally(p, monkeypatch):
    fed = _fed(p, 2, hedge_ms=5000.0, reprobe_cooldown_s=60.0)
    jobs = _jobs(p)

    def channel_verify(channel, jb, hint):
        if channel.index == 0:
            raise p.SidecarError("host0 died")
        return np.zeros(len(jb), bool)

    monkeypatch.setattr(fed, "_channel_verify", channel_verify)
    out = fed.verify_batch(jobs)
    assert not np.asarray(out, bool).any()
    assert fed.fallbacks == 1
    assert not fed.channels[0].healthy.is_set()
    assert fed.channels[0].quarantines == 1
    assert fed.host_degraded == 1
    assert fed.device_gate is None or fed.device_gate.is_set()
    out2 = fed.verify_batch(jobs)
    assert not np.asarray(out2, bool).any()
    assert fed.channels[1].dispatches == 1
    assert fed.device_batches == 1


def test_quarantined_host_reprobes_and_readmits(p, monkeypatch):
    fed = _fed(p, 2, reprobe_cooldown_s=0.05)
    warm_calls = []

    def warm_flaky():
        warm_calls.append(1)
        if len(warm_calls) < 3:
            raise p.SidecarError("still down")

    monkeypatch.setattr(fed.channels[0].client, "warm", warm_flaky)
    fed._quarantine(fed.channels[0], p.SidecarError("boom"))
    assert not fed.channels[0].healthy.is_set()
    assert fed.channels[0].healthy.wait(10.0)
    assert fed.channels[0].readmits == 1
    assert len(warm_calls) >= 3
    assert fed.pick_host(8, None) is fed.channels[0]


def test_quarantine_idempotent_while_reprobe_pending(p, monkeypatch):
    fed = _fed(p, 2, reprobe_cooldown_s=60.0)
    monkeypatch.setattr(fed.channels[0].client, "warm",
                        lambda: _raise(p.SidecarError("down")))
    fed._quarantine(fed.channels[0], p.SidecarError("first"))
    fed._quarantine(fed.channels[0], p.SidecarError("second"))
    assert fed.channels[0].quarantines == 1
    assert fed.channels[0].failures == 2
    assert fed.host_degraded == 1


def test_all_hosts_lost_degrades_whole_tier_exact_answer(p, monkeypatch):
    # The hedge threshold is far above a failing round trip, so each
    # primary's failure resolves the batch before any hedge can fire.
    fed = _fed(p, 2, hedge_ms=5000.0, reprobe_cooldown_s=60.0)
    jobs = _jobs(p)
    monkeypatch.setattr(fed, "_channel_verify",
                        lambda c, jb, h: _raise(p.SidecarError("dead")))
    for ch in fed.channels:
        monkeypatch.setattr(ch.client, "warm",
                            lambda: _raise(p.SidecarError("dead")))
    out = fed.verify_batch(jobs)
    assert not np.asarray(out, bool).any()
    assert fed.fallbacks == 1
    assert not fed.channels[0].healthy.is_set()
    assert fed.channels[1].healthy.is_set()
    assert fed.device_gate is None or fed.device_gate.is_set()
    out = fed.verify_batch(jobs)
    assert not np.asarray(out, bool).any()
    assert fed.fallbacks == 2
    assert all(not c.healthy.is_set() for c in fed.channels)
    assert fed.device_gate is not None and not fed.device_gate.is_set()
    assert fed.degraded == 1
    fed.verify_batch(jobs)
    assert fed.host_batches == 3


def test_device_method_raises_when_no_host_healthy(p):
    fed = _fed(p, 2)
    for c in fed.channels:
        c.healthy.clear()
    with pytest.raises(p.SidecarError):
        fed._verify_ed25519_device(_jobs(p, 2))


# -- stamps ------------------------------------------------------------------


def test_federation_stats_shares_and_decision_ring(p, monkeypatch):
    fed = _fed(p, 2, reprobe_cooldown_s=60.0)
    monkeypatch.setattr(fed.channels[0].client, "_server_stats_maybe",
                        lambda: {"stub": 0})
    monkeypatch.setattr(fed.channels[1].client, "_server_stats_maybe",
                        lambda: {"stub": 1})
    monkeypatch.setattr(fed, "_channel_verify",
                        lambda c, jb, h: np.zeros(len(jb), bool))
    for _ in range(4):
        fed._verify_ed25519_device(_jobs(p, 4))
    fs = fed.federation_stats()
    assert fs["n_hosts"] == 2 and fs["healthy_hosts"] == 2
    assert fs["dispatches"] == 4
    assert fs["routing_share_by_host"][fed.channels[0].address] == 1.0
    assert fs["routing_share_by_host"][fed.channels[1].address] == 0.0
    assert len(fs["recent_decisions"]) == 4
    d = fs["recent_decisions"][-1]
    assert d["host"] == fed.channels[0].address and d["hedged"] is False
    assert set(d["depths"]) == {c.address for c in fed.channels}
    stamp = fed.sidecar_stats()
    assert stamp["address"] == ",".join(c.address for c in fed.channels)
    assert stamp["federation"]["dispatches"] == 4
    assert stamp["batches"] == 0


def test_qos_hint_hands_off_to_winning_channel(p, monkeypatch):
    fed = _fed(p, 2)
    seen = {}

    def client_verify(jb):
        seen["hint"] = fed.channels[0].client.qos_hint
        return np.zeros(len(jb), bool)

    monkeypatch.setattr(fed.channels[0].client, "_verify_ed25519_device",
                        client_verify)
    fed.qos_hint = (p.LANE_CODE_BULK, 123456789)
    fed._verify_ed25519_device(_jobs(p, 2))
    assert seen["hint"] == (p.LANE_CODE_BULK, 123456789)


def test_server_stats_cache_is_per_endpoint(p, monkeypatch):
    client = p.verify_client.SidecarVerifier("ep-a")
    fetched = []

    def fake_fetch(address, timeout=2.0):
        fetched.append(address)
        return {"endpoint": address}

    monkeypatch.setattr(p.verify_client, "fetch_sidecar_stats", fake_fetch)
    assert client._server_stats_maybe() == {"endpoint": "ep-a"}
    assert client._server_stats_maybe() == {"endpoint": "ep-a"}
    assert fetched == ["ep-a"]
    client.address = "ep-b"
    assert client._server_stats_maybe() == {"endpoint": "ep-b"}
    assert fetched == ["ep-a", "ep-b"]
    client.address = "ep-a"
    assert client._server_stats_maybe() == {"endpoint": "ep-a"}
    assert fetched == ["ep-a", "ep-b"]


# -- the node's verifier selection -------------------------------------------


def _cfg(p, tmp_path, **batch_kw):
    return p.config.NodeConfig(name="n", base_dir=tmp_path,
                               verifier="cpu",
                               batch=p.config.BatchConfig(**batch_kw))


def test_select_verifier_federation_off_is_bit_identical(p, tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("CORDA_TPU_FEDERATION", raising=False)
    monkeypatch.delenv("CORDA_TPU_SIDECAR", raising=False)
    v = p.node._select_batch_verifier(_cfg(p, tmp_path))
    assert type(v) is type(p.node._make_verifier("cpu"))
    v = p.node._select_batch_verifier(_cfg(p, tmp_path,
                                           sidecar="/tmp/sc.sock",
                                           sidecar_deadline_ms=1234.0))
    assert type(v) is p.verify_client.SidecarVerifier
    assert v.address == "/tmp/sc.sock"
    assert v.deadline_s == pytest.approx(1.234)


def test_select_verifier_federation_config_and_env(p, tmp_path, monkeypatch):
    monkeypatch.delenv("CORDA_TPU_FEDERATION", raising=False)
    v = p.node._select_batch_verifier(_cfg(
        p, tmp_path, federation_hosts="hostA.sock, hostB.sock",
        sidecar="/ignored.sock", sidecar_deadline_ms=500.0))
    assert isinstance(v, p.FederatedVerifier)
    assert [c.address for c in v.channels] == ["hostA.sock", "hostB.sock"]
    assert v.deadline_s == pytest.approx(0.5)
    monkeypatch.setenv("CORDA_TPU_FEDERATION", "h0.sock,h1.sock,h2.sock")
    v = p.node._select_batch_verifier(_cfg(p, tmp_path))
    assert isinstance(v, p.FederatedVerifier)
    assert len(v.channels) == 3


def test_batch_config_parses_federation_hosts_list_and_string(p, tmp_path):
    raw = {"name": "n", "base_dir": str(tmp_path), "verifier": "cpu",
           "batch": {"federation_hosts": ["a.sock", "b.sock"]}}
    assert p.config.NodeConfig.from_dict(raw).batch.federation_hosts == \
        "a.sock,b.sock"
    raw["batch"] = {"federation_hosts": "a.sock,b.sock"}
    assert p.config.NodeConfig.from_dict(raw).batch.federation_hosts == \
        "a.sock,b.sock"
    assert p.config.NodeConfig.from_dict(
        {"name": "n", "base_dir": str(tmp_path),
         "verifier": "cpu"}).batch.federation_hosts == ""


# -- routing decisions across the packages -----------------------------------

# (depths, healthy, n_sigs, lane) -> the chosen host, on both packages.
SCRIPT = [
    ((0, 0, 0), (1, 1, 1), 16, None),
    ((5, 0, 0), (1, 1, 1), 16, None),
    ((5, 3, 3), (1, 1, 1), 16, 0),
    ((5, 300, 0), (1, 1, 1), 16, 1),
    ((5, 300, 0), (1, 0, 1), 16, 1),
    ((8190, 8000, 0), (1, 1, 1), 16, 1),
    ((8176, 9000, 0), (1, 1, 1), 16, 1),
    ((0, 0, 0), (0, 0, 1), 16, 1),
    ((7, 7, 7), (0, 0, 0), 16, None),
    ((40, 12, 12), (1, 1, 1), 4096, 1),
]


def _decide(pkg, depths, healthy, n_sigs, lane):
    fed = _fed(ns(pkg), len(depths))
    for c, d, h in zip(fed.channels, depths, healthy):
        c.in_flight_sigs = d
        if not h:
            c.healthy.clear()
    host = fed.pick_host(n_sigs, lane)
    return None if host is None else host.index


@pytest.mark.parametrize("step", SCRIPT, ids=str)
def test_routing_decision_equals_the_reference(step):
    assert _decide("corda_tpu_torch", *step) == _decide("corda_tpu", *step)


# -- a federation of the port's sidecar processes ----------------------------


def test_two_port_sidecar_hosts_through_the_driver(tmp_path):
    """Driver.start_federation spawns two port sidecar processes (host
    tier, card hidden); a FederatedVerifier over them answers exactly; with
    host 0 killed, the batch in flight answers from the local host tier
    and the next routes to the survivor."""
    from corda_tpu_torch.crypto import ref_ed25519 as ref
    from corda_tpu_torch.crypto.federation import FederatedVerifier
    from corda_tpu_torch.crypto.provider import VerifyJob
    from corda_tpu_torch.testing.driver import driver

    jobs = []
    for i in range(24):
        seed = bytes([i + 1]) * 32
        msg = bytes([i]) * 32
        sig = ref.sign(seed, msg)
        if i % 5 == 4:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        jobs.append(VerifyJob(ref.public_key(seed), msg, sig))
    want = [ref.verify(j.pubkey, j.message, j.sig) for j in jobs]
    with driver(tmp_path) as d:
        hosts = d.start_federation(2, verifier="cpu", device="cpu",
                                   coalesce_us=0)
        fed = FederatedVerifier([h.address for h in hosts],
                                deadline_ms=20_000.0, device_min_sigs=0,
                                reprobe_cooldown_s=60.0)
        fed.warm()
        assert fed.verify_batch(jobs).tolist() == want
        assert fed.device_batches == 1 and fed.fallbacks == 0
        hosts[0].kill()
        assert fed.verify_batch(jobs).tolist() == want  # local host tier
        assert fed.fallbacks == 1
        assert not fed.channels[0].healthy.is_set()
        assert fed.verify_batch(jobs).tolist() == want  # the survivor
        assert fed.channels[1].dispatches == 1
        assert fed.federation_stats()["healthy_hosts"] == 1
