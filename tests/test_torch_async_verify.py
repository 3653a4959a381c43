"""The port's verify pump (corda_tpu_torch/crypto/async_verify.py) with its
fault plan (testing/faults.py) and span recorder (obs/trace.py), held to
the JAX package's tests/test_async_verify.py service-level cases, plus
the one divergence: AdaptiveCrossover's floor is bounded by the
verifier's static crossover, shown against the JAX class on the same
observation sequence. The node-level cases of the JAX file need the TCP
node, which the port does not have yet (tests/test_torch_notary_faults.py
drives the pump's degrade path on a MockNode). The restored partition and
fsync hooks are held to the JAX package's schedules here.
"""

import threading
import time

import pytest

from corda_tpu.crypto import async_verify as jav
from corda_tpu.testing import faults as jfaults
from corda_tpu_torch.crypto import async_verify as av
from corda_tpu_torch.crypto import provider, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.node import verify_client
from corda_tpu_torch.obs import trace
from corda_tpu_torch.testing import faults

AdaptiveCrossover = av.AdaptiveCrossover
AsyncVerifyService = av.AsyncVerifyService
VerifyBatchHandle = av.VerifyBatchHandle


class _OkVerifier:
    name = "stub-ok"

    def __init__(self):
        self.calls = 0

    def verify_batch(self, jobs):
        self.calls += 1
        return [True] * len(jobs)


class _BlockingVerifier:
    """Holds every verify_batch until released: a device mid-kernel."""

    name = "stub-blocking"

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def verify_batch(self, jobs):
        self.entered.set()
        assert self.release.wait(30.0), "test forgot to release the verifier"
        return [True] * len(jobs)


class _RaisingVerifier:
    name = "stub-raising"

    def verify_batch(self, jobs):
        raise RuntimeError("device fell off the bus")


def _jobs(n):
    return [provider.VerifyJob(pubkey=b"\x00" * 32, message=b"\x01" * 32,
                               sig=b"\x02" * 64) for _ in range(n)]


def _drain_until(svc, want, timeout=30.0):
    done = []
    deadline = time.monotonic() + timeout
    while len(done) < want and time.monotonic() < deadline:
        done.extend(svc.drain())
        time.sleep(0.002)
    assert len(done) == want, f"only {len(done)}/{want} batches completed"
    return done


def test_submit_drain_ordering_and_stats():
    svc = AsyncVerifyService(_OkVerifier(), depth=4)
    try:
        handles = [svc.submit(_jobs(i + 1), context=f"batch-{i}")
                   for i in range(3)]
        assert svc.in_flight == 3
        done = _drain_until(svc, 3)
        assert [h.context for h in done] == ["batch-0", "batch-1", "batch-2"]
        assert all(a is b for a, b in zip(done, handles))
        for i, h in enumerate(done):
            assert h.ok == [True] * (i + 1)
            assert h.error is None
            assert h.tier == "host"  # the stub has no device_batches
            assert h.finished_at >= h.started_at >= 0
        assert svc.in_flight == 0
        stats = svc.stats()
        assert stats["submitted_batches"] == stats["completed_batches"] == 3
        assert stats["submitted_sigs"] == stats["completed_sigs"] == 6
        assert stats["failed_batches"] == 0
    finally:
        assert svc.close()


def test_bounded_depth_backpressure():
    stub = _BlockingVerifier()
    svc = AsyncVerifyService(stub, depth=2)
    try:
        svc.submit(_jobs(1), context=0)
        assert svc.can_submit()
        svc.submit(_jobs(1), context=1)
        assert not svc.can_submit()
        assert svc.in_flight == 2
        stub.release.set()
        _drain_until(svc, 2)
        assert svc.can_submit() and svc.in_flight == 0
    finally:
        stub.release.set()
        assert svc.close()


def test_feeder_exception_lands_in_handle_not_thread_death():
    svc = AsyncVerifyService(_RaisingVerifier(), depth=2)
    try:
        svc.submit(_jobs(2), context="doomed")
        (handle,) = _drain_until(svc, 1)
        assert handle.ok is None
        assert "fell off the bus" in str(handle.error)
        assert svc.stats()["failed_batches"] == 1
        svc.verifier = _OkVerifier()
        svc.submit(_jobs(1), context="after")
        (h2,) = _drain_until(svc, 1)
        assert h2.error is None and h2.ok == [True]
    finally:
        assert svc.close()


def test_close_rejects_submit_and_bounds_the_join():
    stub = _BlockingVerifier()
    svc = AsyncVerifyService(stub, depth=1)
    svc.submit(_jobs(1), context=0)
    assert stub.entered.wait(10.0)
    assert svc.close(timeout=0.2) is False  # the feeder is wedged
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_jobs(1), context=1)
    stub.release.set()
    assert svc.close(timeout=10.0) is True


def test_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth"):
        AsyncVerifyService(_OkVerifier(), depth=0)


class _DeviceishVerifier(_OkVerifier):
    def __init__(self, min_sigs=512, ready=True):
        super().__init__()
        self.device_min_sigs = min_sigs
        self.device_gate = threading.Event()
        if ready:
            self.device_gate.set()
        self.device_batches = 0


def test_target_sigs_tracks_crossover_and_gate():
    assert AsyncVerifyService(_OkVerifier(),
                              adaptive=False).target_sigs(4096) == 4096
    svc = AsyncVerifyService(_DeviceishVerifier(min_sigs=512))
    assert svc.target_sigs(4096) == 512
    assert svc.target_sigs(256) == 256
    svc = AsyncVerifyService(_DeviceishVerifier(min_sigs=512, ready=False))
    assert svc.target_sigs(4096) == 4096


def _handle(mod, n, wall_s, tier):
    h = mod.VerifyBatchHandle(_jobs(n), context=None)
    h.started_at = 100.0
    h.finished_at = 100.0 + wall_s
    h.ok = [True] * n
    h.tier = tier
    return h


def test_adaptive_lowers_crossover_when_device_wins():
    v = _DeviceishVerifier(min_sigs=512)
    ac = AdaptiveCrossover(v)
    assert ac.enabled and ac.effective_min_sigs == 512
    ac.observe(_handle(av, 512, 0.001, "device"))
    assert v.device_min_sigs == 512  # evidence on one tier only
    for _ in range(40):
        ac.observe(_handle(av, 512, 0.001, "device"))
        ac.observe(_handle(av, 512, 0.010, "host"))
    assert v.device_min_sigs == AdaptiveCrossover.FLOOR
    assert ac.adjustments > 0


def test_adaptive_raises_crossover_when_host_wins_bounded():
    v = _DeviceishVerifier(min_sigs=512)
    ac = AdaptiveCrossover(v)
    for _ in range(40):
        ac.observe(_handle(av, 512, 0.010, "device"))
        ac.observe(_handle(av, 512, 0.001, "host"))
    assert v.device_min_sigs == ac.ceiling >= 8 * 512


def test_adaptive_ignores_noise_samples():
    v = _DeviceishVerifier(min_sigs=512)
    ac = AdaptiveCrossover(v)
    ac.observe(_handle(av, 8, 0.001, "device"))  # below MIN_SAMPLE_SIGS
    bad = _handle(av, 512, 0.001, "device")
    bad.error = RuntimeError("boom")
    ac.observe(bad)
    assert ac.device_rate == 0.0 and v.device_min_sigs == 512


def test_adaptive_disabled_for_host_only_verifier():
    ac = AdaptiveCrossover(_OkVerifier())
    assert not ac.enabled
    ac.observe(_handle(av, 512, 0.001, "device"))
    assert ac.effective_min_sigs is None


def _walk(mod, static, sequence):
    v = _DeviceishVerifier(min_sigs=static)
    ac = mod.AdaptiveCrossover(v)
    out = []
    for wall_dev, wall_host in sequence:
        ac.observe(_handle(mod, 512, wall_dev, "device"))
        ac.observe(_handle(mod, 512, wall_host, "host"))
        out.append(v.device_min_sigs)
    return out


# The card 10x faster than the host for 20 rounds, then 10x slower for 20,
# then faster again: every step of the policy fires.
_SEQUENCE = ([(0.001, 0.010)] * 20 + [(0.010, 0.001)] * 20
             + [(0.001, 0.010)] * 20)


@pytest.mark.parametrize("static", [provider.DEVICE_MIN_SIGS_DEFAULT,
                                    verify_client.SIDECAR_MIN_SIGS_DEFAULT])
def test_floor_divergence_under_the_jax_floor(static):
    """From a static crossover under FLOOR (the card's 4, the sidecar
    client's 16), the JAX class's first "device is faster" step RAISES the
    crossover to 64; the port's floor is the static value, so the same
    observations never lift it above where it started."""
    theirs = _walk(jav, static, _SEQUENCE)
    ours = _walk(av, static, _SEQUENCE)
    assert theirs[0] == jav.AdaptiveCrossover.FLOOR == 64 > static
    assert ours[0] == static
    assert min(ours) == static and ours[-1] == static
    assert min(theirs) == 64
    # The host-faster phase climbs the same multiplicative steps from the
    # value each started at, to the same ceiling.
    assert max(ours) == max(theirs) == 8192


@pytest.mark.parametrize("static", [64, 512, 4096])
def test_floor_identical_to_jax_from_the_jax_floor_up(static):
    assert _walk(av, static, _SEQUENCE) == _walk(jav, static, _SEQUENCE)


def test_fault_plan_schedule_equal_jax():
    rules = [dict(point="verify.device", action="fail", p=0.3, after=2,
                  max_fires=5),
             dict(point="verify.device", action="slow", p=0.5, delay_s=0.0),
             dict(point="transport.send", action="drop", p=0.1)]
    ours = faults.FaultPlan(41, [faults.FaultRule(**r) for r in rules])
    theirs = jfaults.FaultPlan(41, [jfaults.FaultRule(**r) for r in rules])
    for k in range(300):
        point = ("verify.device", "transport.send")[k % 2]
        assert ours.fire(point) == theirs.fire(point)
    assert ours.injected() == theirs.injected()
    assert faults.PLAN_ENV == jfaults.PLAN_ENV
    assert faults.POINTS == jfaults.POINTS
    toml = 'seed = 3\n[[rule]]\npoint = "verify.device"\naction = "fail"\n'
    assert faults.plan_from_toml(toml).rules == \
        [faults.FaultRule("verify.device", "fail")]


def test_feeder_fires_the_verify_device_fault():
    # The reference's "flaky-device" plan.
    assert jfaults.builtin_plan("flaky-device").rules == \
        [jfaults.FaultRule("verify.device", "fail", max_fires=1)]
    faults.arm(faults.FaultPlan(13, [faults.FaultRule(
        "verify.device", "fail", max_fires=1)]))
    svc = AsyncVerifyService(_OkVerifier(), depth=2)
    try:
        svc.submit(_jobs(3), context="first")
        svc.submit(_jobs(3), context="second")
        first, second = _drain_until(svc, 2)
        assert "fault injected" in str(first.error) and first.ok is None
        assert second.error is None and second.ok == [True] * 3
        assert faults.injected() == {"verify.device:fail": 1}
    finally:
        faults.disarm()
        assert svc.close()


class _Ctx:
    def __init__(self, k):
        self.trace_id = bytes([k]) * 8


def test_pump_over_the_port_sidecar_records_split_spans(tmp_path):
    """The pump over the port's own client and server (CPU): oracle masks,
    device-tier handles, and per batch the queue_wait / device_verify /
    sidecar_wait / sidecar_verify spans fanned in over member traces."""
    path = str(tmp_path / "pump.sock")
    address = path if len(path) < 100 else "127.0.0.1:0"
    srv = sidecar.SidecarServer(address, verifier=provider.CpuVerifier(),
                                coalesce_us=0).start()
    rec = trace.arm("pump")
    client = verify_client.SidecarVerifier(srv.address, device_min_sigs=16,
                                           deadline_ms=60_000)
    svc = AsyncVerifyService(client, depth=2)
    try:
        batches, wants = [], []
        for b, n in enumerate((20, 40, 64, 17)):
            tuples = []
            for i in range(n):
                seed = bytes([i % 5 + 1]) * 32
                msg = bytes([b, i % 5]) * 16
                sig = ref.sign(seed, msg)
                if i == b:
                    sig = bytes([sig[0] ^ 1]) + sig[1:]
                tuples.append((ref.public_key(seed), msg, sig))
            batches.append([provider.VerifyJob(*t) for t in tuples])
            wants.append([ref.verify(*t) for t in tuples])
        for b, jobs in enumerate(batches):
            svc.submit(jobs, context=[_Ctx(b)])
        done = _drain_until(svc, len(batches))
        assert [h.ok.tolist() for h in done] == wants
        assert all(h.tier == "device" for h in done)
        assert client.fallbacks == 0
        names = [s["name"] for s in rec.snapshot()]
        for name in ("queue_wait", "device_verify", "sidecar_wait",
                     "sidecar_verify"):
            assert names.count(name) == len(batches), name
        for s in rec.snapshot():
            assert s["t_end"] >= s["t_start"]
            assert len(s["attrs"]["member_traces"]) == 1
        assert svc.stats()["effective_min_sigs"] == 16
    finally:
        assert svc.close()
        trace.disarm()
        client.close()
        srv.stop()


_TOML_PLAN = """seed = 9
[[rule]]
point = "verify.device"
action = "fail"
p = 0.4
after = 3
max_fires = 6
node = "n1"
[[rule]]
point = "verify.device"
action = "slow"
p = 0.3
delay_s = 0.0
[[rule]]
point = "transport.send"
action = "drop"
p = 0.2
node = "n2"
"""


def _fields(rules):
    return [(r.point, r.action, r.p, r.delay_s, r.after, r.max_fires, r.node)
            for r in rules]


@pytest.mark.parametrize("node_name", ["n1", "n2", None])
def test_plan_from_toml_equal_jax(node_name):
    ours = faults.plan_from_toml(_TOML_PLAN, node_name=node_name)
    theirs = jfaults.plan_from_toml(_TOML_PLAN, node_name=node_name)
    assert _fields(ours.rules) == _fields(theirs.rules)
    for k in range(400):
        point = ("verify.device", "transport.send")[k % 3 == 0]
        assert ours.fire(point) == theirs.fire(point)
    assert ours.injected() == theirs.injected()


def test_arm_from_env_reads_plan_env(tmp_path, monkeypatch):
    path = tmp_path / "plan.toml"
    path.write_text(_TOML_PLAN)
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    assert faults.arm_from_env("n1") is None and faults.ACTIVE is None
    monkeypatch.setenv(faults.PLAN_ENV, str(path))
    try:
        plan = faults.arm_from_env("n1")
        assert faults.ACTIVE is plan
        assert _fields(plan.rules) == \
            _fields(jfaults.plan_from_toml(_TOML_PLAN, "n1").rules)
        reference = jfaults.plan_from_toml(_TOML_PLAN, "n1")
        for _ in range(50):
            assert faults.fire("verify.device") == \
                reference.fire("verify.device")
        assert faults.injected() == reference.injected() != {}
    finally:
        faults.disarm()
    assert faults.fire("verify.device") is None and faults.injected() == {}


_PARTITION_PLANS = {
    "split": 'seed = 1\n[[partition]]\nkind = "split"\nafter = 10\n'
             'duration = 40\n',
    "asym-sides": 'seed = 2\n[[partition]]\nkind = "asym"\na = ["n1"]\n'
                  'b = ["n2", "n3"]\nafter = 5\n',
    "flap-seeded": 'seed = 3\n[[rule]]\npoint = "transport.send"\n'
                   'action = "drop"\np = 0.1\n[[partition]]\nkind = "flap"\n'
                   'after = 4\nduration = 300\n',
    "two-specs": 'seed = 4\n[[partition]]\nkind = "split"\nafter = 30\n'
                 '[[partition]]\nkind = "asym"\nafter = 0\nduration = 20\n',
}


def _specs(plan):
    return [(s.kind, s.a, s.b, s.after, s.duration, s.period)
            for s in plan.partitions]


@pytest.mark.parametrize("name", sorted(_PARTITION_PLANS))
def test_partition_plans_equal_jax(name):
    """Partition plans parse, bind, schedule, cut and heal as the JAX
    package's do (the [[partition]] tables, the seeded flap period)."""
    toml = _PARTITION_PLANS[name]
    ours = faults.plan_from_toml(toml)
    theirs = jfaults.plan_from_toml(toml)
    assert _specs(ours) == _specs(theirs)
    ids = ["n1", "n2", "n3"]
    ours.bind_partition_nodes(ids)
    theirs.bind_partition_nodes(ids)
    assert _specs(ours) == _specs(theirs)
    pairs = [(a, b) for a in ids for b in ids if a != b]
    for k in range(360):
        src, dst = pairs[k % len(pairs)]
        assert ours.partitioned(src, dst) == theirs.partitioned(src, dst)
        assert ours.fire_partition(src, dst) == theirs.fire_partition(src, dst)
        assert ours.fire("transport.send") == theirs.fire("transport.send")
        if k == 300:
            ours.heal_partitions()
            theirs.heal_partitions()
    assert ours.injected() == theirs.injected()
    assert ours.injected().get("transport.partition:cut", 0) >= 1
    assert ours.event_counts() == theirs.event_counts()


@pytest.mark.parametrize("action", ["fail", "stall"])
def test_fire_fsync_schedule_equal_jax(action):
    rule = dict(point="checkpoint.write", action=action, p=0.4, after=2,
                delay_s=0.0005)

    def schedule(mod):
        mod.arm(mod.FaultPlan(8, [mod.FaultRule(**rule)]))
        out = []
        try:
            for _ in range(60):
                try:
                    mod.fire_fsync("checkpoint.write")
                    out.append(None)
                except OSError as e:
                    out.append(str(e))
            return out, mod.injected()
        finally:
            mod.disarm()

    ours, theirs = schedule(faults), schedule(jfaults)
    assert ours == theirs
    assert ours[1] != {}
    assert faults.fire_fsync("checkpoint.write") is None  # disarmed
