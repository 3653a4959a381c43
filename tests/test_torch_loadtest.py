"""The port's load harness (corda_tpu_torch/tools/loadtest.py with its
loadgen cordapp) on the CPU, and against the JAX package's.

First the cases of tests/test_loadtest.py (slow where the reference marks
them slow) and the loadtest cases of tests/test_chaos_recovery.py,
tests/test_async_verify.py, tests/test_telemetry.py, tests/test_sidecar.py,
tests/test_sharding.py and tests/test_durability.py, every harness asked
for the CPU (``verifier="cpu"``, ``notary_device="cpu"``). Then the two
packages side by side: ``run_loadtest(verifier="cpu")`` at a small size
gives equal committed, rejected, signature and batch counts; one metrics
dict gives the same member stamp; the CLI offers the reference's verifier
choices under the port's names, defaults to the card, and refuses a
``jax`` kind. Tolerance: exact equality.
"""

import inspect
import json

import pytest
import torch

from corda_tpu_torch.node.config import BatchConfig
from corda_tpu_torch.testing import faults
from corda_tpu_torch.tools import loadtest
from corda_tpu_torch.tools.loadtest import run_loadtest

CPU = {"verifier": "cpu", "notary_device": "cpu"}


# -- tests/test_loadtest.py --------------------------------------------------


def test_firehose_batches_and_completes(tmp_path):
    result = run_loadtest(
        n_tx=30, notary="validating", verifier="cpu",
        batch=BatchConfig(max_sigs=4096, max_wait_ms=2.0),
        base_dir=str(tmp_path))
    assert result.tx_committed == 30
    assert result.tx_rejected == 0
    # Micro-batching collapsed the firehose: far fewer verify calls than
    # signature checks (client-side 30 checks + notary-side 30 validations).
    assert result.sigs_verified >= 60
    assert result.verify_batches <= 12, (
        f"batching ineffective: {result.verify_batches} batches for "
        f"{result.sigs_verified} sigs")


def test_sparse_traffic_p99_bounded_by_max_wait(tmp_path):
    """A lone request must not wait for a full batch: the max-wait flush
    releases it within ~max_wait_ms plus scheduling slack."""
    result = run_loadtest(
        n_tx=1, notary="simple", verifier="cpu",
        batch=BatchConfig(max_sigs=100_000, max_wait_ms=2.0),
        base_dir=str(tmp_path))
    assert result.tx_committed == 1
    assert result.p99_ms < 2_000


def test_disruption_kill_and_rebuild_converges(tmp_path):
    result = run_loadtest(
        n_tx=30, notary="simple", disrupt="kill-notary", verifier="cpu",
        base_dir=str(tmp_path), max_seconds=60.0)
    assert result.disruptions, "disruption never fired"
    # Every transaction eventually settled exactly once despite the kill.
    assert result.tx_committed + result.tx_rejected == 30
    assert result.tx_committed >= 29  # rejects only if a retry raced itself


@pytest.mark.slow
def test_multiprocess_firehose_happy_path(tmp_path):
    r = loadtest.run_loadtest_multiprocess(
        n_tx=16, width=2, clients=2, notary="simple",
        base_dir=str(tmp_path), max_seconds=120.0, **CPU)
    assert r.tx_committed == 16
    assert r.tx_rejected == 0
    assert r.clients == 2 and r.width == 2
    # Client pumps verified width sigs per move + the notary's response
    # signature (counted via RPC metric deltas across processes).
    assert r.sigs_verified >= 16 * 3
    assert r.sigs_per_sec > 0
    assert r.p50_ms <= r.p99_ms


@pytest.mark.slow
def test_multiprocess_open_loop_pacing(tmp_path):
    r = loadtest.run_loadtest_multiprocess(
        n_tx=30, width=1, clients=1, notary="simple", rate_tx_s=20.0,
        base_dir=str(tmp_path), max_seconds=120.0, **CPU)
    assert r.tx_committed == 30
    assert r.duration_s >= 0.7 * (30 / 20.0)


@pytest.mark.slow
def test_multiprocess_kill_follower_converges(tmp_path):
    r = loadtest.run_loadtest_multiprocess(
        n_tx=200, width=2, clients=2, notary="raft",
        disrupt="kill-follower", disrupt_after_s=0.5,
        base_dir=str(tmp_path), max_seconds=300.0, **CPU)
    assert r.disruptions, "kill disruption never fired"
    assert any("SIGKILL" in d for d in r.disruptions)
    assert r.tx_committed == 200
    assert r.tx_rejected == 0


@pytest.mark.slow
def test_multiprocess_sigstop_follower_converges(tmp_path):
    r = loadtest.run_loadtest_multiprocess(
        n_tx=120, width=2, clients=2, notary="raft",
        disrupt="sigstop-follower", disrupt_after_s=0.3,
        base_dir=str(tmp_path), max_seconds=300.0, **CPU)
    assert r.disruptions, "sigstop disruption never fired"
    assert any("SIGSTOP" in d for d in r.disruptions)
    assert r.tx_committed == 120


def test_open_loop_latency_sweep(tmp_path):
    res = loadtest.run_latency_sweep(rates=(40.0,), n_tx=40,
                                     base_dir=str(tmp_path), **CPU)
    r = res[40.0]
    assert r.committed == 40
    assert r.p50_ms <= r.p90_ms <= r.p99_ms
    assert r.duration_s >= 0.6 * (40 / 40.0)
    assert res.node_stamps and all(
        isinstance(s, dict) for s in res.node_stamps.values())
    stamp = next(iter(res.node_stamps.values()))
    assert stamp["verifier"] is not None
    assert stamp["pipeline_depth"] == 2  # async pipeline on by default


@pytest.mark.slow
def test_latency_sweep_raft_validating_cluster(tmp_path):
    sweep = loadtest.run_latency_sweep(
        rates=(15.0,), n_tx=12, width=2, notary="raft-validating",
        base_dir=str(tmp_path), max_seconds=240.0, **CPU)
    r = sweep[15.0]
    assert r.committed == 12
    assert r.rejected == 0
    assert r.p99_ms >= r.p50_ms > 0


# -- tests/test_chaos_recovery.py --------------------------------------------


@pytest.mark.slow
def test_leader_kill_exactly_once_with_measured_recovery(tmp_path):
    result = loadtest.run_chaos_loadtest(
        n_tx=60, kill_leader=True, rate_tx_s=80.0, verifier="cpu",
        base_dir=str(tmp_path), max_seconds=120.0)
    assert any("killed leader" in d for d in result.disruptions), \
        result.disruptions
    assert result.exactly_once, result.to_json()
    assert result.cluster_committed == 60
    assert result.leader_kill_recovery_s is not None
    assert result.leader_kill_recovery_s < 60.0


@pytest.mark.slow
def test_pipelined_leader_kill_mid_overlap_exactly_once(tmp_path):
    plan = faults.FaultPlan(7, [
        faults.FaultRule("raft.fsync", "stall", delay_s=0.02)])
    result = loadtest.run_chaos_loadtest(
        plan=plan, n_tx=60, kill_leader=True, rate_tx_s=200.0,
        verifier="cpu", base_dir=str(tmp_path), max_seconds=120.0)
    assert any("killed leader" in d for d in result.disruptions), \
        result.disruptions
    assert result.faults_injected.get("raft.fsync:stall", 0) > 0
    assert result.exactly_once, result.to_json()
    assert result.cluster_committed == 60
    assert result.leader_kill_recovery_s is not None


@pytest.mark.slow
def test_lossy_transport_redelivers_to_completion(tmp_path):
    result = loadtest.run_chaos_loadtest(
        plan="lossy", n_tx=60, rate_tx_s=80.0, verifier="cpu",
        base_dir=str(tmp_path), max_seconds=120.0)
    assert result.exactly_once, result.to_json()
    assert result.faults_injected.get("transport.send:drop", 0) > 0, \
        "lossy plan never dropped a frame"


@pytest.mark.slow
def test_slow_disk_plan_completes(tmp_path):
    plan = faults.FaultPlan(5, [
        faults.FaultRule("raft.fsync", "stall", delay_s=0.02)])
    result = loadtest.run_chaos_loadtest(
        plan=plan, n_tx=30, verifier="cpu", base_dir=str(tmp_path),
        max_seconds=120.0)
    assert result.exactly_once, result.to_json()
    assert result.faults_injected.get("raft.fsync:stall", 0) > 0


# -- tests/test_async_verify.py, tests/test_telemetry.py ----------------------


def test_mini_loadtest_with_the_async_pump(tmp_path):
    """The bench contract smoke's miniature cluster (the port has no
    bench.py yet): real flows really notarised with the pipeline on."""
    res = run_loadtest(n_tx=6, notary="validating", max_seconds=60.0,
                       verifier="cpu", batch=BatchConfig(max_wait_ms=0.5),
                       base_dir=str(tmp_path))
    assert res.tx_committed == 6
    assert res.verify_batches >= 1
    assert json.loads(res.to_json())["tx_committed"] == 6


def test_loadtest_busiest_stage_is_guarded():
    few = {"pump": 9.0, "fsync": 1.0,
           "rounds": loadtest.BUSIEST_STAGE_MIN_ROUNDS - 1}
    assert loadtest._busiest_stage(few) is None  # abstains under-sampled
    assert loadtest._busiest_stage(None) is None
    enough = dict(few, rounds=500)
    assert loadtest._busiest_stage(enough) == "pump"
    tied = {"verify": 2.0, "fsync": 2.0, "rounds": 100}
    assert loadtest._busiest_stage(tied) == "fsync"  # alphabetical
    assert loadtest._busiest_stage(
        {"pump": 0.0, "fsync": 0.0, "rounds": 100}) is None


# -- tests/test_sidecar.py ----------------------------------------------------


def test_member_stamp_reports_occupancy_and_sidecar():
    stamp = loadtest._member_stamp({
        "verifier": "sidecar", "verify_device_batches": 3,
        "verify_host_batches": 1, "verify_effective_min_sigs": 16,
        "verify_static_min_sigs": 16,
        "sidecar": {"batches": 3, "fallbacks": 0},
    }, device="cpu")
    assert stamp["device_occupancy"] == 0.75
    assert stamp["effective_min_sigs"] == 16
    assert stamp["sidecar"] == {"batches": 3, "fallbacks": 0}
    empty = loadtest._member_stamp({}, device="cpu")
    assert empty["device_occupancy"] is None
    assert empty["sidecar"] is None


@pytest.mark.slow
def test_multiprocess_loadtest_with_sidecar_commits_and_stamps():
    res = loadtest.run_loadtest_multiprocess(
        n_tx=24, width=4, clients=1, notary="raft-validating",
        cluster_size=3, sidecar=True, max_seconds=300.0, **CPU)
    assert res.tx_committed == 24
    assert res.sidecar is not None and "error" not in res.sidecar
    assert res.sidecar["sigs"] > 0
    assert res.sidecar["requests"] > 0
    member_sidecars = [s.get("sidecar") for s in res.node_stamps.values()]
    assert any(s and s.get("batches", 0) > 0 for s in member_sidecars), (
        "no member shipped a batch to the sidecar")
    assert all(not (s or {}).get("fallbacks") for s in member_sidecars)


# -- tests/test_sharding.py ---------------------------------------------------


@pytest.mark.slow
def test_chaos_sharded_exactly_once_under_faults(tmp_path):
    r = loadtest.run_chaos_loadtest(
        plan="lossy", n_tx=24, cluster_size=3, kill_leader=True, shards=2,
        cross_frac=0.25, verifier="cpu", base_dir=str(tmp_path / "chaos"))
    assert r.shards == 2
    assert r.cross_requested > 0
    assert r.reserved_leaked == 0
    assert r.exactly_once, r.to_json()


@pytest.mark.slow
def test_multiprocess_shard_cluster_cross_mix(tmp_path):
    r = loadtest.run_loadtest_multiprocess(
        n_tx=24, width=2, clients=1, notary="raft", cluster_size=1,
        inflight=8, shards=2, cross_frac=0.25,
        base_dir=str(tmp_path / "mp"), **CPU)
    assert r.shards == 2
    assert r.cross_requested > 0
    assert r.ledger_committed == r.ledger_expected
    assert r.exactly_once, r.to_json()


# -- tests/test_durability.py -------------------------------------------------


def test_bitrot_plan_is_builtin():
    plan = faults.builtin_plan("bitrot")
    assert {r.point for r in plan.rules} == {"disk.corrupt", "disk.full"}


@pytest.mark.slow
def test_bitrot_chaos_exactly_once_with_clean_fsck(tmp_path):
    result = loadtest.run_chaos_loadtest(
        plan="bitrot", n_tx=60, rate_tx_s=80.0, verifier="cpu",
        base_dir=str(tmp_path), max_seconds=120.0)
    assert result.exactly_once, result.to_json()
    assert result.fsck_clean is True, result.to_json()
    assert "integrity_errors" in json.loads(result.to_json())


# -- the two packages side by side --------------------------------------------


@pytest.mark.parametrize("notary", ["simple", "validating"])
def test_run_loadtest_counts_equal_jax(tmp_path, notary):
    from corda_tpu.node.config import BatchConfig as JaxBatchConfig
    from corda_tpu.tools.loadtest import run_loadtest as jax_run_loadtest

    mine = run_loadtest(n_tx=6, notary=notary, verifier="cpu",
                        batch=BatchConfig(max_sigs=4096, max_wait_ms=2.0),
                        base_dir=str(tmp_path / "port"))
    theirs = jax_run_loadtest(
        n_tx=6, notary=notary, verifier="cpu",
        batch=JaxBatchConfig(max_sigs=4096, max_wait_ms=2.0),
        base_dir=str(tmp_path / "jax"))
    keys = ("tx_requested", "tx_committed", "tx_rejected", "sigs_verified",
            "verify_batches")
    assert {k: getattr(mine, k) for k in keys} == \
        {k: getattr(theirs, k) for k in keys}
    assert mine.tx_committed == 6


# One node_metrics snapshot in the shape a raft member's RPC returns, and
# an earlier one as the baseline of a delta-windowed stamp.
_METRICS = {
    "verifier": "sidecar", "kernel_backend": "cuda",
    "verify_device_batches": 40, "verify_host_batches": 10,
    "verify_device_ready": None, "verify_device_min_sigs": 16,
    "verify_effective_min_sigs": 16, "verify_static_min_sigs": 16,
    "verify_sigs": 1600, "verify_batches": 50,
    "async_verify": {"depth": 2, "verify_wall_s": 1.5,
                     "effective_min_sigs": 16, "adaptive_adjustments": 3},
    "round_stage_s": {"rounds": 400, "pump": 2.0, "raft": 1.25,
                      "verify": 0.5, "commit": 0.75},
    "round_phase_s": {"rounds": 400, "poll": 1.0, "verify_wait": 0.25,
                      "seal": 0.5, "replicate": 0.5, "apply": 0.5,
                      "reply": 0.25, "wall": 3.5},
    "raft": {"role": "leader", "entries_per_batch": 12.5,
             "replication_rtt_ms_avg": 1.75, "reply_coalesce_ratio": 0.5},
    "transport": {"outbox_burst_avg": 3.0, "bridge_flush_avg": 2.0,
                  "frames_sent_total": 900},
    "sidecar": {"batches": 40, "fallbacks": 0,
                "server": {"mesh_devices": 1,
                           "per_device_occupancy": [0.5]}},
    "session_bursts": 30, "session_burst_frames": 120,
    "admission": {"shed": 0},
}
_BASELINE = {
    "round_stage_s": {"rounds": 100, "pump": 0.5, "raft": 0.25,
                      "verify": 0.25, "commit": 0.25},
    "round_phase_s": {"rounds": 100, "poll": 0.25, "verify_wait": 0.125,
                      "seal": 0.125, "replicate": 0.125, "apply": 0.125,
                      "reply": 0.0625, "wall": 1.0},
}


@pytest.mark.parametrize("baseline", [None, _BASELINE])
def test_member_stamp_equal_jax(baseline):
    from corda_tpu.tools.loadtest import _member_stamp as jax_member_stamp

    mine = loadtest._member_stamp(_METRICS, "accelerator", baseline)
    theirs = jax_member_stamp(_METRICS, "accelerator", baseline)
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert mine["device_occupancy"] == 0.8
    assert mine["busiest_stage"] == "pump"


def _cli_kwargs(monkeypatch, argv):
    """The keyword arguments main() hands the harness it picks."""
    seen = {}

    class _Result:
        def to_json(self):
            return "{}"

    def fake(**kw):
        seen.update(kw)
        return _Result()

    for name in ("run_loadtest", "run_loadtest_multiprocess",
                 "run_chaos_loadtest"):
        monkeypatch.setattr(loadtest, name, fake)
    assert loadtest.main(argv) == 0
    return seen


def test_cli_defaults_to_the_card(monkeypatch, capsys):
    assert _cli_kwargs(monkeypatch, ["--tx", "3"])["verifier"] == "torch"
    kw = _cli_kwargs(monkeypatch, ["--tx", "3", "--processes"])
    assert (kw["verifier"], kw["notary_device"]) == ("torch", "accelerator")
    kw = _cli_kwargs(monkeypatch, ["--tx", "3", "--processes",
                                   "--verifier", "cpu",
                                   "--notary-device", "cpu"])
    assert (kw["verifier"], kw["notary_device"]) == ("cpu", "cpu")
    capsys.readouterr()


def _verifier_choices(mod):
    source = inspect.getsource(mod.main)
    start = source.index('"--verifier", choices=(')
    return source[start:source.index(")", start)]


def test_cli_verifier_choices_are_the_reference_kinds_renamed():
    from corda_tpu.tools import loadtest as jax_loadtest

    assert _verifier_choices(loadtest) == _verifier_choices(
        jax_loadtest).replace("jax", "torch")


@pytest.mark.parametrize("kind", ["jax", "jax-shadow", "jax-sharded",
                                  "torch-sharded", "tpu"])
def test_cli_refuses_other_verifier_kinds(monkeypatch, capsys, kind):
    with pytest.raises(SystemExit) as exit_:
        _cli_kwargs(monkeypatch, ["--tx", "3", "--verifier", kind])
    assert exit_.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("harness", [
    "run_loadtest", "run_chaos_loadtest", "run_partition_loadtest",
    "run_reshard_loadtest", "run_loadtest_multiprocess", "run_latency_sweep",
    "run_slo_sweep", "run_ingest_sweep"])
def test_harnesses_default_to_the_card(harness):
    params = inspect.signature(getattr(loadtest, harness)).parameters
    assert params["verifier"].default == "torch"
    if "notary_device" in params:
        assert params["notary_device"].default == "accelerator"


def test_torch_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: torch runs instead of raising")
    with pytest.raises(RuntimeError, match="cuda"):
        run_loadtest(n_tx=1, notary="simple", base_dir=str(tmp_path))
