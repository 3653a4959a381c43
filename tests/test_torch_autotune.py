"""The port's autotune plane (corda_tpu_torch/autotune/,
corda_tpu_torch/tools/autotune.py): the cases of tests/test_autotune.py on
the port -- knob registry drift guard, the deterministic gated search, the
overlay road to spawned processes, the cross-candidate reset seams, and
the bounded runtime leg -- then both packages side by side: the same seed
and mock surface give the same decision sequence and record, the port's
registry validates clean and equals the reference's but for module paths.

Everything here runs against the deterministic mock response surfaces
and fake targets — no clusters, no sleeps. The real ingest runner runs
on the card in chip_smoke.py phase 28. Tolerance: exact equality.
"""

import json

import pytest

from corda_tpu_torch.autotune import controller, runtime, space
from corda_tpu_torch.node.config import NodeConfig, config_overlay_from_env
from corda_tpu_torch.obs import doctor
from corda_tpu_torch.obs import telemetry as tm
from corda_tpu_torch.tools import autotune as autotune_cli

# ---------------------------------------------------------------------------
# Knob registry: every entry resolves to a live lever, drift fails.
# ---------------------------------------------------------------------------


def test_registry_resolves_against_the_tree():
    assert space.validate_registry() == []


def test_registry_catches_config_drift(monkeypatch):
    """A knob whose config key stops existing must fail validation —
    the same contract as a stale trace-stage name."""
    bad = space.Knob("raft.nope", "config:raft.nope", "int",
                     1, 10, 2.0, "mul", 2, ("replicate",))
    monkeypatch.setitem(space.KNOBS, "raft.nope", bad)
    errors = space.validate_registry()
    assert any("raft.nope" in e and "no field" in e for e in errors)


def test_registry_catches_harness_and_env_drift(monkeypatch):
    gone_kwarg = space.Knob(
        "x.harness", "harness:run_ingest_sweep:no_such_kwarg", "int",
        1, 10, 2.0, "mul", 2, ())
    gone_env = space.Knob(
        "x.env", "env:CORDA_TPU_NO_SUCH_VAR:corda_tpu_torch.node.verify_client",
        "int", 1, 10, 2.0, "mul", 2, ())
    monkeypatch.setitem(space.KNOBS, "x.harness", gone_kwarg)
    monkeypatch.setitem(space.KNOBS, "x.env", gone_env)
    errors = space.validate_registry()
    assert any("no_such_kwarg" in e for e in errors)
    assert any("CORDA_TPU_NO_SUCH_VAR" in e for e in errors)


def test_step_rules_respect_bounds_and_seeds():
    ms = space.KNOBS["batch.coalesce_ms"]  # mul knob parked at lo=0
    assert space.step_up(ms, 0.0) == 0.5   # the mul-from-zero seed
    assert space.step_up(ms, 0.5) == 1.0
    assert space.step_down(ms, 0.5) == 0.0  # back down to zero, not 0.25
    assert space.step_down(ms, 0.0) is None  # at the lower bound
    assert space.step_up(ms, 10.0) is None   # at the upper bound
    pw = space.KNOBS["raft.pipeline_window"]  # int knob mid-range
    assert space.step_up(pw, 1024) == 2048
    assert space.step_down(pw, 1024) == 512
    assert space.step_up(pw, 8192) is None
    shards = space.KNOBS["notary_shards.count"]
    assert space.step_up(shards, 4) is None  # hi clamp quantizes to int
    assert set(space.neighbors(pw, 1024)) == {2048, 512}


def test_overlay_and_env_split_by_target_kind():
    values = {"raft.pipeline_window": 2048, "batch.coalesce_ms": 0.5,
              "batch.device_min_sigs": 32,
              "sidecar.coalesce_us": 4000}
    overlay = space.overlay_for(values)
    assert overlay == {"raft": {"pipeline_window": 2048},
                       "batch": {"coalesce_ms": 0.5}}
    assert space.env_for(values) == {"CORDA_TPU_SIDECAR_MIN_SIGS": "32"}
    assert space.harness_kwargs_for(values, "run_slo_sweep") == {
        "sidecar_coalesce_us": 4000}
    assert space.harness_kwargs_for(values, "run_ingest_sweep") == {}
    toml = space.overlay_toml(values)
    assert "[raft]" in toml and "pipeline_window = 2048" in toml


# ---------------------------------------------------------------------------
# Doctor verdict -> sweep spec (the machine-readable experiment field).
# ---------------------------------------------------------------------------


def test_every_prose_rule_has_a_structured_spec():
    """RULE_SPECS mirrors RULES cause-for-cause; the prose table is
    pinned byte-identical elsewhere (test_perf_doctor), the structured
    twin must never drift from its key set."""
    assert set(doctor.RULE_SPECS) == set(doctor.RULES)
    assert set(doctor.PIPELINED_RULE_SPECS) <= set(doctor.PIPELINED_RULES)
    for spec in doctor.RULE_SPECS.values():
        assert set(spec) == {"experiment_id", "knobs", "harness"}


def test_diagnose_entries_carry_structured_experiments():
    """A real diagnose run: every bottleneck entry rides its structured
    (experiment_id, knobs, harness) spec alongside the prose."""
    signals = doctor.extract_signals({
        "metric": "verified_sigs_per_sec", "value": 1200.0,
        "e2e_stream_sigs_per_sec": 100_000.0,
        "kernel_sigs_per_sec": {"4096": 90_000.0},
        "baseline_configs": {
            "raft_validating_3node": {
                "tx_per_sec": 44.0, "p99_ms": 3800.0,
                "loadtest_sigs_per_sec": 2900.0,
                "node_stamps": {
                    "Raft0": {"device_batches": 5, "host_batches": 6}}},
            "ingest_sweep": {"peak_achieved_tx_s": 190.0}},
    })
    verdict = doctor.diagnose(signals)
    assert verdict["first_bottleneck"] == "device_occupancy"
    for entry in verdict["bottlenecks"]:
        exp = entry["experiment"]
        assert exp["experiment_id"]
        assert exp == doctor.suggest_spec(entry["cause"])
    top = verdict["bottlenecks"][0]["experiment"]
    assert top["experiment_id"] == "grow_coalesce_ladder"
    assert top["harness"] == "slo_sweep"


def test_spec_from_verdict_uses_the_structured_experiment():
    verdict = {"bottlenecks": [
        {"cause": "replicate",
         "experiment": doctor.suggest_spec("replicate")}]}
    spec = controller.spec_from_verdict(verdict)
    assert spec.experiment_id == "widen_replication_window"
    assert spec.harness == "ingest_sweep"
    assert spec.knobs == ("raft.pipeline_window", "raft.append_chunk")
    assert spec.metric == "peak_achieved_tx_s"


def test_spec_from_verdict_filters_knobs_by_harness():
    """slo_sweep-only knobs (sidecar.coalesce_us is a run_slo_sweep
    kwarg) must survive for slo_sweep specs and be dropped from
    ingest_sweep specs rather than silently no-op."""
    spec = controller.spec_from_verdict(
        {"bottlenecks": [{"cause": "device_occupancy",
                          "experiment": doctor.suggest_spec(
                              "device_occupancy")}]})
    assert spec.harness == "slo_sweep"
    assert "sidecar.coalesce_us" in spec.knobs


def test_spec_from_verdict_rejects_unsweepable_experiments():
    with pytest.raises(ValueError):
        controller.spec_from_verdict({"bottlenecks": []})
    with pytest.raises(ValueError):
        # reply's experiment is a trace profile, not a parameter sweep.
        controller.spec_from_verdict(
            {"bottlenecks": [{"cause": "reply",
                              "experiment": doctor.suggest_spec("reply")}]})


# ---------------------------------------------------------------------------
# The deterministic gated search.
# ---------------------------------------------------------------------------


def _counter(name: str) -> float:
    return tm.snapshot()["counters"][name]


def test_monotone_search_beats_the_incumbent():
    spec = controller.exploratory_spec()
    runner = controller.make_mock_runner(spec, "monotone")
    before = _counter("autotune_candidates_total")
    result = controller.run_autotune(spec, runner, budget=4, seed=0)
    assert result["candidates_evaluated"] >= 3
    assert result["improved"] is True
    assert result["best_value"] > result["baseline_value"]
    assert result["committed"] is True
    overlay = result["overlay"]
    assert overlay["values"]  # only the knobs that moved
    assert "[" in overlay["toml"]
    # Every measurement (incumbent + candidates) counted.
    assert _counter("autotune_candidates_total") - before == \
        result["candidates_evaluated"] + 1


def test_gate_rejects_regressions_and_keeps_the_incumbent():
    """On a surface where every step away from the default regresses,
    the loop must commit NOTHING: the incumbent stands, and the gate
    (not just the better-than check) records the rejections."""
    # batch.coalesce_ms defaults to its lower bound, so every proposal
    # raises it — and the regressing surface punishes that.
    spec = controller.exploratory_spec(knobs=("batch.coalesce_ms",))
    runner = controller.make_mock_runner(spec, "regressing")
    before = _counter("autotune_gate_rejections_total")
    result = controller.run_autotune(
        spec, runner, budget=4, seed=0,
        policy={"peak_achieved_tx_s": {"direction": "higher", "pct": 1.0}})
    assert result["improved"] is False
    assert result["committed"] is False
    assert result["overlay"] is None
    assert result["best_value"] == result["baseline_value"]
    assert result["gate_rejections"] > 0
    assert _counter("autotune_gate_rejections_total") > before
    assert all(s.endswith(":reject")
               for s in result["decision_sequence"])


def test_exactly_once_flip_is_a_hard_veto():
    """The cliff surface is FASTER above the default but flips
    exactly_once_all False — the gate must veto it no matter the
    speedup (a config that breaks exactly-once is wrong, not slow)."""
    spec = controller.exploratory_spec()
    runner = controller.make_mock_runner(spec, "cliff")
    result = controller.run_autotune(spec, runner, budget=4, seed=0)
    vetoed = [c for c in result["candidates"]
              if c["gate"] and c["gate"]["hard_vetoes"]]
    assert vetoed
    assert any(v["metric"] == "exactly_once_all"
               for c in vetoed for v in c["gate"]["hard_vetoes"])
    for c in vetoed:
        assert c["accepted"] is False
    # Nothing above the defaults survived: no commit.
    assert all(v <= space.KNOBS[k].default
               for k, v in result["best"]["values"].items())


def test_search_replays_bit_identical_from_its_seed():
    spec = controller.exploratory_spec()
    runs = [controller.run_autotune(
        spec, controller.make_mock_runner(spec, "noisy"),
        budget=5, seed=1234) for _ in range(2)]
    assert runs[0]["decision_sequence"] == runs[1]["decision_sequence"]
    assert json.dumps(runs[0], sort_keys=True) == \
        json.dumps(runs[1], sort_keys=True)


def test_candidate_crash_is_isolated():
    """A runner that blows up on one candidate costs that candidate
    (recorded with its error, hard-vetoed), never the search."""
    spec = controller.exploratory_spec()
    mock = controller.make_mock_runner(spec, "monotone")
    calls = []

    def flaky(vals):
        calls.append(dict(vals))
        if len(calls) == 2:  # the first non-incumbent candidate
            raise RuntimeError("cluster failed to elect")
        return mock(vals)

    result = controller.run_autotune(spec, flaky, budget=3, seed=0)
    assert result["candidates_evaluated"] == 3
    crashed = [c for c in result["candidates"]
               if c["metrics"].get("error")]
    assert len(crashed) == 1
    assert "RuntimeError" in crashed[0]["metrics"]["error"]
    assert crashed[0]["accepted"] is False
    assert any(v["metric"] == "candidate_error"
               for v in crashed[0]["gate"]["hard_vetoes"])
    # The search carried on and still found an improvement.
    assert result["improved"] is True


def test_reset_runs_before_every_measurement():
    spec = controller.exploratory_spec(knobs=("batch.coalesce_ms",))
    runner = controller.make_mock_runner(spec, "monotone")
    resets = []
    result = controller.run_autotune(
        spec, runner, budget=2, seed=0, reset=lambda: resets.append(1))
    # Incumbent + every candidate: one reset each.
    assert len(resets) == result["candidates_evaluated"] + 1


def test_reset_between_candidates_calls_reset_window():
    class Target:
        def __init__(self):
            self.resets = 0

        def reset_window(self):
            self.resets += 1

    t = Target()
    controller.reset_between_candidates(t, object(), None)
    assert t.resets == 1


# ---------------------------------------------------------------------------
# Trajectory record + gate policy.
# ---------------------------------------------------------------------------


def _mock_result(seed=7, curve="monotone"):
    spec = controller.exploratory_spec()
    return controller.run_autotune(
        spec, controller.make_mock_runner(spec, curve),
        budget=3, seed=seed,
        verdict_consumed={"source": "unit", "first_bottleneck": None,
                          "experiment_id": spec.experiment_id})


def test_autotune_record_normalizes_with_provenance():
    result = _mock_result()
    rec = doctor.normalize_record(result, source="AUTOTUNE_r21_local.json")
    assert rec["kind"] == "autotune"
    assert rec["round"] == 21
    m = rec["metrics"]
    assert m["autotune_best_value"] == result["best_value"]
    assert m["autotune_baseline_value"] == result["baseline_value"]
    assert m["autotune_candidates"] == result["candidates_evaluated"]
    assert m["autotune_exactly_once_all"] is True
    prov = rec["autotune"]
    assert prov["experiment_id"] == "explore_defaults"
    assert prov["seed"] == 7
    assert prov["decision_sequence"] == result["decision_sequence"]
    assert prov["verdict_consumed"]["source"] == "unit"
    assert len(prov["candidates"]) == len(result["candidates"])
    assert prov["committed"] == result["committed"]


def test_gate_bands_autotune_records():
    """Two autotune records in a store: a >25% drop in the committed
    best_value regresses under the default policy; the winner's
    exactly-once flag is a hard equal-direction gate."""
    good = doctor.normalize_record(_mock_result(), source="a.json")
    bad = json.loads(json.dumps(good))
    bad["metrics"]["autotune_best_value"] = \
        good["metrics"]["autotune_best_value"] * 0.5
    bad["metrics"]["autotune_exactly_once_all"] = False
    verdict = doctor.gate([good, bad], doctor.DEFAULT_POLICY)
    assert verdict["ok"] is False
    metrics = {r["metric"] for r in verdict["regressions"]}
    assert "autotune_best_value" in metrics
    assert "autotune_exactly_once_all" in metrics


# ---------------------------------------------------------------------------
# Config overlay plumbing (satellite: TOML < overlay < explicit env).
# ---------------------------------------------------------------------------


def _write_node_toml(tmp_path, body=""):
    p = tmp_path / "node.toml"
    p.write_text('name = "T"\n' + body)
    return p


def test_overlay_merges_over_toml(tmp_path, monkeypatch):
    path = _write_node_toml(tmp_path, "[raft]\npipeline_window = 64\n")
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY", json.dumps(
        {"raft": {"pipeline_window": 2048},
         "batch.coalesce_ms": 1.5}))  # dotted keys nest too
    cfg = NodeConfig.load(path)
    assert cfg.raft.pipeline_window == 2048  # overlay beat the TOML
    assert cfg.batch.coalesce_ms == 1.5
    monkeypatch.delenv("CORDA_TPU_CONFIG_OVERLAY")
    assert NodeConfig.load(path).raft.pipeline_window == 64


def test_overlay_typos_fail_loud(tmp_path, monkeypatch):
    path = _write_node_toml(tmp_path)
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY",
                       json.dumps({"no_such_section": {"x": 1}}))
    with pytest.raises(ValueError):
        NodeConfig.load(path)  # unknown-keys validation still applies


def test_overlay_rejects_malformed_payloads(monkeypatch):
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY", "not json {")
    with pytest.raises(ValueError):
        config_overlay_from_env()
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY", "[1, 2]")
    with pytest.raises(ValueError):
        config_overlay_from_env()
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY",
                       json.dumps({"raft": 5, "raft.pipeline_window": 1}))
    with pytest.raises(ValueError):
        config_overlay_from_env()  # dotted key under a scalar
    monkeypatch.delenv("CORDA_TPU_CONFIG_OVERLAY")
    assert config_overlay_from_env() == {}


def test_explicit_env_still_outranks_the_overlay(tmp_path, monkeypatch):
    """Precedence top end: CORDA_TPU_FEDERATION (explicit env, read at
    its use site) beats an overlay-set [batch] sidecar address."""
    from corda_tpu_torch.crypto.federation import FederatedVerifier
    from corda_tpu_torch.node.node import _select_batch_verifier

    path = _write_node_toml(tmp_path)
    monkeypatch.setenv("CORDA_TPU_CONFIG_OVERLAY", json.dumps(
        {"batch": {"sidecar": "127.0.0.1:19999"}}))
    cfg = NodeConfig.load(path)
    assert cfg.batch.sidecar == "127.0.0.1:19999"  # overlay landed
    monkeypatch.setenv("CORDA_TPU_FEDERATION", "127.0.0.1:19998")
    verifier = _select_batch_verifier(cfg)
    assert isinstance(verifier, FederatedVerifier)  # env won


def test_driver_ships_overlay_to_spawned_nodes(tmp_path):
    from corda_tpu_torch.testing import driver as drv

    class FakeHost(drv.Host):
        def __init__(self):
            self.spawned_env = None

        def mkdir(self, path):
            pass

        def write_file(self, path, text):
            pass

        def read_text(self, path):
            raise OSError(path)  # no log yet: the port's driver asks

        def spawn(self, argv, log_path, cwd, env):
            self.spawned_env = dict(env)
            return object()

    host = FakeHost()
    d = drv.Driver(tmp_path, host=host)
    overlay = {"raft": {"pipeline_window": 2048}}
    d.start_node("Tuned", wait=False, config_overlay=overlay,
                 env_extra={"CORDA_TPU_FAULT_PLAN": "x.toml"})
    assert host.spawned_env["CORDA_TPU_CONFIG_OVERLAY"] == \
        json.dumps(overlay, sort_keys=True)
    assert host.spawned_env["CORDA_TPU_FAULT_PLAN"] == "x.toml"


# ---------------------------------------------------------------------------
# reset_window seams: no stat bleed between candidates.
# ---------------------------------------------------------------------------


def test_client_reset_window_busts_the_stats_cache():
    from corda_tpu_torch.node.verify_client import SidecarVerifier

    sv = SidecarVerifier("127.0.0.1:1")  # never connected
    sv._server_snapshots["127.0.0.1:1"] = (1e18, {"devices": 4})
    sv.reset_window()
    assert sv._server_snapshots == {}


def test_server_reset_window_restores_the_configured_coalesce():
    from corda_tpu_torch.crypto.sidecar import SidecarServer

    srv = SidecarServer("127.0.0.1:0", verifier=object(),
                        coalesce_us=2000, adaptive_coalesce=True)
    srv.coalesce_us = 7777  # pretend the adaptive policy wandered off
    srv._win_batches = srv._win_requests = 5
    srv._win_sigs = 500
    srv.reset_window()
    assert srv.coalesce_us == 2000
    assert (srv._win_batches, srv._win_requests, srv._win_sigs) == (0, 0, 0)


# ---------------------------------------------------------------------------
# Runtime leg: armed reverts on regression, disarmed is bit-identical.
# ---------------------------------------------------------------------------


class _Lever:
    def __init__(self):
        self.observed = []
        self.reverts = 0


def _lever_target(lever):
    return runtime.AdaptiveTarget(
        "fake", observe=lever.observed.append,
        revert=lambda: setattr(lever, "reverts", lever.reverts + 1))


def test_runtime_tuner_reverts_after_hysteresis_strikes():
    lever = _Lever()
    snaps = iter([
        {"rounds": 0, "wall_s": 0.0},
        {"rounds": 10, "wall_s": 1.0},   # score 10 -> best
        {"rounds": 12, "wall_s": 2.0},   # score 2: strike 1
        {"rounds": 14, "wall_s": 3.0},   # score 2: strike 2 -> revert
    ])
    before = _counter("autotune_reverts_total")
    tuner = runtime.RuntimeTuner(lambda: next(snaps),
                                 targets=(_lever_target(lever),),
                                 armed=True, guard_pct=25.0, hysteresis=2)
    assert tuner.step() == "idle"      # first snapshot: no delta yet
    assert tuner.step() == "observed"  # best score established
    assert tuner.step() == "observed"  # strike 1, not yet reverted
    assert lever.reverts == 0
    assert tuner.step() == "reverted"
    assert lever.reverts == 1
    assert tuner.reverted is True and tuner.armed is False
    assert _counter("autotune_reverts_total") - before == 1
    # Latched: one bad tune never oscillates.
    assert tuner.step() == "disarmed"
    assert lever.reverts == 1
    # The windows it observed fed the targets as deltas.
    assert lever.observed[0] == {"rounds": 10, "wall_s": 1.0}


def test_runtime_tuner_recovery_resets_strikes():
    lever = _Lever()
    snaps = iter([
        {"rounds": 0, "wall_s": 0.0},
        {"rounds": 10, "wall_s": 1.0},   # best 10
        {"rounds": 12, "wall_s": 2.0},   # strike 1
        {"rounds": 22, "wall_s": 3.0},   # back to 10: strikes reset
        {"rounds": 24, "wall_s": 4.0},   # strike 1 again — still armed
    ])
    tuner = runtime.RuntimeTuner(lambda: next(snaps),
                                 targets=(_lever_target(lever),),
                                 armed=True, guard_pct=25.0, hysteresis=2)
    for _ in range(5):
        tuner.step()
    assert tuner.reverted is False and tuner.armed is True
    assert lever.reverts == 0


def test_runtime_tuner_disarmed_is_bit_identical():
    calls = []
    tuner = runtime.RuntimeTuner(lambda: calls.append(1))
    assert tuner.armed is False          # off by default
    assert tuner.start() is None         # no thread
    assert tuner._thread is None
    assert tuner.step() == "disarmed"
    assert calls == []                   # snapshot never taken
    assert tuner.steps == 0


def test_runtime_targets_wrap_the_existing_policies():
    class FakeServer:
        def __init__(self):
            self.resets = 0

        def reset_window(self):
            self.resets += 1

    class FakeAdmission:
        def __init__(self):
            self.reconfigured = None

        def stats(self):
            return {"interactive_rate": 100.0, "bulk_rate": 50.0,
                    "queue_watermark": 64}

        def reconfigure(self, **kw):
            self.reconfigured = kw

    server = FakeServer()
    runtime.coalesce_target(server).revert()
    assert server.resets == 1

    adm = FakeAdmission()
    target = runtime.admission_target(adm)
    target.observe({"rounds": 1, "wall_s": 1.0})  # no calibration: no-op
    assert adm.reconfigured is None
    target.revert()
    assert adm.reconfigured == {"interactive_rate": 100.0,
                                "bulk_rate": 50.0, "queue_watermark": 64}


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def test_cli_validate_passes():
    assert autotune_cli.main(["--validate"]) == 0


def test_cli_mock_run_appends_and_replays(tmp_path, capsys):
    verdict = {"first_bottleneck": "replicate",
               "bottlenecks": [
                   {"cause": "replicate",
                    "experiment": doctor.suggest_spec("replicate")}]}
    vpath = tmp_path / "verdict.json"
    vpath.write_text(json.dumps(verdict))
    store = tmp_path / "TRAJECTORY.jsonl"
    out = tmp_path / "AUTOTUNE.json"

    argv = [str(vpath), "--mock", "monotone", "--budget", "3",
            "--seed", "5", "--out", str(out),
            "--trajectory", str(store)]
    assert autotune_cli.main(argv) == 0
    line = capsys.readouterr().out.strip()
    assert len(line.splitlines()) == 1  # one-JSON-line contract
    first = json.loads(line)
    assert first["experiment_id"] == "widen_replication_window"
    assert first["runner"] == {"mock": "monotone"}
    saved = json.loads(out.read_text())
    assert saved["decision_sequence"] == first["decision_sequence"]
    records = doctor.load_trajectory(str(store))
    assert len(records) == 1 and records[0]["kind"] == "autotune"

    # Replay: same seed, same surface — identical decisions, and the
    # store now bands run 2 against run 1.
    assert autotune_cli.main(argv) == 0
    second = json.loads(capsys.readouterr().out.strip())
    assert second["decision_sequence"] == first["decision_sequence"]
    assert len(doctor.load_trajectory(str(store))) == 2


def test_cli_abstained_verdict_needs_explore(tmp_path, capsys):
    vpath = tmp_path / "verdict.json"
    vpath.write_text(json.dumps({"bottlenecks": []}))
    assert autotune_cli.main([str(vpath), "--mock", "monotone",
                              "--no-append"]) == 2
    capsys.readouterr()
    assert autotune_cli.main([str(vpath), "--mock", "monotone",
                              "--explore", "--no-append"]) == 0
    result = json.loads(capsys.readouterr().out.strip())
    assert result["experiment_id"] == "explore_defaults"


# ---------------------------------------------------------------------------
# The two packages side by side.
# ---------------------------------------------------------------------------


def _without_paths(knob):
    """A knob's fields with the module path of an env target dropped."""
    fields = dict(knob.__dict__)
    kind, *rest = fields["target"].split(":")
    if kind == "env":
        fields["target"] = f"env:{rest[0]}"
    return fields


def test_registry_equals_jax_but_for_module_paths():
    from corda_tpu.autotune import space as jspace

    assert list(space.KNOBS) == list(jspace.KNOBS)
    for name, knob in space.KNOBS.items():
        assert _without_paths(knob) == _without_paths(jspace.KNOBS[name])
        if knob.target.startswith("env:"):
            module = knob.target.split(":")[2]
            assert module.startswith("corda_tpu_torch."), knob.target
            assert jspace.KNOBS[name].target.split(":")[2] == \
                "corda_tpu." + module[len("corda_tpu_torch."):]
    assert space.__all__ == jspace.__all__


def test_port_registry_validates_clean():
    assert space.validate_registry() == []


@pytest.mark.parametrize("surface,seed,budget", [
    ("monotone", 0, 4), ("noisy", 1234, 5), ("regressing", 7, 3),
    ("cliff", 99, 6)])
def test_seeded_search_equal_jax(surface, seed, budget):
    from corda_tpu.autotune import controller as jcontroller

    spec = controller.exploratory_spec()
    jspec = jcontroller.exploratory_spec()
    assert spec.__dict__ == jspec.__dict__
    mine = controller.run_autotune(
        spec, controller.make_mock_runner(spec, surface), budget=budget,
        seed=seed)
    theirs = jcontroller.run_autotune(
        jspec, jcontroller.make_mock_runner(jspec, surface), budget=budget,
        seed=seed)
    assert mine["decision_sequence"] == theirs["decision_sequence"]
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)


def test_spec_from_a_verdict_equal_jax():
    from corda_tpu.autotune import controller as jcontroller
    from corda_tpu.obs import doctor as jdoctor

    for cause in ("replicate", "rounds", "device_occupancy", "vault_scan"):
        verdict = {"first_bottleneck": cause, "bottlenecks": [
            {"cause": cause, "experiment": doctor.suggest_spec(cause)}]}
        jverdict = {"first_bottleneck": cause, "bottlenecks": [
            {"cause": cause, "experiment": jdoctor.suggest_spec(cause)}]}
        assert verdict == jverdict
        mine = controller.spec_from_verdict(verdict)
        theirs = jcontroller.spec_from_verdict(jverdict)
        assert (mine and mine.__dict__) == (theirs and theirs.__dict__)


def test_env_knob_reaches_the_port_sidecar_client(monkeypatch):
    """batch.device_min_sigs travels as CORDA_TPU_SIDECAR_MIN_SIGS: one
    environment gives the same crossover in both packages' clients."""
    from corda_tpu.node.verify_client import SidecarVerifier as JaxClient
    from corda_tpu_torch.node.verify_client import SidecarVerifier

    env = space.env_for({"batch.device_min_sigs": 64})
    assert env == {"CORDA_TPU_SIDECAR_MIN_SIGS": "64"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert SidecarVerifier("/nonexistent").device_min_sigs == 64
    assert JaxClient("/nonexistent").device_min_sigs == 64
    monkeypatch.delenv("CORDA_TPU_SIDECAR_MIN_SIGS")
    assert SidecarVerifier("/nonexistent").device_min_sigs == \
        JaxClient("/nonexistent").device_min_sigs == 16
    assert SidecarVerifier("/nonexistent",
                           device_min_sigs=3).device_min_sigs == 3
