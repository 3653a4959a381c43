"""The port's perf doctor (corda_tpu_torch/obs/doctor.py,
corda_tpu_torch/tools/perfdoctor.py): the cases of tests/test_perf_doctor.py
on the port, then both packages side by side.

The reference's cases, as it states them:

  * backfill over the nine checked-in artifacts reproduces the two
    known diagnoses — the r05 flagship kernel-gap (sidecar-era
    occupancy bottleneck) and INGEST_r15's ``first_bottleneck =
    "rounds"`` server wall;
  * the verdict machinery is honest arithmetic — roofline gap factors,
    rule-table attribution on synthetic breakdowns, abstention below
    the min-rounds floor;
  * the gate exits nonzero on a synthetic >=20% regression and zero on
    the real trajectory.

Side by side: both packages' ``diagnose``, ``normalize_record`` and
``gate`` give equal JSON over every checked-in artifact and every
``BENCH_r0*.json``, and the port's backfill into a temporary store
reproduces ``artifacts/TRAJECTORY.jsonl`` line for line. Every store
these cases write lies under ``tmp_path``. Tolerance: exact equality.
"""

import json
import os

import pytest

from corda_tpu.obs import doctor as jdoctor
from corda_tpu.tools import perfdoctor as jperfdoctor
from corda_tpu_torch.obs import doctor
from corda_tpu_torch.tools import perfdoctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")


# ---------------------------------------------------------------------------
# Backfill over the checked-in history
# ---------------------------------------------------------------------------


def test_backfill_covers_all_checked_in_artifacts(tmp_path, capsys):
    store = tmp_path / "TRAJECTORY.jsonl"
    code = perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)])
    assert code == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["skipped"] == []
    records = doctor.load_trajectory(str(store))
    assert len(records) == 9
    sources = [r["source"] for r in records]
    # Deterministic chronological order: (round, filename).
    assert sources == sorted(
        sources, key=lambda s: (doctor._round_of({}, s), s))
    assert {r["kind"] for r in records} == {
        "autotune", "bench_report", "flagship_capture", "ingest_sweep",
        "multichip_capture"}
    # Idempotent: a re-run rebuilds the identical store.
    before = store.read_text()
    assert perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)]) == 0
    assert store.read_text() == before


def test_backfill_reproduces_known_diagnoses(tmp_path):
    store = tmp_path / "TRAJECTORY.jsonl"
    assert perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)]) == 0
    by_source = {r["source"]: r
                 for r in doctor.load_trajectory(str(store))}
    # The r05 flagship kernel-gap: every r05 report diagnoses the
    # sidecar-era occupancy bottleneck (micro-batches host-routed).
    for letter in "abcde":
        rec = by_source[f"BENCH_r05_local_{letter}.json"]
        assert rec["verdict"]["first_bottleneck"] == "device_occupancy"
    # The flagship report's gap factor is the measured ~100x kernel gap.
    assert by_source["BENCH_r05_local_e.json"]["verdict"][
        "gap_factor"] == pytest.approx(100.0, rel=0.01)
    # INGEST_r15: the server wall — unanimous busiest_stage across the
    # member stamps.
    assert by_source["INGEST_r15_local.json"]["verdict"][
        "first_bottleneck"] == "rounds"
    # The r06 sidecar flagship ran at occupancy 1.0: no occupancy
    # verdict, and nothing else implicated — an honest None.
    assert by_source["BENCH_r06_flagship_sidecar_local.json"][
        "verdict"]["first_bottleneck"] is None


def test_checked_in_trajectory_matches_backfill(tmp_path):
    """The committed artifacts/TRAJECTORY.jsonl IS the backfill output —
    regenerating it must be a no-op (anything else means the store in
    the tree is stale relative to the doctor's schema)."""
    committed = os.path.join(ARTIFACTS, "TRAJECTORY.jsonl")
    assert os.path.exists(committed), (
        "artifacts/TRAJECTORY.jsonl missing — run "
        "`python -m corda_tpu_torch.tools.perfdoctor --backfill artifacts/`")
    store = tmp_path / "TRAJECTORY.jsonl"
    assert perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)]) == 0
    assert store.read_text() == open(committed, encoding="utf-8").read()


# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------


def test_roofline_gap_and_layer_attribution():
    signals = {"kind": "bench_report",
               "ceiling_sigs_per_sec": 100_000.0,
               "ceiling_source": "kernel_stream",
               "e2e_sigs_per_sec": 2_000.0,
               "committed_tx_per_sec": 40.0,
               "device_occupancy_by_member": {"Raft0": 0.5}}
    verdict = doctor.diagnose(signals)
    roof = verdict["roofline"]
    assert roof["gap_factor"] == 50.0
    # Occupancy 0.5 explains a 2x slice of the gap; the remaining 25x is
    # attributed to nothing — residual, not invented precision.
    assert roof["layers"]["verify_routing_factor"] == 2.0
    assert roof["layers"]["residual_factor"] == 25.0
    assert verdict["first_bottleneck"] == "device_occupancy"


def test_roofline_zero_occupancy_attributes_whole_gap():
    signals = {"ceiling_sigs_per_sec": 10_000.0,
               "e2e_sigs_per_sec": 1_000.0,
               "device_occupancy_by_member": {"N": 0.0}}
    roof = doctor.diagnose(signals)["roofline"]
    assert roof["gap_factor"] == 10.0
    assert roof["layers"]["verify_routing_factor"] == 10.0
    assert roof["layers"]["residual_factor"] == 1.0


def test_roofline_abstains_without_both_sides():
    roof = doctor.diagnose({"e2e_sigs_per_sec": 500.0})["roofline"]
    assert roof["gap_factor"] is None and roof["layers"] is None


# ---------------------------------------------------------------------------
# Rule-table attribution on synthetic signals
# ---------------------------------------------------------------------------


def _breakdown(shares, rounds=100):
    wall = 10.0
    return {"rounds": rounds, "wall_s": wall,
            "phases": {p: {"total_s": wall * s, "share": s}
                       for p, s in shares.items()}}


def test_dominant_seal_phase_maps_to_amortization_rule():
    stamps = {"Raft0": {"round_breakdown": _breakdown(
        {"seal": 0.6, "replicate": 0.2, "apply": 0.1})}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "seal"
    top = verdict["bottlenecks"][0]
    assert "amortization" in top["next_experiment"]
    assert top["evidence"]["round_breakdown_shares"]["seal"] == 0.6


def test_breakdown_below_min_rounds_abstains():
    stamps = {"Raft0": {"round_breakdown": _breakdown(
        {"seal": 0.9}, rounds=doctor.MIN_ATTRIBUTION_ROUNDS - 1)}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] is None
    assert verdict["bottlenecks"] == []


def test_low_occupancy_outranks_minor_phase():
    stamps = {"Raft0": {"device_batches": 1, "host_batches": 9,
                        "round_breakdown": _breakdown(
                            {"seal": 0.35, "poll": 0.3})}}
    verdict = doctor.stamp_attribution(stamps)
    # Occupancy 0.1 scores 0.9; seal at share 0.35 scores 0.675.
    assert verdict["first_bottleneck"] == "device_occupancy"
    causes = [b["cause"] for b in verdict["bottlenecks"]]
    assert causes == ["device_occupancy", "seal"]
    assert "coalesce" in verdict["bottlenecks"][0]["next_experiment"]


def test_shed_dominated_admission_maps_to_recalibration_rule():
    stamps = {"Notary": {"admission": {"admitted_interactive": 50,
                                       "admitted_bulk": 10,
                                       "shed_interactive": 0,
                                       "shed_bulk": 40}}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "admission"
    top = verdict["bottlenecks"][0]
    assert top["evidence"]["shed_fraction"] == 0.4
    assert "calibrate_admission" in top["next_experiment"]


def test_pad_fraction_rule_fires_from_artifact_signals():
    verdict = doctor.diagnose({"pad_fraction": 0.45,
                               "batch_sigs_hist": {"256": 10}})
    assert verdict["first_bottleneck"] == "pad_fraction"
    assert "bucket ladder" in verdict["bottlenecks"][0]["next_experiment"]


def test_unknown_stage_gets_generic_suggestion():
    stamps = {"A": {"busiest_stage": "wire_decode"}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "wire_decode"
    assert "wire_decode" in verdict["bottlenecks"][0]["next_experiment"]


def test_pipelined_rounds_verdict_suggests_executor_levers():
    """Round 18: a "rounds" verdict from members stamping pipeline=true
    must suggest the NEXT experiment (apply-queue depth / native
    commit_many sweep) — re-suggesting round-loop amortization the
    pipelined plane has already applied would send the operator in a
    circle."""
    stamps = {"Raft0": {"busiest_stage": "rounds",
                        "raft": {"pipeline": True, "role": "leader"}},
              "Raft1": {"busiest_stage": "rounds",
                        "raft": {"pipeline": True, "role": "follower"}}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "rounds"
    top = verdict["bottlenecks"][0]
    assert "apply_queue_depth" in top["next_experiment"]
    assert "commit_many" in top["next_experiment"]
    assert "amortize" not in top["next_experiment"]


def test_serial_rounds_verdict_keeps_round_loop_amortization_rule():
    stamps = {"Raft0": {"busiest_stage": "rounds",
                        "raft": {"pipeline": False}}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "rounds"
    top = verdict["bottlenecks"][0]
    # The serial loop still gets the amortization suggestion verbatim.
    assert top["next_experiment"] == doctor.RULES["rounds"]
    assert "apply_queue_depth" not in top["next_experiment"]


def test_pipelined_dominant_apply_phase_maps_to_executor_rule():
    stamps = {"Raft0": {"raft": {"pipeline": True},
                        "round_breakdown": _breakdown(
                            {"apply": 0.6, "seal": 0.1, "poll": 0.1})}}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "apply"
    top = verdict["bottlenecks"][0]
    assert "apply_queue_depth" in top["next_experiment"]
    assert "commit_many" in top["next_experiment"]
    # The same breakdown WITHOUT the pipeline stamp keeps the serial rule.
    serial = doctor.stamp_attribution(
        {"Raft0": {"round_breakdown": _breakdown(
            {"apply": 0.6, "seal": 0.1, "poll": 0.1})}})
    assert serial["bottlenecks"][0]["next_experiment"] \
        == doctor.RULES["apply"]


def _fed_stamp(shares, occs=None, dispatches_total=100):
    """A member stamp whose sidecar block carries a federation routing
    view (FederatedVerifier.federation_stats shape, trimmed)."""
    hosts = {}
    for i, (addr, share) in enumerate(sorted(shares.items())):
        hosts[addr] = {"dispatches": int(share * dispatches_total),
                       "server": ({"device_batches": None,
                                   "device_occupancy": (occs or {}).get(addr)}
                                  if occs else None)}
    return {"sidecar": {"federation": {
        "hosts": hosts, "hedges": 7, "host_degraded": 0}}}


def test_host_imbalance_rule_fires_on_routing_share_skew():
    stamps = {"Notary": _fed_stamp(
        {"h0.sock": 0.8, "h1.sock": 0.2},
        occs={"h0.sock": 0.9, "h1.sock": 0.2})}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "host_imbalance"
    top = verdict["bottlenecks"][0]
    # Skew 0.6 -> score 0.8; the experiment names the two levers.
    assert top["score"] == 0.8
    assert "rebalance" in top["next_experiment"]
    assert "hedge" in top["next_experiment"]
    # Evidence pairs each host's routed share with its own occupancy.
    assert top["evidence"]["routing_share_by_host"] == {
        "h0.sock": 0.8, "h1.sock": 0.2}
    assert top["evidence"]["occupancy_by_host"] == {
        "h0.sock": 0.9, "h1.sock": 0.2}
    assert top["evidence"]["hedges"] == 7


def test_host_imbalance_abstains_on_balanced_routing():
    stamps = {"Notary": _fed_stamp({"h0.sock": 0.55, "h1.sock": 0.45})}
    verdict = doctor.stamp_attribution(stamps)
    # Skew 0.1 < threshold: the router's depth balancing is working.
    assert all(b["cause"] != "host_imbalance"
               for b in verdict["bottlenecks"])
    # Single-host "federations" and sidecar-less members never fire it.
    assert doctor.stamp_attribution(
        {"A": _fed_stamp({"h0.sock": 1.0})})["first_bottleneck"] is None
    assert doctor.stamp_attribution(
        {"A": {"sidecar": None}})["first_bottleneck"] is None


def test_host_imbalance_merges_dispatches_across_members():
    # Two members each skewed toward a DIFFERENT host: the cluster-wide
    # routing is balanced, so the merged verdict must abstain — a
    # per-member diagnosis would fire twice and be wrong both times.
    stamps = {"A": _fed_stamp({"h0.sock": 0.8, "h1.sock": 0.2}),
              "B": _fed_stamp({"h0.sock": 0.2, "h1.sock": 0.8})}
    verdict = doctor.stamp_attribution(stamps)
    assert all(b["cause"] != "host_imbalance"
               for b in verdict["bottlenecks"])
    # Both skewed the SAME way sums to a cluster-wide imbalance.
    stamps = {"A": _fed_stamp({"h0.sock": 0.8, "h1.sock": 0.2}),
              "B": _fed_stamp({"h0.sock": 0.7, "h1.sock": 0.3})}
    verdict = doctor.stamp_attribution(stamps)
    assert verdict["first_bottleneck"] == "host_imbalance"
    assert verdict["bottlenecks"][0]["evidence"][
        "routing_share_by_host"] == {"h0.sock": 0.75, "h1.sock": 0.25}


def test_stamp_attribution_empty_and_scalar_polluted_stamps():
    assert doctor.stamp_attribution({})["first_bottleneck"] is None
    assert doctor.stamp_attribution(None)["first_bottleneck"] is None
    # Historical artifacts carry scalar siblings among the member dicts.
    verdict = doctor.stamp_attribution(
        {"device_warm_wait_s": 3.2,
         "Raft0": {"busiest_stage": "fsync"}})
    assert verdict["members"] == 1
    assert verdict["first_bottleneck"] == "fsync"


# ---------------------------------------------------------------------------
# Gate exit codes
# ---------------------------------------------------------------------------


def _rec(kind, source, **metrics):
    return {"schema": doctor.SCHEMA_VERSION, "kind": kind,
            "source": source, "round": None, "metrics": metrics,
            "verdict": {"first_bottleneck": None, "bottlenecks": [],
                        "gap_factor": None}}


def _write_store(path, records):
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_gate_trips_on_20pct_p99_regression(tmp_path, capsys):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        _rec("ingest_sweep", "old.json", p99_ms=100.0,
             peak_achieved_tx_s=200.0),
        _rec("ingest_sweep", "new.json", p99_ms=125.0,  # +25% > 20% band
             peak_achieved_tx_s=200.0)])
    code = perfdoctor.main(["--gate", "--trajectory", str(store)])
    assert code == 1
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["ok"] is False
    hit = verdict["regressions"][0]
    assert hit["metric"] == "p99_ms" and hit["change_pct"] == 25.0


def test_gate_trips_on_sigs_per_sec_drop(tmp_path):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        _rec("bench_report", "old.json", flagship_sigs_per_sec=1000.0),
        _rec("bench_report", "new.json", flagship_sigs_per_sec=750.0)])
    assert perfdoctor.main(["--gate", "--trajectory", str(store)]) == 1


def test_gate_passes_inside_band_and_compares_only_newest_pair(tmp_path,
                                                               capsys):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        # An ancient catastrophic record must NOT trip the gate — only
        # the newest pair of each kind is judged.
        _rec("bench_report", "ancient.json", flagship_sigs_per_sec=9e9),
        _rec("bench_report", "old.json", flagship_sigs_per_sec=1000.0,
             flagship_p99_ms=200.0),
        _rec("bench_report", "new.json", flagship_sigs_per_sec=850.0,
             flagship_p99_ms=230.0)])  # -15% and +15%: inside the band
    assert perfdoctor.main(["--gate", "--trajectory", str(store)]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["ok"] is True
    assert verdict["compared"]["bench_report"] == {
        "prev": "old.json", "new": "new.json"}


def test_gate_never_compares_across_kinds(tmp_path):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        _rec("bench_report", "bench.json", p99_ms=10.0),
        _rec("ingest_sweep", "ingest.json", p99_ms=6000.0)])
    assert perfdoctor.main(["--gate", "--trajectory", str(store)]) == 0


def test_gate_equal_metric_trips_on_flag_flip(tmp_path):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        _rec("ingest_sweep", "old.json", exactly_once_all=True),
        _rec("ingest_sweep", "new.json", exactly_once_all=False)])
    assert perfdoctor.main(["--gate", "--trajectory", str(store)]) == 1


def test_gate_policy_override(tmp_path):
    store = tmp_path / "t.jsonl"
    _write_store(store, [
        _rec("ingest_sweep", "old.json", p99_ms=100.0),
        _rec("ingest_sweep", "new.json", p99_ms=125.0)])
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps(
        {"p99_ms": {"direction": "lower", "pct": 50.0}}))
    assert perfdoctor.main(["--gate", "--trajectory", str(store),
                            "--policy", str(policy)]) == 0


def test_gate_exits_zero_on_real_trajectory(tmp_path):
    """The acceptance criterion: the checked-in history passes the gate
    (rebuilt fresh so this cannot silently test a stale store)."""
    store = tmp_path / "TRAJECTORY.jsonl"
    assert perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)]) == 0
    assert perfdoctor.main(["--gate", "--trajectory", str(store)]) == 0


def test_gate_errors_cleanly_without_store(tmp_path, capsys):
    code = perfdoctor.main(["--gate", "--trajectory",
                            str(tmp_path / "absent.jsonl")])
    assert code == 2
    assert "backfill" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Diagnose CLI + store plumbing
# ---------------------------------------------------------------------------


def test_diagnose_cli_one_verdict_line_per_artifact(capsys):
    code = perfdoctor.main([
        os.path.join(ARTIFACTS, "BENCH_r05_local_e.json"),
        os.path.join(ARTIFACTS, "INGEST_r15_local.json")])
    assert code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    first, second = (json.loads(line) for line in lines)
    assert first["first_bottleneck"] == "device_occupancy"
    assert first["roofline"]["gap_factor"] == pytest.approx(100.0,
                                                            rel=0.01)
    assert second["first_bottleneck"] == "rounds"


def test_load_trajectory_rejects_corruption(tmp_path):
    store = tmp_path / "t.jsonl"
    store.write_text('{"kind": "bench_report"}\nnot json\n')
    with pytest.raises(ValueError, match="malformed"):
        doctor.load_trajectory(str(store))


def test_append_then_load_round_trips(tmp_path):
    store = tmp_path / "nested" / "t.jsonl"
    rec = _rec("bench_report", "x.json", value_sigs_per_sec=1.0)
    doctor.append_trajectory(str(store), rec)
    doctor.append_trajectory(str(store), rec)
    assert doctor.load_trajectory(str(store)) == [rec, rec]


# ---------------------------------------------------------------------------
# Partition plane (round 20): election churn rule + partition_chaos gate
# ---------------------------------------------------------------------------


def _raft_stamp(**kw):
    base = {"term": 2, "elections_won": 1, "leader_stepdowns": 0,
            "checkquorum_stepdowns": 0, "prevote_rejections": 0,
            "commit_index": 100, "prevote": False}
    base.update(kw)
    return base


def test_election_churn_rule_fires_on_disturbed_leadership():
    stamps = {f"m{i}": {"raft": _raft_stamp(elections_won=2,
                                            leader_stepdowns=1,
                                            term=9)}
              for i in range(3)}
    verdict = doctor.stamp_attribution(stamps)
    churn = next(b for b in verdict["bottlenecks"]
                 if b["cause"] == "election_churn")
    assert churn["evidence"]["elections_won"] == 6
    assert churn["evidence"]["max_term"] == 9
    assert "prevote" in churn["next_experiment"]


def test_election_churn_abstains_on_healthy_or_idle_clusters():
    # One clean election per group (the winner stamps it; a 4-shard run
    # sums to 4): not churn.
    healthy = {f"m{i}": {"raft": _raft_stamp(
        elections_won=1 if i % 3 == 0 else 0)} for i in range(12)}
    assert not any(b["cause"] == "election_churn" for b in
                   doctor.stamp_attribution(healthy)["bottlenecks"])
    # Plenty of elections but almost no committed work: a near-idle
    # bootstrap, below the MIN_ATTRIBUTION_ROUNDS abstention floor.
    idle = {f"m{i}": {"raft": _raft_stamp(elections_won=5,
                                          commit_index=3)}
            for i in range(3)}
    assert not any(b["cause"] == "election_churn" for b in
                   doctor.stamp_attribution(idle)["bottlenecks"])


def test_partition_chaos_metrics_hoist_and_gate_on_linearizability():
    art = {"metric": "verified_sigs_per_sec", "value": 100.0,
           "partition_chaos": {"recovery_s": 0.2, "max_term_inflation": 1,
                               "minority_commits": 0, "lost_acks": 0,
                               "history_linearizable": True}}
    rec1 = doctor.normalize_record(art, "r20_a.json")
    m = rec1["metrics"]
    assert m["recovery_s"] == 0.2
    assert m["max_term_inflation"] == 1.0
    assert m["history_linearizable"] is True

    art2 = dict(art)
    art2["partition_chaos"] = dict(
        art["partition_chaos"], history_linearizable=False,
        max_term_inflation=9)
    rec2 = doctor.normalize_record(art2, "r20_b.json")
    verdict = doctor.gate([rec1, rec2])
    assert not verdict["ok"]
    tripped = {r["metric"] for r in verdict["regressions"]}
    assert "history_linearizable" in tripped  # the hard flag
    assert "max_term_inflation" in tripped    # the banded A/B bound


# ---------------------------------------------------------------------------
# The two packages side by side
# ---------------------------------------------------------------------------

def _artifact_paths():
    names = sorted(n for n in os.listdir(ARTIFACTS) if n.endswith(".json"))
    paths = [os.path.join(ARTIFACTS, n) for n in names]
    paths += sorted(os.path.join(REPO, n) for n in os.listdir(REPO)
                    if n.startswith("BENCH_r0") and n.endswith(".json"))
    return paths


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


@pytest.mark.parametrize("path", _artifact_paths(),
                         ids=lambda p: os.path.basename(p))
def test_diagnose_and_record_equal_jax(path):
    artifact = _load(path)
    source = os.path.basename(path)
    signals = doctor.extract_signals(artifact)
    assert _canon(signals) == _canon(jdoctor.extract_signals(artifact))
    assert _canon(doctor.diagnose(signals)) == _canon(
        jdoctor.diagnose(jdoctor.extract_signals(artifact)))
    assert _canon(doctor.normalize_record(artifact, source=source)) == \
        _canon(jdoctor.normalize_record(artifact, source=source))


def test_gate_over_every_artifact_equal_jax():
    records = [doctor.normalize_record(_load(p), source=os.path.basename(p))
               for p in _artifact_paths()]
    jrecords = [jdoctor.normalize_record(_load(p),
                                         source=os.path.basename(p))
                for p in _artifact_paths()]
    assert _canon(doctor.gate(records)) == _canon(jdoctor.gate(jrecords))
    # A copied flagship record with p99 x 1.25 fails both gates alike.
    worse = json.loads(json.dumps(records[-1]))
    for k, v in worse["metrics"].items():
        if k.endswith("p99_ms") and isinstance(v, (int, float)):
            worse["metrics"][k] = v * 1.25
    assert _canon(doctor.gate(records + [worse])) == _canon(
        jdoctor.gate(jrecords + [worse]))


def test_port_backfill_reproduces_the_trajectory_line_for_line(tmp_path):
    store = tmp_path / "TRAJECTORY.jsonl"
    assert perfdoctor.main(["--backfill", ARTIFACTS,
                            "--trajectory", str(store)]) == 0
    with open(os.path.join(ARTIFACTS, "TRAJECTORY.jsonl"),
              encoding="utf-8") as f:
        committed = f.read().splitlines()
    assert store.read_text().splitlines() == committed


def test_cli_verdict_equal_jax(capsys):
    path = os.path.join(ARTIFACTS, "BENCH_r05_local_e.json")
    assert perfdoctor.main([path]) == 0
    mine = capsys.readouterr().out
    assert jperfdoctor.main([path]) == 0
    assert mine == capsys.readouterr().out
