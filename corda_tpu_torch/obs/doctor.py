"""The performance doctor: cross-layer bottleneck attribution, the bench
trajectory store, and regression gating.

The other obs modules *collect* signals — trace spans (trace.py/collect.py),
the always-on telemetry registry + round profiler (telemetry.py/export.py),
sidecar occupancy/pad stats and transport/admission counters riding
node_metrics. None of them says what to DO next: the north-star metrics
(verified sigs/sec/chip, p99 notarise latency) bottom out in a diagnosis
problem, and until this module the diagnosis lived in a human re-reading
bench JSON by hand. Three pieces close that loop:

  * **Attribution** — ``diagnose`` fuses whatever signals a run produced
    into one machine-readable ``PerfVerdict``: a roofline (committed tx/s
    and e2e sigs/s against the measured kernel-stream ceiling, with the
    gap factored per layer) plus a ranked ``bottlenecks`` list where every
    entry carries the specific counters/stages that implicate it and the
    next experiment from the rule table below. ``stamp_attribution`` is
    the loadtest-facing subset over member stamps — the evidence-ranked
    replacement for the Counter-majority ``busiest_stage`` heuristic
    (``first_bottleneck`` now means "top of the doctor's ranked list").
  * **Trajectory store** — ``normalize_record`` hoists the
    schema-versioned key metrics out of any known artifact shape into one
    flat record; ``append_trajectory`` grows the append-only
    ``artifacts/TRAJECTORY.jsonl`` one record per bench run, and the
    backfill tool (tools/perfdoctor.py) ingests the checked-in history so
    the trajectory starts with every capture we already have.
  * **Gate** — ``gate`` compares each kind's newest record against its
    predecessor under a tolerance policy (per-metric direction + percent
    band) and reports regressions; ``perfdoctor --gate`` exits nonzero on
    any, which is the CI hook every subsequent perf PR is judged with.

The rule table (cause -> suggested next experiment) is deliberately
small and literal — each rule names the knob that exists in this tree:

  low ``device_occupancy``      -> coalesce/bucket ladder (sidecar window,
                                   adaptive_coalesce, bucket growth from
                                   the observed batch_sigs_hist)
  dominant ``seal``/``replicate`` round phases
                                -> round-loop amortization (group commit
                                   density, pipelined replication window)
  high ``pad_fraction``         -> bucket-ladder growth (mesh pad waste)
  shed-dominated admission      -> admission recalibration
                                   (qos/calibrate.calibrate_admission)
  busiest round stage majority  -> the stage's own knob (fsync -> group
                                   commit; verify -> device routing; the
                                   "rounds" wall -> per-round overhead)

Everything here is honest about missing evidence: no signal, no verdict —
``first_bottleneck`` stays None rather than guessing, and attribution
abstains below ``MIN_ATTRIBUTION_ROUNDS`` exactly like the legacy
heuristic did (a 2-sample stage must never steer a sweep verdict).

Stdlib-only like the rest of ``obs`` — the CLI and the analyzer import
this module from bare processes.

The port's own copy of ``corda_tpu/obs/doctor.py``: the same signals,
rules, roofline, record schema and gate. The roofline's ceiling is the
artifact's own ``e2e_stream_sigs_per_sec``; a run on the card must stamp
the card's measured stream rate there.
"""

from __future__ import annotations

import json
import os
import re

__all__ = [
    "DEFAULT_POLICY",
    "MIN_ATTRIBUTION_ROUNDS",
    "PIPELINED_RULE_SPECS",
    "RULES",
    "RULE_SPECS",
    "SCHEMA_VERSION",
    "append_trajectory",
    "diagnose",
    "extract_signals",
    "gate",
    "load_trajectory",
    "normalize_record",
    "stamp_attribution",
    "suggest_spec",
    "trajectory_delta",
]

SCHEMA_VERSION = 1

# Mirrors loadtest.BUSIEST_STAGE_MIN_ROUNDS (which now imports THIS
# constant): below this many profiled rounds every round-derived signal
# (busiest stage, round_breakdown shares) abstains.
MIN_ATTRIBUTION_ROUNDS = 20

# Occupancy below this is a routing bottleneck worth a verdict entry;
# at/above it the device tier is essentially fed.
_OCCUPANCY_HEALTHY = 0.9
# Mesh pad waste below this is noise; above it the bucket ladder is
# fighting the batch mix.
_PAD_WORTH_FLAGGING = 0.2
# A round phase must claim at least this share of attributed wall time
# to earn its own verdict entry.
_PHASE_DOMINANT_SHARE = 0.3
# Sheds below this fraction of admission decisions are the controller
# doing its job; above it the rates are mis-calibrated for the load.
_SHED_DOMINATED = 0.2
# Federation routing-share skew (max share - min share across hosts)
# worth flagging: below this the router's depth balancing is doing its
# job; above it one host is soaking the traffic — a slow host attracting
# hedged re-dispatches, or a depth signal gone stale.
_HOST_IMBALANCE_SKEW = 0.25
# Elections won plus leader step-downs summed across members at/above
# this count in one run is churn: a healthy loadtest elects each group's
# leader ONCE and keeps it (sum ~= group count, and sharded runs top out
# at 4 groups), so 5 clears every clean shape while real disturbance —
# partition flap, starved heartbeats, a rejoiner spinning terms — blows
# straight past it.
_ELECTION_CHURN_MIN = 5
# A flow stage (trace stage_breakdown) must claim at least this share of
# end-to-end flow wall time to nominate a cause — vault_query at/above
# it means coin selection/queries are scanning, not indexing.
_FLOW_STAGE_DOMINANT_SHARE = 0.25

# ---------------------------------------------------------------------------
# The rule table: cause -> the suggested next experiment. Causes either
# name a signal ("device_occupancy", "pad_fraction", "admission") or a
# round stage/phase ("rounds", "seal", "replicate", "fsync", ...); a
# stage with no entry gets the generic suggestion so an unknown stage
# still produces an actionable verdict instead of a KeyError.
# ---------------------------------------------------------------------------

RULES: dict = {
    "device_occupancy": (
        "grow the coalesce/bucket ladder from the observed "
        "batch_sigs_hist: raise the sidecar coalesce window (or arm "
        "adaptive_coalesce) so micro-batches reach device_min_sigs and "
        "chase device_occupancy -> 1.0"),
    "pad_fraction": (
        "grow the bucket ladder (ops pick_bucket) so coalesced batches "
        "land nearer bucket capacity — mesh pad lanes are burning chip "
        "time on zeros"),
    "admission": (
        "recalibrate admission from measured saturation "
        "(qos/calibrate.calibrate_admission over a fresh slo_sweep) — "
        "shed-dominated admission means the static rates are wrong for "
        "this load"),
    "rounds": (
        "amortize per-round overhead in the SMM round loop (the server "
        "wall): batch service polls, multi-core members, and re-run on "
        "hardware where the verify plane is not sharing one core"),
    "seal": (
        "round-loop amortization: raise group-commit density (raft "
        "group_commit / larger rounds) — the seal phase dominates the "
        "round"),
    "replicate": (
        "round-loop amortization: widen the pipelined-replication window "
        "/ append chunking (raft pipeline_window, append_chunk) — the "
        "replicate phase dominates the round"),
    "poll": (
        "the round loop is spinning on polls: coalesce service polls or "
        "raise the accumulation window (the loop is overhead-bound, not "
        "work-bound)"),
    "verify_wait": (
        "the round blocks on verification: raise async_verify depth / "
        "sidecar coalescing so the device pipeline overlaps the round"),
    "apply": (
        "the apply phase dominates: profile the uniqueness-provider "
        "commit path (sqlite batch writes, PutAllBatch sizing)"),
    "reply": (
        "the reply phase dominates: profile reply serialization and "
        "transport flush coalescing (send_many, bridge flush)"),
    "fsync": (
        "batch fsyncs through group commit (one fsync per sealed round) "
        "or move the log to faster storage — fsync dominates the round"),
    "verify": (
        "the verify stage dominates: raise device routing (sidecar "
        "cross-process coalescing, bucket ladder) so signatures leave "
        "the host tier"),
    "election_churn": (
        "harden leadership against disturbance: arm [raft] prevote=true "
        "(the pre-vote canvass stops a partitioned rejoiner deposing a "
        "live leader; check-quorum makes a quorumless leader cede) and "
        "A/B the partition_chaos bench — max_term_inflation should "
        "collapse to ~0 with prevote on while the noprevote leg tracks "
        "the cut count"),
    "host_imbalance": (
        "rebalance weights / raise hedge threshold: the federation "
        "router is concentrating verify traffic on a subset of hosts — "
        "check occupancy_by_host for a slow host soaking hedged "
        "re-dispatches, then rebalance the routing (drain/readmit the "
        "slow host) or raise CORDA_TPU_FEDERATION_HEDGE_MS so hedges "
        "stop amplifying the skew"),
    "vault_scan": (
        "vault queries dominate flow wall time — coin selection is "
        "scanning a vault that has outgrown the in-memory engine: arm "
        "[vault] indexed=true (sqlite IndexedVaultService — O(log n) "
        "covering-index queries, amount-ordered soft-locked coin "
        "selection, watermark incremental boot) and re-run; the "
        "vault_scaling bench section proves the crossover"),
}

_GENERIC_SUGGESTION = (
    "profile stage {cause!r} with --trace (obs/collect stage_breakdown) — "
    "no specific rule for it yet")

# Pipelined-commit-plane overlay (round 18): once the round loop overlaps
# (raft pipeline=true — mid-round seals, detached apply executor), the
# serial-loop suggestions above are ALREADY DONE. A run whose members
# stamp pipeline=true gets the NEXT experiment for these causes instead
# of re-suggesting round-loop amortization it has already applied.
PIPELINED_RULES: dict = {
    "rounds": (
        "the round loop is already pipelined — sweep the executor levers "
        "instead: [raft] apply_queue_depth (commit-queue bound) and the "
        "native commit_many columnar batch (CORDA_TPU_NO_NATIVE unset), "
        "then re-attribute; residual 'rounds' wall is scheduler/transport, "
        "not seal/apply serialization"),
    "seal": (
        "seals already overlap replication (mid-round seals) — tune "
        "append_chunk (mid-round seal trigger) and group-commit density "
        "rather than the round cadence"),
    "apply": (
        "apply is already detached onto the executor — sweep [raft] "
        "apply_queue_depth and profile the columnar commit_many path "
        "(set-wide conflict SELECTs, executemany inserts, native CRC "
        "batching)"),
}


def _suggest(cause: str, pipelined: bool = False) -> str:
    if pipelined:
        hit = PIPELINED_RULES.get(cause)
        if hit:
            return hit
    return RULES.get(cause) or _GENERIC_SUGGESTION.format(cause=cause)


# ---------------------------------------------------------------------------
# Structured rule specs (round 21): the machine-readable twin of each
# prose rule above — the experiment id, the autotune-registry knob names
# the experiment sweeps, and the harness that measures it. The autotune
# controller consumes THESE (never the prose, which stays a human
# rendering pinned byte-identical by test_perf_doctor.py); every knob
# name here must resolve in corda_tpu_torch.autotune.space.KNOBS, which
# validates the cross-reference so the two tables cannot drift apart.
# An empty knobs tuple means the experiment is not a parameter sweep
# (profiling, A/B flag flips, operational rebalancing).
# ---------------------------------------------------------------------------

RULE_SPECS: dict = {
    "device_occupancy": {
        "experiment_id": "grow_coalesce_ladder",
        "knobs": ("sidecar.coalesce_us", "batch.device_min_sigs"),
        "harness": "slo_sweep"},
    "pad_fraction": {
        "experiment_id": "grow_bucket_ladder",
        "knobs": ("batch.max_sigs", "batch.device_min_sigs"),
        "harness": "slo_sweep"},
    "admission": {
        "experiment_id": "calibrate_admission",
        "knobs": ("qos.interactive_rate", "qos.bulk_rate",
                  "qos.queue_watermark"),
        "harness": "slo_sweep"},
    "rounds": {
        "experiment_id": "amortize_round_overhead",
        # notary_shards.count is the prose remedy's bigger hammer, but
        # it only applies to raft-* notaries — the ingest harness runs
        # a simple notary, so the sweepable levers are the accumulation
        # window and the apply-queue depth.
        "knobs": ("batch.coalesce_ms", "raft.apply_queue_depth"),
        "harness": "ingest_sweep"},
    "seal": {
        "experiment_id": "raise_group_commit_density",
        "knobs": ("batch.coalesce_ms", "raft.append_chunk"),
        "harness": "ingest_sweep"},
    "replicate": {
        "experiment_id": "widen_replication_window",
        "knobs": ("raft.pipeline_window", "raft.append_chunk"),
        "harness": "ingest_sweep"},
    "poll": {
        "experiment_id": "raise_accumulation_window",
        "knobs": ("batch.coalesce_ms",),
        "harness": "ingest_sweep"},
    "verify_wait": {
        "experiment_id": "deepen_async_verify",
        "knobs": ("batch.async_depth", "sidecar.coalesce_us"),
        "harness": "ingest_sweep"},
    "apply": {
        "experiment_id": "profile_apply_path",
        "knobs": ("raft.apply_queue_depth",),
        "harness": "ingest_sweep"},
    "reply": {
        "experiment_id": "profile_reply_path",
        "knobs": (),
        "harness": "trace"},
    "fsync": {
        "experiment_id": "batch_fsyncs",
        "knobs": ("batch.coalesce_ms",),
        "harness": "ingest_sweep"},
    "verify": {
        "experiment_id": "raise_device_routing",
        "knobs": ("sidecar.coalesce_us", "batch.device_min_sigs"),
        "harness": "slo_sweep"},
    "election_churn": {
        "experiment_id": "arm_prevote_ab",
        "knobs": (),
        "harness": "partition_chaos"},
    "host_imbalance": {
        "experiment_id": "rebalance_federation",
        "knobs": (),
        "harness": "federation"},
    "vault_scan": {
        "experiment_id": "arm_indexed_vault",
        "knobs": ("vault.indexed",),
        "harness": "ingest_sweep"},
}

# Pipelined overlay, mirroring PIPELINED_RULES: once the commit plane
# overlaps, the same cause implicates the executor levers instead.
PIPELINED_RULE_SPECS: dict = {
    "rounds": {
        "experiment_id": "sweep_executor_levers",
        "knobs": ("raft.apply_queue_depth",),
        "harness": "ingest_sweep"},
    "seal": {
        "experiment_id": "tune_midround_seal_trigger",
        "knobs": ("raft.append_chunk",),
        "harness": "ingest_sweep"},
    "apply": {
        "experiment_id": "sweep_apply_queue_depth",
        "knobs": ("raft.apply_queue_depth",),
        "harness": "ingest_sweep"},
}

_GENERIC_SPEC = {"experiment_id": "profile_stage", "knobs": (),
                 "harness": "trace"}


def suggest_spec(cause: str, pipelined: bool = False) -> dict:
    """The structured spec for a cause — same lookup/fallback order as
    ``_suggest`` so the machine-readable field on a bottleneck entry
    always describes the same experiment as its prose twin."""
    if pipelined:
        hit = PIPELINED_RULE_SPECS.get(cause)
        if hit:
            return dict(hit)
    return dict(RULE_SPECS.get(cause) or _GENERIC_SPEC)


def _finite(value) -> float | None:
    """A float if ``value`` is a real number (bools excluded), else None."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value)


# ---------------------------------------------------------------------------
# Candidate construction: every rule emits (cause, score, evidence).
# Scores share one scale so the ranking is meaningful across rules:
# wall-time evidence (busiest stage / dominant phase / shed fraction)
# scores 0.5 + 0.5*fraction — direct measurement outranks ratio
# inference — while ratio evidence (occupancy, pad) scores its own
# deficit in [0, 1].
# ---------------------------------------------------------------------------


def _occupancy_of(stamp: dict) -> float | None:
    occ = _finite(stamp.get("device_occupancy"))
    if occ is not None:
        return occ
    dev = stamp.get("device_batches")
    host = stamp.get("host_batches")
    if isinstance(dev, int) and isinstance(host, int) and (dev + host):
        return dev / (dev + host)
    return None


def _merge_federation(feds: list) -> dict | None:
    """Fold per-member federation stamps (FederatedVerifier
    ``federation_stats`` shape, riding each member's sidecar stamp) into
    one routing view: per-host dispatch counts sum across members,
    shares re-derive from the summed total, and each host's occupancy
    comes from its own server snapshot. None below two hosts or zero
    dispatches — no skew verdict without a real routing split."""
    by_host: dict = {}
    occ_by_host: dict = {}
    hedges = degraded = 0
    for f in feds:
        if not isinstance(f, dict):
            continue
        hedges += int(_finite(f.get("hedges")) or 0)
        degraded += int(_finite(f.get("host_degraded")) or 0)
        for addr, ch in (f.get("hosts") or {}).items():
            if not isinstance(ch, dict):
                continue
            by_host[addr] = (by_host.get(addr, 0)
                             + int(_finite(ch.get("dispatches")) or 0))
            server = ch.get("server")
            if isinstance(server, dict) and addr not in occ_by_host:
                occ = _occupancy_of(server)
                if occ is not None:
                    occ_by_host[addr] = round(occ, 3)
    total = sum(by_host.values())
    if not total or len(by_host) < 2:
        return None
    return {
        "routing_share_by_host": {a: round(n / total, 4)
                                  for a, n in sorted(by_host.items())},
        "occupancy_by_host": occ_by_host or None,
        "dispatches": total,
        "hedges": hedges,
        "host_degraded": degraded,
    }


def _merge_breakdowns(breakdowns: list) -> dict | None:
    """Fold per-member ``round_breakdown`` blocks (telemetry
    format_breakdown shape) into one: totals sum, shares re-derive from
    the summed wall. Members below MIN_ATTRIBUTION_ROUNDS are dropped —
    the abstention contract survives the merge."""
    rounds = 0
    wall = 0.0
    totals: dict = {}
    for b in breakdowns:
        if not isinstance(b, dict):
            continue
        if (b.get("rounds") or 0) < MIN_ATTRIBUTION_ROUNDS:
            continue
        rounds += b.get("rounds") or 0
        wall += _finite(b.get("wall_s")) or 0.0
        for phase, entry in (b.get("phases") or {}).items():
            totals[phase] = totals.get(phase, 0.0) + (
                _finite((entry or {}).get("total_s")) or 0.0)
    if rounds < MIN_ATTRIBUTION_ROUNDS or not wall:
        return None
    return {
        "rounds": rounds,
        "wall_s": round(wall, 6),
        "phases": {p: {"total_s": round(v, 6),
                       "share": round(v / wall, 4)}
                   for p, v in totals.items()},
    }


def _pipeline_enabled(stamps) -> bool:
    """True when some member's raft stamp says the pipelined commit plane
    is on — flips the stage rules to their PIPELINED_RULES overlay."""
    for s in stamps:
        raft = s.get("raft") if isinstance(s, dict) else None
        if isinstance(raft, dict) and raft.get("pipeline"):
            return True
    return False


def _merge_raft_health(stamps) -> dict | None:
    """Fold each member's nested raft stamp into one leadership-health
    view: elections won, step-downs, term spread and the prevote flag.
    None when no member carried a raft stamp (host-only sections)."""
    rafts = [s.get("raft") for s in stamps
             if isinstance(s, dict) and isinstance(s.get("raft"), dict)]
    if not rafts:
        return None

    def total(key):
        return sum(int(_finite(r.get(key)) or 0) for r in rafts)

    return {
        "members": len(rafts),
        "elections_won": total("elections_won"),
        "leader_stepdowns": total("leader_stepdowns"),
        "checkquorum_stepdowns": total("checkquorum_stepdowns"),
        "prevote_rejections": total("prevote_rejections"),
        "max_term": max(int(_finite(r.get("term")) or 0) for r in rafts),
        "max_commit_index": max(int(_finite(r.get("commit_index")) or 0)
                                for r in rafts),
        "prevote": any(bool(r.get("prevote")) for r in rafts),
    }


def _candidates(signals: dict) -> list[dict]:
    out: list[dict] = []
    pipelined = bool(signals.get("pipeline_enabled"))

    # Rule: low device occupancy -> coalesce/bucket ladder. Evidence is
    # the per-member routing split (the r05 regression shape: the device
    # answered but micro-batches never reached device_min_sigs).
    occs = signals.get("device_occupancy_by_member") or {}
    if occs:
        mean_occ = sum(occs.values()) / len(occs)
        if mean_occ < _OCCUPANCY_HEALTHY:
            evidence = {"device_occupancy_by_member":
                        {k: round(v, 3) for k, v in occs.items()},
                        "mean_occupancy": round(mean_occ, 3)}
            hist = signals.get("batch_sigs_hist")
            if hist:
                evidence["batch_sigs_hist"] = hist
            out.append({"cause": "device_occupancy",
                        "score": round(1.0 - mean_occ, 4),
                        "evidence": evidence,
                        "next_experiment": _suggest("device_occupancy"),
                        "experiment": suggest_spec("device_occupancy")})

    # Rule: busiest round stage majority across members (the legacy
    # heuristic, kept as one evidence stream among several — each value
    # here already honoured the <MIN_ATTRIBUTION_ROUNDS abstention at
    # stamp time).
    stages = [s for s in (signals.get("busiest_stages") or ()) if s]
    if stages:
        counts: dict = {}
        for s in stages:
            counts[s] = counts.get(s, 0) + 1
        # Deterministic: highest count, then alphabetical.
        top = min(counts, key=lambda s: (-counts[s], s))
        frac = counts[top] / len(stages)
        out.append({"cause": top,
                    "score": round(0.5 + 0.5 * frac, 4),
                    "evidence": {"busiest_stage_by_member_count": counts,
                                 "members_reporting": len(stages)},
                    "next_experiment": _suggest(top, pipelined),
                    "experiment": suggest_spec(top, pipelined)})

    # Rule: dominant round phase from the merged telemetry profiler
    # breakdown — the block that decomposes a "rounds" wall into
    # poll/verify_wait/seal/replicate/apply/reply.
    breakdown = signals.get("round_breakdown")
    if breakdown:
        phases = {p: (e or {}).get("share") or 0.0
                  for p, e in (breakdown.get("phases") or {}).items()}
        if phases:
            top = min(phases, key=lambda p: (-phases[p], p))
            if phases[top] >= _PHASE_DOMINANT_SHARE:
                out.append({
                    "cause": top,
                    "score": round(0.5 + 0.5 * phases[top], 4),
                    "evidence": {"round_breakdown_shares":
                                 {p: round(v, 4)
                                  for p, v in sorted(phases.items())},
                                 "rounds": breakdown.get("rounds")},
                    "next_experiment": _suggest(top, pipelined),
                    "experiment": suggest_spec(top, pipelined)})

    # Rule: high mesh pad fraction -> bucket growth.
    pad = _finite(signals.get("pad_fraction"))
    if pad is not None and pad > _PAD_WORTH_FLAGGING:
        out.append({"cause": "pad_fraction",
                    "score": round(pad, 4),
                    "evidence": {"pad_fraction": round(pad, 4),
                                 "batch_sigs_hist":
                                 signals.get("batch_sigs_hist")},
                    "next_experiment": _suggest("pad_fraction"),
                    "experiment": suggest_spec("pad_fraction")})

    # Rule: shed-dominated admission -> recalibration.
    adm = signals.get("admission") or {}
    admitted = _finite(adm.get("admitted")) or 0.0
    shed = _finite(adm.get("shed")) or 0.0
    if shed and (admitted + shed):
        frac = shed / (admitted + shed)
        if frac >= _SHED_DOMINATED:
            out.append({"cause": "admission",
                        "score": round(0.5 + 0.5 * frac, 4),
                        "evidence": {"admitted": admitted, "shed": shed,
                                     "shed_fraction": round(frac, 4)},
                        "next_experiment": _suggest("admission"),
                        "experiment": suggest_spec("admission")})

    # Rule: federation routing-share skew -> host rebalance. Evidence
    # pairs each host's share of routed batches with that host's own
    # server occupancy (a slow host both under-serves its share and
    # attracts the hedged re-dispatches that deepen the skew).
    fed = signals.get("federation") or {}
    shares = fed.get("routing_share_by_host") or {}
    if len(shares) >= 2:
        skew = max(shares.values()) - min(shares.values())
        if skew >= _HOST_IMBALANCE_SKEW:
            out.append({"cause": "host_imbalance",
                        "score": round(0.5 + 0.5 * min(1.0, skew), 4),
                        "evidence": {
                            "routing_share_by_host": {
                                k: round(v, 4)
                                for k, v in sorted(shares.items())},
                            "occupancy_by_host":
                                fed.get("occupancy_by_host"),
                            "dispatches": fed.get("dispatches"),
                            "hedges": fed.get("hedges")},
                        "next_experiment": _suggest("host_imbalance"),
                        "experiment": suggest_spec("host_imbalance")})

    # Rule: election churn -> prevote/check-quorum hardening. A healthy
    # run elects each group's leader once and keeps it; repeated
    # elections or step-downs mean leadership is being disturbed
    # (partition flap, starved heartbeats, a rejoiner forcing terms up).
    # Abstains below MIN_ATTRIBUTION_ROUNDS committed entries — a
    # near-idle cluster's bootstrap elections are not churn evidence.
    raft = signals.get("raft_health") or {}
    churn = ((raft.get("elections_won") or 0)
             + (raft.get("leader_stepdowns") or 0))
    if raft and churn >= _ELECTION_CHURN_MIN \
            and (raft.get("max_commit_index") or 0) \
            >= MIN_ATTRIBUTION_ROUNDS:
        out.append({
            "cause": "election_churn",
            "score": round(0.5 + 0.5 * min(1.0, churn / 10.0), 4),
            "evidence": {k: raft.get(k) for k in (
                "elections_won", "leader_stepdowns",
                "checkquorum_stepdowns", "prevote_rejections",
                "max_term", "members", "prevote")},
            "next_experiment": _suggest("election_churn"),
            "experiment": suggest_spec("election_churn")})

    # Rule: vault queries dominating flow wall time -> arm the indexed
    # vault engine. The shares come from the flagship trace breakdown
    # (stage mean over end-to-end mean); extraction already abstained
    # below MIN_ATTRIBUTION_ROUNDS traces, so a share here is evidence.
    shares = signals.get("flow_stage_shares") or {}
    vshare = _finite(shares.get("vault_query"))
    if vshare is not None and vshare >= _FLOW_STAGE_DOMINANT_SHARE:
        out.append({
            "cause": "vault_scan",
            "score": round(0.5 + 0.5 * min(1.0, vshare), 4),
            "evidence": {"flow_stage_shares":
                         {k: round(v, 4)
                          for k, v in sorted(shares.items())}},
            "next_experiment": _suggest("vault_scan"),
            "experiment": suggest_spec("vault_scan")})

    # Deterministic ranking: score desc, then cause name — two equal
    # scores can't flap the verdict between runs.
    out.sort(key=lambda c: (-c["score"], c["cause"]))
    # One entry per cause (busiest-stage and breakdown evidence can both
    # nominate the same stage; keep the higher-scored entry).
    seen: set = set()
    deduped = []
    for c in out:
        if c["cause"] not in seen:
            seen.add(c["cause"])
            deduped.append(c)
    return deduped


# ---------------------------------------------------------------------------
# The loadtest-facing attribution: member stamps in, ranked verdict out.
# ---------------------------------------------------------------------------


def stamp_attribution(node_stamps: dict | None) -> dict:
    """Evidence-ranked bottleneck attribution over loadtest member stamps
    (``_member_stamp`` dicts). This is the source of ``first_bottleneck``
    in sweep results — the Counter-majority ``busiest_stage`` heuristic
    survives inside it as ONE evidence stream (already min-rounds
    guarded at stamp time), joined by the round profiler's phase shares,
    device routing occupancy and admission counters. No evidence means
    an honest ``first_bottleneck: None``, never a guess."""
    stamps = [s for s in (node_stamps or {}).values()
              if isinstance(s, dict)]
    occs = {}
    breakdowns = []
    admitted = shed = 0.0
    for i, s in enumerate(stamps):
        occ = _occupancy_of(s)
        if occ is not None:
            occs[s.get("verifier") or f"member-{i}"] = occ
        if s.get("round_breakdown"):
            breakdowns.append(s["round_breakdown"])
        adm = s.get("admission") or {}
        admitted += _finite(adm.get("admitted_interactive")) or 0.0
        admitted += _finite(adm.get("admitted_bulk")) or 0.0
        admitted += _finite(adm.get("admitted")) or 0.0
        shed += _finite(adm.get("shed_interactive")) or 0.0
        shed += _finite(adm.get("shed_bulk")) or 0.0
        shed += _finite(adm.get("shed")) or 0.0
    signals = {
        "device_occupancy_by_member": occs,
        "busiest_stages": [s.get("busiest_stage") for s in stamps],
        "round_breakdown": _merge_breakdowns(breakdowns),
        "admission": {"admitted": admitted, "shed": shed},
        "pipeline_enabled": _pipeline_enabled(stamps),
        "raft_health": _merge_raft_health(stamps),
        "federation": _merge_federation(
            [(s.get("sidecar") or {}).get("federation") for s in stamps]),
    }
    bottlenecks = _candidates(signals)
    return {
        "schema": SCHEMA_VERSION,
        "first_bottleneck": (bottlenecks[0]["cause"] if bottlenecks
                             else None),
        "bottlenecks": bottlenecks,
        "members": len(stamps),
    }


# ---------------------------------------------------------------------------
# Signal extraction from artifact shapes.
# ---------------------------------------------------------------------------


def _classify(artifact: dict) -> str:
    """Which known artifact shape this is — the trajectory's ``kind``
    (gate comparisons never cross kinds; an ingest capture regressing
    against a multichip capture would be noise)."""
    if not isinstance(artifact, dict):
        return "unknown"
    if "autotune_schema" in artifact:
        return "autotune"
    if artifact.get("metric") == "verified_sigs_per_sec" \
            or "baseline_configs" in artifact:
        return "bench_report"
    if "raft_validating_3node_sidecar" in artifact:
        return "flagship_capture"
    if "multichip_scaling" in artifact:
        return "multichip_capture"
    if "peak_achieved_tx_s" in artifact or (
            "rates" in artifact and "workers" in artifact):
        return "ingest_sweep"
    return "unknown"


def _member_stamps_of(section: dict | None) -> dict:
    """node_stamps with the historical scalar pollution filtered out
    (pre-PR1 artifacts carried ``device_warm_wait_s`` as a sibling of
    the member dicts)."""
    return {k: v for k, v in ((section or {}).get("node_stamps")
                              or {}).items()
            if isinstance(v, dict)}


def _flagship_of(artifact: dict) -> dict | None:
    configs = artifact.get("baseline_configs") or {}
    for key in ("raft_validating_3node", "raft_notary_3node"):
        section = configs.get(key)
        if isinstance(section, dict) and "error" not in section:
            return section
    section = artifact.get("raft_validating_3node_sidecar")
    return section if isinstance(section, dict) else None


def _peak_ingest_row(section: dict | None) -> dict | None:
    rows = [r for r in ((section or {}).get("rates") or {}).values()
            if isinstance(r, dict) and "error" not in r]
    if not rows:
        return None
    return max(rows, key=lambda r: _finite(r.get("achieved_tx_s")) or 0.0)


def extract_signals(artifact: dict) -> dict:
    """Pull the doctor's signal bundle out of any known artifact shape —
    a full bench report, a flagship/multichip capture, or an ingest
    sweep. Every key is optional; downstream rules skip what is absent."""
    kind = _classify(artifact)
    signals: dict = {"kind": kind}

    flagship = _flagship_of(artifact)
    stamps = _member_stamps_of(flagship)

    # The measured ceiling: the kernel stream is the device's proven
    # sustained rate; kernel bucket peaks back it up, the host oracle is
    # the honest floor for host-only runs.
    for key, source in (("e2e_stream_sigs_per_sec", "kernel_stream"),
                        ("cpu_oracle_sigs_per_sec", "cpu_oracle")):
        ceiling = _finite(artifact.get(key))
        if ceiling:
            signals["ceiling_sigs_per_sec"] = ceiling
            signals["ceiling_source"] = source
            break
    kernel = artifact.get("kernel_sigs_per_sec") or {}
    peaks = [v for v in (_finite(x) for x in kernel.values()) if v]
    if peaks:
        signals["kernel_peak_sigs_per_sec"] = max(peaks)
        signals.setdefault("ceiling_sigs_per_sec", max(peaks))
        signals.setdefault("ceiling_source", "kernel_buckets")

    if flagship:
        signals["e2e_sigs_per_sec"] = _finite(
            flagship.get("loadtest_sigs_per_sec"))
        signals["committed_tx_per_sec"] = _finite(
            flagship.get("tx_per_sec"))
        signals["p99_ms"] = _finite(flagship.get("p99_ms"))
        side = flagship.get("sidecar")
        if isinstance(side, dict):
            signals["batch_sigs_hist"] = side.get("batch_sigs_hist")
            signals["pad_fraction"] = _finite(side.get("pad_fraction"))
        occ = _finite(flagship.get("device_occupancy"))
        if occ is not None and not stamps:
            signals["device_occupancy_by_member"] = {"flagship": occ}

    # Per-stage share of flow wall time from the flagship trace
    # breakdown: stage mean over end-to-end mean. Abstains below
    # MIN_ATTRIBUTION_ROUNDS traces — a handful of flows is noise, not
    # an attribution.
    breakdown = ((artifact.get("baseline_configs") or {})
                 .get("raft_open_loop_latency") or {}).get("stage_breakdown")
    if isinstance(breakdown, dict):
        e2e_mean = _finite((breakdown.get("end_to_end") or {})
                           .get("mean_ms"))
        traces = _finite(breakdown.get("traces")) or 0
        if e2e_mean and traces >= MIN_ATTRIBUTION_ROUNDS:
            shares = {}
            for stage, entry in (breakdown.get("stages") or {}).items():
                mean = _finite((entry or {}).get("mean_ms"))
                if mean is not None:
                    shares[stage] = min(1.0, mean / e2e_mean)
            if shares:
                signals["flow_stage_shares"] = shares

    if kind == "ingest_sweep":
        stamps = _member_stamps_of(artifact)
        peak = _peak_ingest_row(artifact)
        if peak:
            signals["committed_tx_per_sec"] = _finite(
                peak.get("achieved_tx_s"))
            signals["offered_tx_s"] = _finite(peak.get("offered_tx_s"))
            signals["p99_ms"] = _finite(peak.get("p99_ms"))

    if kind == "multichip_capture":
        section = artifact.get("multichip_scaling") or {}
        widths = [w for w in (section.get("devices") or {}).values()
                  if isinstance(w, dict)]
        rates = [v for v in (_finite(w.get("sigs_per_sec"))
                             for w in widths) if v]
        if rates:
            signals["e2e_sigs_per_sec"] = max(rates)
        pads = [v for v in (_finite(w.get("pad_fraction"))
                            for w in widths) if v is not None]
        if pads:
            signals["pad_fraction"] = max(pads)

    if stamps:
        occs = {}
        breakdowns = []
        for name, s in stamps.items():
            occ = _occupancy_of(s)
            if occ is not None:
                occs[name] = occ
            if s.get("round_breakdown"):
                breakdowns.append(s["round_breakdown"])
        if occs:
            signals["device_occupancy_by_member"] = occs
        signals["busiest_stages"] = [s.get("busiest_stage")
                                     for s in stamps.values()]
        merged = _merge_breakdowns(breakdowns)
        if merged:
            signals["round_breakdown"] = merged
        signals["pipeline_enabled"] = _pipeline_enabled(stamps.values())
        raft = _merge_raft_health(stamps.values())
        if raft:
            signals["raft_health"] = raft
    # Fall back to the roundtrip probe's routing split when the flagship
    # carried no stamps (the r05_a shape): it exercised the same verify
    # plane, so its device/host split is honest occupancy evidence.
    if not signals.get("device_occupancy_by_member"):
        rt = artifact.get("notary_roundtrip")
        if isinstance(rt, dict):
            occ = _occupancy_of(rt)
            if occ is not None:
                signals["device_occupancy_by_member"] = {
                    "notary_roundtrip": occ}
    return signals


# ---------------------------------------------------------------------------
# The verdict.
# ---------------------------------------------------------------------------


def _roofline(signals: dict) -> dict:
    """Committed tx/s and e2e sigs/s against the measured kernel-stream
    ceiling. ``gap_factor`` is ceiling/e2e (how far the framework path
    sits below what the chip proved it can stream); the per-layer split
    attributes the part the routing evidence explains — occupancy < 1
    multiplies the gap by 1/occupancy on its own — and leaves the rest
    as ``residual_factor`` rather than inventing precision."""
    ceiling = _finite(signals.get("ceiling_sigs_per_sec"))
    e2e = _finite(signals.get("e2e_sigs_per_sec"))
    out = {
        "ceiling_sigs_per_sec": ceiling,
        "ceiling_source": signals.get("ceiling_source"),
        "e2e_sigs_per_sec": e2e,
        "committed_tx_per_sec": _finite(
            signals.get("committed_tx_per_sec")),
        "p99_ms": _finite(signals.get("p99_ms")),
        "gap_factor": None,
        "layers": None,
    }
    if not ceiling or not e2e:
        return out
    gap = ceiling / e2e
    out["gap_factor"] = round(gap, 2)
    occs = signals.get("device_occupancy_by_member") or {}
    layers: dict = {}
    explained = 1.0
    if occs:
        mean_occ = sum(occs.values()) / len(occs)
        if 0.0 < mean_occ < 1.0:
            factor = min(1.0 / mean_occ, gap)
            layers["verify_routing_factor"] = round(factor, 2)
            explained *= factor
        elif mean_occ == 0.0:
            # Everything host-routed: the whole gap is the routing layer
            # as far as this evidence can tell.
            layers["verify_routing_factor"] = round(gap, 2)
            explained = gap
    layers["residual_factor"] = round(max(1.0, gap / explained), 2)
    out["layers"] = layers
    return out


def diagnose(signals: dict) -> dict:
    """Signals in, one machine-readable ``PerfVerdict`` out: the
    roofline, the evidence-ranked bottleneck list, and the headline
    ``first_bottleneck``. Pure and JSON-safe — callers stamp it into
    bench sections and trajectory records verbatim."""
    bottlenecks = _candidates(signals)
    return {
        "schema": SCHEMA_VERSION,
        "kind": signals.get("kind", "unknown"),
        "roofline": _roofline(signals),
        "bottlenecks": bottlenecks,
        "first_bottleneck": (bottlenecks[0]["cause"] if bottlenecks
                             else None),
    }


# ---------------------------------------------------------------------------
# Trajectory records.
# ---------------------------------------------------------------------------

_ROUND_RE = re.compile(r"r(\d+)")


def _round_of(artifact: dict, source: str) -> int | None:
    if isinstance(artifact.get("round"), int):
        return artifact["round"]
    m = _ROUND_RE.search(os.path.basename(source or ""))
    return int(m.group(1)) if m else None


def _hoist_metrics(artifact: dict, kind: str) -> dict:
    """The flat, numeric/bool key-metric dict the gate compares. Every
    key is hoisted only when its section exists — schema growth is
    additive, and the gate only compares keys present on BOTH sides."""
    m: dict = {}

    def put(key, value):
        v = _finite(value) if not isinstance(value, bool) else value
        if v is not None:
            m[key] = v

    if kind == "bench_report":
        put("value_sigs_per_sec", artifact.get("value"))
        put("vs_baseline", artifact.get("vs_baseline"))
        put("e2e_stream_sigs_per_sec",
            artifact.get("e2e_stream_sigs_per_sec"))
        kernel = artifact.get("kernel_sigs_per_sec") or {}
        peaks = [v for v in (_finite(x) for x in kernel.values()) if v]
        if peaks:
            put("kernel_peak_sigs_per_sec", max(peaks))
        put("cpu_oracle_sigs_per_sec",
            artifact.get("cpu_oracle_sigs_per_sec"))
        rt = artifact.get("notary_roundtrip")
        if isinstance(rt, dict):
            put("roundtrip_tx_per_sec", rt.get("tx_per_sec"))
        configs = artifact.get("baseline_configs") or {}
        flagship = _flagship_of(artifact)
        if flagship:
            put("flagship_tx_per_sec", flagship.get("tx_per_sec"))
            put("flagship_sigs_per_sec",
                flagship.get("loadtest_sigs_per_sec"))
            put("flagship_p99_ms", flagship.get("p99_ms"))
            occ = _finite(flagship.get("device_occupancy"))
            if occ is None:
                occs = [o for o in
                        (_occupancy_of(s) for s in
                         _member_stamps_of(flagship).values())
                        if o is not None]
                occ = (sum(occs) / len(occs)) if occs else None
            put("flagship_device_occupancy", occ)
        ingest = configs.get("ingest_sweep")
        if isinstance(ingest, dict) and "error" not in ingest:
            put("ingest_peak_achieved_tx_s",
                ingest.get("peak_achieved_tx_s"))
            delta = ingest.get("pipeline_delta")
            if isinstance(delta, dict):
                put("ingest_pipeline_speedup",
                    delta.get("pipeline_speedup"))
        slo = configs.get("slo_sweep")
        if isinstance(slo, dict):
            verdict = slo.get("verdict") or {}
            if isinstance(verdict.get("slo_met"), bool):
                m["slo_met"] = verdict["slo_met"]
        multi = configs.get("multichip_scaling")
        if isinstance(multi, dict):
            put("multichip_scaling_1_to_max",
                multi.get("scaling_1_to_max"))
        vault = configs.get("vault_scaling")
        if isinstance(vault, dict) and "error" not in vault:
            put("vault_coin_selection_p99_ratio",
                vault.get("vault_coin_selection_p99_ratio"))
            put("vault_boot_speedup", vault.get("vault_boot_speedup"))
            put("vault_query_p99_ms", vault.get("vault_query_p99_ms"))
            if isinstance(vault.get("vault_parity_ok"), bool):
                m["vault_parity_ok"] = vault["vault_parity_ok"]
        chaos = artifact.get("chaos")
        if isinstance(chaos, dict):
            put("leader_kill_recovery_s",
                chaos.get("leader_kill_recovery_s"))
        part = artifact.get("partition_chaos")
        if isinstance(part, dict):
            put("recovery_s", part.get("recovery_s"))
            put("max_term_inflation", part.get("max_term_inflation"))
            put("partition_minority_commits",
                part.get("minority_commits"))
            put("partition_lost_acks", part.get("lost_acks"))
            if isinstance(part.get("history_linearizable"), bool):
                m["history_linearizable"] = part["history_linearizable"]
    elif kind == "flagship_capture":
        flagship = artifact.get("raft_validating_3node_sidecar") or {}
        put("flagship_tx_per_sec", flagship.get("tx_per_sec"))
        put("flagship_sigs_per_sec",
            flagship.get("loadtest_sigs_per_sec"))
        put("flagship_p99_ms", flagship.get("p99_ms"))
        put("flagship_device_occupancy",
            flagship.get("device_occupancy"))
    elif kind == "ingest_sweep":
        put("peak_offered_tx_s", artifact.get("peak_offered_tx_s"))
        put("peak_achieved_tx_s", artifact.get("peak_achieved_tx_s"))
        if isinstance(artifact.get("exactly_once_all"), bool):
            m["exactly_once_all"] = artifact["exactly_once_all"]
        peak = _peak_ingest_row(artifact)
        if peak:
            put("p99_ms", peak.get("p99_ms"))
            ingest = peak.get("ingest") or {}
            put("tx_built_per_s", ingest.get("tx_built_per_s"))
            put("sigs_signed_per_s", ingest.get("sigs_signed_per_s"))
        delta = artifact.get("pipeline_delta")
        if isinstance(delta, dict):
            put("pipeline_speedup", delta.get("pipeline_speedup"))
            put("committed_tx_s_pipelined",
                delta.get("committed_tx_s_pipelined"))
    elif kind == "multichip_capture":
        section = artifact.get("multichip_scaling") or {}
        widths = [w for w in (section.get("devices") or {}).values()
                  if isinstance(w, dict)]
        rates = [v for v in (_finite(w.get("sigs_per_sec"))
                             for w in widths) if v]
        if rates:
            put("max_width_sigs_per_sec", max(rates))
        put("multichip_scaling_1_to_max",
            section.get("scaling_1_to_max"))
        parity = [w.get("parity_ok") for w in widths
                  if "parity_ok" in w]
        if parity:
            m["parity_ok_all"] = all(parity)
    elif kind == "autotune":
        # Controller provenance record (autotune/controller.py
        # run_autotune): the committed config's swept-metric value
        # against the hand-tuned incumbent, plus search accounting. The
        # best config's exactly-once verdict rides as the hard flag.
        put("autotune_best_value", artifact.get("best_value"))
        put("autotune_baseline_value", artifact.get("baseline_value"))
        put("autotune_candidates", artifact.get("candidates_evaluated"))
        put("autotune_gate_rejections", artifact.get("gate_rejections"))
        put("autotune_improvement_pct", artifact.get("improvement_pct"))
        best = ((artifact.get("best") or {}).get("metrics") or {})
        if isinstance(best.get("exactly_once_all"), bool):
            m["autotune_exactly_once_all"] = best["exactly_once_all"]
    return m


def _autotune_provenance(artifact: dict) -> dict:
    """The autotune record's provenance block: which verdict the loop
    consumed, every candidate tried (values moved, metrics measured,
    gate outcome), the decision sequence + seed that replay the search,
    and what — if anything — was committed."""
    candidates = []
    for c in artifact.get("candidates") or []:
        if not isinstance(c, dict):
            continue
        entry = {"id": c.get("id"), "knob": c.get("knob"),
                 "accepted": bool(c.get("accepted")),
                 "metrics": c.get("metrics")}
        if "from" in c:
            entry["from"] = c["from"]
            entry["to"] = c.get("to")
        g = c.get("gate")
        if isinstance(g, dict):
            entry["gate_ok"] = bool(g.get("ok"))
            if g.get("hard_vetoes"):
                entry["hard_vetoes"] = [h.get("metric")
                                        for h in g["hard_vetoes"]]
            if g.get("soft_regressions"):
                entry["regressions"] = [h.get("metric")
                                        for h in g["soft_regressions"]]
        candidates.append(entry)
    return {
        "experiment_id": artifact.get("experiment_id"),
        "cause": artifact.get("cause"),
        "harness": artifact.get("harness"),
        "metric": artifact.get("metric"),
        "seed": artifact.get("seed"),
        "budget": artifact.get("budget"),
        "knobs": artifact.get("knobs"),
        "verdict_consumed": artifact.get("verdict_consumed"),
        "decision_sequence": artifact.get("decision_sequence"),
        "candidates": candidates,
        "committed": bool(artifact.get("committed")),
        "committed_values": (artifact.get("overlay") or {}).get("values"),
    }


def normalize_record(artifact: dict, source: str = "") -> dict:
    """One schema-versioned trajectory record: the artifact's kind, its
    flat key metrics, and the doctor's verdict over it — everything the
    gate and the trend tooling need without re-opening the artifact.
    Autotune records additionally carry the full search provenance
    (verdict consumed, candidates tried with per-candidate metrics and
    gate outcomes, the replay seed) — the loop's audit trail lives in
    the store, not in a side file."""
    kind = _classify(artifact)
    verdict = diagnose(extract_signals(artifact))
    record = {
        "schema": SCHEMA_VERSION,
        "kind": kind,
        "source": os.path.basename(source) if source else "",
        "round": _round_of(artifact, source),
        "metrics": _hoist_metrics(artifact, kind),
        "verdict": {
            "first_bottleneck": verdict["first_bottleneck"],
            "bottlenecks": [b["cause"] for b in verdict["bottlenecks"]],
            "gap_factor": verdict["roofline"]["gap_factor"],
        },
    }
    if kind == "autotune":
        record["autotune"] = _autotune_provenance(artifact)
    return record


def append_trajectory(path: str, record: dict) -> None:
    """Append one record to the JSONL store (created on first use)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def load_trajectory(path: str) -> list[dict]:
    """Every record in append order; a missing store is an empty
    trajectory, a malformed line raises (the store is machine-written —
    silent tolerance would let corruption hide a regression)."""
    if not os.path.exists(path):
        return []
    records = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(
                    f"{path}:{i + 1}: malformed trajectory record: "
                    f"{exc}") from None
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{path}:{i + 1}: trajectory record is not an object")
            records.append(rec)
    return records


# ---------------------------------------------------------------------------
# The regression gate.
# ---------------------------------------------------------------------------

# Per-metric tolerance policy: direction ("higher" is better / "lower"
# is better / "equal" must hold) + the percent band a worse value may
# drift before it counts as a regression. 20% absorbs the measured
# run-to-run noise of the checked-in history (the r05 d->e flagship p99
# moved 16.8% on an idle host) while a real regression — the synthetic
# fixtures use 20-25% — still trips.
DEFAULT_POLICY: dict = {
    "value_sigs_per_sec": {"direction": "higher", "pct": 20.0},
    "e2e_stream_sigs_per_sec": {"direction": "higher", "pct": 20.0},
    "kernel_peak_sigs_per_sec": {"direction": "higher", "pct": 20.0},
    "flagship_tx_per_sec": {"direction": "higher", "pct": 20.0},
    "flagship_sigs_per_sec": {"direction": "higher", "pct": 20.0},
    "flagship_p99_ms": {"direction": "lower", "pct": 20.0},
    "peak_achieved_tx_s": {"direction": "higher", "pct": 20.0},
    "tx_built_per_s": {"direction": "higher", "pct": 20.0},
    "sigs_signed_per_s": {"direction": "higher", "pct": 20.0},
    "p99_ms": {"direction": "lower", "pct": 20.0},
    "ingest_peak_achieved_tx_s": {"direction": "higher", "pct": 20.0},
    # Pipelined-vs-serial commit-plane delta (round 18): the speedup
    # ratio AND the pipelined path's absolute committed-tx/s are both
    # banded, so a change that flattens the overlap win fails the gate
    # even while serial throughput holds.
    "pipeline_speedup": {"direction": "higher", "pct": 20.0},
    "committed_tx_s_pipelined": {"direction": "higher", "pct": 20.0},
    "ingest_pipeline_speedup": {"direction": "higher", "pct": 20.0},
    "max_width_sigs_per_sec": {"direction": "higher", "pct": 20.0},
    "multichip_scaling_1_to_max": {"direction": "higher", "pct": 20.0},
    "exactly_once_all": {"direction": "equal"},
    "parity_ok_all": {"direction": "equal"},
    "slo_met": {"direction": "equal"},
    # Partition plane (round 20): heal-to-first-commit recovery and the
    # prevote term-inflation bound are banded; the history auditor's
    # verdict is a hard flag — a run that stops being linearizable is a
    # regression regardless of magnitude. minority_commits / lost_acks
    # regress when they grow above a prior zero, but a zero prior passes
    # _compare vacuously, so the auditor flag is the real gate bit.
    "recovery_s": {"direction": "lower", "pct": 20.0},
    "max_term_inflation": {"direction": "lower", "pct": 20.0},
    "partition_minority_commits": {"direction": "lower", "pct": 20.0},
    "partition_lost_acks": {"direction": "lower", "pct": 20.0},
    "history_linearizable": {"direction": "equal"},
    # Autotune plane (round 21): the loop's committed and baseline
    # swept-metric values are banded a little wider than raw throughput
    # (25%) — short sweep candidates are noisier than full bench runs —
    # while the best config's exactly-once verdict is a hard flag: an
    # autotune round whose winner stops being exactly-once is a
    # regression regardless of how fast it got.
    "autotune_best_value": {"direction": "higher", "pct": 25.0},
    "autotune_baseline_value": {"direction": "higher", "pct": 25.0},
    "autotune_exactly_once_all": {"direction": "equal"},
    # Vault scaling (round 22): the coin-selection p99 ratio
    # (largest-store p99 over smallest-store p99) is the sublinearity
    # headline — it growing means indexed selection degraded toward a
    # scan; the boot speedup (full replay over incremental rebuild) is
    # the watermark win; query p99 is banded like the autotune sweeps
    # (25%, short in-process runs are noisy); engine parity is a hard
    # flag — the two engines disagreeing on the unconsumed set is a
    # correctness regression regardless of speed.
    "vault_coin_selection_p99_ratio": {"direction": "lower", "pct": 25.0},
    "vault_boot_speedup": {"direction": "higher", "pct": 25.0},
    "vault_query_p99_ms": {"direction": "lower", "pct": 25.0},
    "vault_parity_ok": {"direction": "equal"},
}


def _compare(metric: str, prev, new, rule: dict) -> dict | None:
    """One metric check -> a regression dict or None. Only keys present
    and comparable on BOTH records are judged (schema growth must never
    fail the gate retroactively)."""
    direction = rule.get("direction", "higher")
    if direction == "equal":
        if isinstance(prev, bool) and isinstance(new, bool) \
                and prev and not new:
            return {"metric": metric, "prev": prev, "new": new,
                    "direction": direction,
                    "detail": "flag flipped false"}
        return None
    p, n = _finite(prev), _finite(new)
    if p is None or n is None or p <= 0:
        return None
    pct = float(rule.get("pct", 20.0))
    change = (n - p) / p * 100.0
    if direction == "higher" and change < -pct:
        return {"metric": metric, "prev": p, "new": n,
                "direction": direction, "change_pct": round(change, 2),
                "band_pct": pct}
    if direction == "lower" and change > pct:
        return {"metric": metric, "prev": p, "new": n,
                "direction": direction, "change_pct": round(change, 2),
                "band_pct": pct}
    return None


def gate(records: list[dict], policy: dict | None = None) -> dict:
    """Each kind's NEWEST record against its predecessor of the same
    kind under the tolerance policy. Cross-kind comparison would be
    noise (an ingest capture is not a multichip capture); a kind with a
    single record has no predecessor and passes vacuously — the verdict
    says so under ``unpaired`` instead of hiding it."""
    policy = policy or DEFAULT_POLICY
    by_kind: dict = {}
    for rec in records:
        if isinstance(rec, dict):
            by_kind.setdefault(rec.get("kind", "unknown"), []).append(rec)
    regressions = []
    compared = {}
    unpaired = []
    for kind in sorted(by_kind):
        chain = by_kind[kind]
        if len(chain) < 2:
            unpaired.append(kind)
            continue
        prev, new = chain[-2], chain[-1]
        compared[kind] = {"prev": prev.get("source") or "prev",
                          "new": new.get("source") or "new"}
        pm = prev.get("metrics") or {}
        nm = new.get("metrics") or {}
        for metric in sorted(set(pm) & set(nm) & set(policy)):
            hit = _compare(metric, pm[metric], nm[metric], policy[metric])
            if hit:
                hit["kind"] = kind
                regressions.append(hit)
    return {
        "schema": SCHEMA_VERSION,
        "ok": not regressions,
        "regressions": regressions,
        "compared": compared,
        "unpaired": unpaired,
        "records": len(records),
    }


def trajectory_delta(prior: list[dict], record: dict) -> dict | None:
    """The newest record against the LAST prior record of its kind:
    per-metric percent change for the bench report's one-line contract.
    None when the store holds no predecessor of this kind."""
    prev = None
    for rec in prior:
        if isinstance(rec, dict) and rec.get("kind") == record.get("kind"):
            prev = rec
    if prev is None:
        return None
    pm = prev.get("metrics") or {}
    nm = record.get("metrics") or {}
    deltas = {}
    for metric in sorted(set(pm) & set(nm)):
        p, n = _finite(pm[metric]), _finite(nm[metric])
        if p and n is not None:
            deltas[metric] = {"prev": p, "new": n,
                              "change_pct": round((n - p) / p * 100.0, 2)}
    return {"vs": prev.get("source") or "prev", "metrics": deltas}
