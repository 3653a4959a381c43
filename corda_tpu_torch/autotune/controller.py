"""The autotune controller: one doctor verdict in, one gated sweep out.

The loop is verdict -> sweep -> gate -> commit:

  * **verdict -> sweep**: :func:`spec_from_verdict` reads the top
    bottleneck's structured ``experiment`` spec (obs/doctor.RULE_SPECS,
    riding every bottleneck entry since round 21) and narrows its knob
    list to the registry knobs that apply to the chosen harness — no
    string-matching on the prose suggestion, ever.
  * **sweep**: :func:`run_autotune` is a deterministic seeded
    hill-climb: knob visit order and first step direction come from a
    seeded LCG, every proposed value from the registry's step rules,
    and nothing in the decision path reads a clock or an RNG stream
    beyond that LCG — the same seed against the same runner replays the
    identical decision sequence (pinned by ``decision_sequence``).
  * **gate**: every candidate is judged against the *incumbent* (the
    hand-tuned defaults, measured as candidate 0) by
    :func:`gate_candidate`, which literally runs ``obs/doctor.gate``
    over a two-record trajectory under the ``perfdoctor --gate``
    direction+band policy. Exactly-once/SLO flags are HARD gates: a
    candidate that flips one False is vetoed no matter how fast it got.
    A candidate that crashes is isolated — recorded with its error,
    hard-vetoed, and the search continues.
  * **commit**: the winner (if any candidate beat the incumbent on the
    swept metric AND survived the gate) is emitted as a TOML overlay an
    operator can apply verbatim, and the whole run — verdict consumed,
    every candidate's values/metrics/gate outcome, the decision
    sequence, the seed — lands in one ``autotune`` trajectory record.
    No improvement means no commit: the incumbent stands and the record
    says so honestly.

The runner is injected (``runner(values) -> metrics dict``): the CLI
and bench wire the real loadtest harnesses via :func:`make_ingest_runner`
(config knobs travel as one ``CORDA_TPU_CONFIG_OVERLAY`` env to every
spawned node, env knobs as their own vars, harness knobs as kwargs);
tests and ``--mock`` wire :func:`make_mock_runner`'s deterministic
response curves.

The port's own copy of ``corda_tpu/autotune/controller.py``: the same
seeded hill-climb and records; the ingest runner drives the port's
``tools/loadtest.run_ingest_sweep``.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass

from ..obs import doctor as _doctor
from ..obs import telemetry as _tm
from . import space as _space

__all__ = [
    "AUTOTUNE_SCHEMA",
    "HARD_GATE_FLAGS",
    "SweepSpec",
    "exploratory_spec",
    "gate_candidate",
    "make_ingest_runner",
    "make_mock_runner",
    "reset_between_candidates",
    "run_autotune",
    "spec_from_verdict",
]

AUTOTUNE_SCHEMA = 1

# Non-incumbent candidates a search may evaluate before it stops.
DEFAULT_BUDGET = 6

# Boolean flags that hard-gate a candidate even when absent from the
# doctor policy: incumbent True -> candidate False is an outright veto
# (a config that breaks exactly-once delivery is not "20% slower", it
# is wrong).
HARD_GATE_FLAGS = ("exactly_once", "exactly_once_all", "slo_met",
                   "parity_ok_all", "history_linearizable")

# harness name (RULE_SPECS vocabulary) -> (loadtest fn, default swept
# metric, direction). Harnesses outside this map have no sweepable
# runner (trace/partition/federation experiments are not parameter
# sweeps).
HARNESSES = {
    "ingest_sweep": ("run_ingest_sweep", "peak_achieved_tx_s", "higher"),
    "slo_sweep": ("run_slo_sweep", "peak_achieved_tx_s", "higher"),
}


@dataclass(frozen=True)
class SweepSpec:
    """One sweep, fully determined: which experiment, which knobs, which
    harness measures it, and which metric (with direction) decides."""

    experiment_id: str
    cause: str | None
    knobs: tuple
    harness: str
    metric: str
    direction: str = "higher"


def _top_bottleneck(verdict: dict):
    """(cause, experiment-spec|None) from any verdict shape: a
    stamp_attribution/diagnose dict (entries are dicts carrying the
    structured ``experiment``) or a trajectory-record verdict (entries
    are bare cause strings)."""
    entries = (verdict or {}).get("bottlenecks") or []
    if not entries:
        return None, None
    top = entries[0]
    if isinstance(top, dict):
        return top.get("cause"), top.get("experiment")
    return str(top), None


def spec_from_verdict(verdict: dict, *, metric: str | None = None,
                      pipelined: bool = False) -> SweepSpec:
    """Map a PerfVerdict to the sweep its top bottleneck implicates.
    Raises ValueError when the verdict abstained, the experiment has no
    sweepable harness, or no registry knob applies — the caller decides
    whether to fall back to :func:`exploratory_spec` or stop."""
    cause, experiment = _top_bottleneck(verdict)
    if cause is None:
        raise ValueError("verdict has no bottleneck to tune for")
    if not experiment:
        experiment = _doctor.suggest_spec(cause, pipelined)
    harness = experiment.get("harness", "")
    if harness not in HARNESSES:
        raise ValueError(
            f"experiment {experiment.get('experiment_id')!r} for cause "
            f"{cause!r} has no sweepable harness ({harness!r})")
    fn_name, default_metric, direction = HARNESSES[harness]
    knobs = tuple(n for n in experiment.get("knobs", ())
                  if n in _space.KNOBS
                  and _space.knob_applies(_space.KNOBS[n], fn_name))
    if not knobs:
        raise ValueError(
            f"experiment {experiment.get('experiment_id')!r} for cause "
            f"{cause!r} implicates no sweepable registry knob")
    return SweepSpec(experiment_id=experiment["experiment_id"],
                     cause=cause, knobs=knobs, harness=harness,
                     metric=metric or default_metric,
                     direction=direction)


def exploratory_spec(harness: str = "ingest_sweep",
                     knobs: tuple = ("batch.coalesce_ms",
                                     "raft.pipeline_window"),
                     metric: str | None = None) -> SweepSpec:
    """The no-verdict fallback: a default exploratory sweep over broadly
    load-bearing knobs, for runs whose doctor honestly abstained."""
    fn_name, default_metric, direction = HARNESSES[harness]
    usable = tuple(n for n in knobs
                   if _space.knob_applies(_space.KNOBS[n], fn_name))
    return SweepSpec(experiment_id="explore_defaults", cause=None,
                     knobs=usable, harness=harness,
                     metric=metric or default_metric, direction=direction)


# ---------------------------------------------------------------------------
# The gate.
# ---------------------------------------------------------------------------


def gate_candidate(incumbent: dict, candidate: dict,
                   policy: dict | None = None) -> dict:
    """``perfdoctor --gate`` semantics between two metric dicts: run the
    doctor's own ``gate`` over a two-record trajectory under the merged
    policy, then split the verdict into banded (soft) regressions and
    hard vetoes — equal-direction flag flips, the HARD_GATE_FLAGS not
    covered by the policy, and candidate crashes."""
    merged = dict(_doctor.DEFAULT_POLICY)
    merged.update(policy or {})
    verdict = _doctor.gate(
        [{"kind": "candidate", "source": "incumbent",
          "metrics": incumbent},
         {"kind": "candidate", "source": "candidate",
          "metrics": candidate}], merged)
    hard = [r for r in verdict["regressions"]
            if r.get("direction") == "equal"]
    soft = [r for r in verdict["regressions"]
            if r.get("direction") != "equal"]
    for flag in HARD_GATE_FLAGS:
        if flag in merged:
            continue  # already judged by the policy pass above
        if incumbent.get(flag) is True and candidate.get(flag) is False:
            hard.append({"metric": flag, "prev": True, "new": False,
                         "direction": "equal",
                         "detail": "flag flipped false"})
    if candidate.get("error"):
        hard.append({"metric": "candidate_error",
                     "detail": str(candidate["error"])})
    return {"ok": not (hard or soft),
            "soft_regressions": soft, "hard_vetoes": hard}


# ---------------------------------------------------------------------------
# The deterministic seeded search.
# ---------------------------------------------------------------------------


def _lcg(seed: int):
    """glibc-constant LCG — the ONLY randomness the decision path sees,
    fully determined by the seed so a run replays."""
    state = int(seed) & 0x7FFFFFFF
    while True:
        state = (1103515245 * state + 12345) % (1 << 31)
        yield state


def _fingerprint(values: dict) -> str:
    return json.dumps(values, sort_keys=True)


def _value_of(metrics: dict, metric: str):
    v = metrics.get(metric)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def reset_between_candidates(*targets) -> None:
    """Bust cross-candidate measurement state: call ``reset_window()``
    on every target that has one (SidecarVerifier's 5 s server-stats
    cache, SidecarServer's adaptive-coalesce window). Back-to-back
    short candidates would otherwise read the previous candidate's
    stats and adapted window."""
    for t in targets:
        fn = getattr(t, "reset_window", None)
        if callable(fn):
            fn()


def run_autotune(spec: SweepSpec, runner, *, budget: int = DEFAULT_BUDGET,
                 seed: int = 0, policy: dict | None = None,
                 baseline_values: dict | None = None,
                 baseline_metrics: dict | None = None,
                 reset=None, verdict_consumed: dict | None = None) -> dict:
    """The closed loop: measure the incumbent (hand-tuned defaults),
    hill-climb the spec's knobs under the gate, return the full
    provenance record. ``runner(values) -> metrics dict`` is the only
    side-effecting call; ``reset()`` (if given) runs before every
    measurement so candidates never read each other's stats."""
    values = _space.default_values(spec.knobs)
    if baseline_values:
        values.update({k: v for k, v in baseline_values.items()
                       if k in values})

    def measure(vals: dict) -> dict:
        if reset is not None:
            reset()
        try:
            metrics = runner(dict(vals))
        except Exception as exc:
            # Candidate crash is isolated: the failure becomes a
            # hard-vetoed candidate record, never a dead search.
            return {"error": f"{type(exc).__name__}: {exc}"}
        if not isinstance(metrics, dict):
            return {"error": f"runner returned {type(metrics).__name__}"}
        return metrics

    rng = _lcg(seed)
    order = list(spec.knobs)
    if order:
        rot = next(rng) % len(order)
        order = order[rot:] + order[:rot]
    directions = {name: ("up" if next(rng) & 1 else "down")
                  for name in order}

    if baseline_metrics is None:
        baseline_metrics = measure(values)
        _tm.inc("autotune_candidates_total")
    best_values = dict(values)
    best_metrics = baseline_metrics
    candidates = [{"id": 0, "role": "incumbent", "knob": None,
                   "values": dict(values), "metrics": baseline_metrics,
                   "gate": None, "accepted": True}]
    decisions: list = []
    tried = {_fingerprint(values)}
    gate_rejections = 0
    exhausted: set = set()

    def propose(name: str):
        knob = _space.KNOBS[name]
        cur = best_values[name]
        first = directions[name]
        for d in (first, "down" if first == "up" else "up"):
            step = _space.step_up if d == "up" else _space.step_down
            nxt = step(knob, cur)
            if nxt is None:
                continue
            cand = dict(best_values)
            cand[name] = nxt
            if _fingerprint(cand) in tried:
                continue
            return d, cur, nxt, cand
        return None

    def better(metrics: dict) -> bool:
        new = _value_of(metrics, spec.metric)
        cur = _value_of(best_metrics, spec.metric)
        if new is None:
            return False
        if cur is None:
            return True
        return new > cur if spec.direction == "higher" else new < cur

    cid = 0
    ki = 0
    while cid < budget and order and len(exhausted) < len(order):
        name = order[ki % len(order)]
        ki += 1
        if name in exhausted:
            continue
        move = propose(name)
        if move is None:
            exhausted.add(name)
            continue
        direction, cur, nxt, cand_values = move
        cid += 1
        tried.add(_fingerprint(cand_values))
        metrics = measure(cand_values)
        _tm.inc("autotune_candidates_total")
        verdict = gate_candidate(baseline_metrics, metrics, policy)
        improves = better(metrics)
        accepted = bool(verdict["ok"] and improves)
        if not verdict["ok"]:
            gate_rejections += 1
            _tm.inc("autotune_gate_rejections_total")
        candidates.append({"id": cid, "role": "candidate", "knob": name,
                           "from": cur, "to": nxt,
                           "values": dict(cand_values),
                           "metrics": metrics, "gate": verdict,
                           "accepted": accepted})
        decisions.append(
            f"{name}:{cur:g}->{nxt:g}:"
            f"{'accept' if accepted else 'reject'}")
        if accepted:
            best_values = cand_values
            best_metrics = metrics
            # A better incumbent re-opens neighbours everywhere.
            exhausted.clear()
        else:
            # Blocked uphill: prefer the other direction next visit.
            directions[name] = ("down" if direction == "up" else "up")

    base_value = _value_of(baseline_metrics, spec.metric)
    best_value = _value_of(best_metrics, spec.metric)
    improved = best_metrics is not baseline_metrics
    improvement_pct = None
    if improved and base_value and best_value is not None:
        improvement_pct = round(
            (best_value - base_value) / base_value * 100.0, 2)
    changed = {k: v for k, v in best_values.items() if v != values[k]}
    result = {
        "autotune_schema": AUTOTUNE_SCHEMA,
        "experiment_id": spec.experiment_id,
        "cause": spec.cause,
        "harness": spec.harness,
        "metric": spec.metric,
        "direction": spec.direction,
        "seed": int(seed),
        "budget": int(budget),
        "knobs": list(spec.knobs),
        "verdict_consumed": verdict_consumed,
        "incumbent": {"values": values, "metrics": baseline_metrics},
        "candidates": candidates,
        "candidates_evaluated": cid,
        "gate_rejections": gate_rejections,
        "best": {"values": best_values, "metrics": best_metrics},
        "baseline_value": base_value,
        "best_value": best_value if best_value is not None else base_value,
        "improved": improved,
        "improvement_pct": improvement_pct,
        "decision_sequence": decisions,
        "committed": improved,
        "overlay": None,
    }
    if improved:
        result["overlay"] = {
            "values": changed,
            "toml": _space.overlay_toml(changed),
            "env": _space.env_for(changed),
            "harness_kwargs": _space.harness_kwargs_for(
                changed, HARNESSES[spec.harness][0]),
        }
    return result


# ---------------------------------------------------------------------------
# Runners.
# ---------------------------------------------------------------------------


def make_mock_runner(spec: SweepSpec, curve: str = "monotone",
                     base: float = 1000.0):
    """Deterministic knob-response surfaces for tests and ``--mock``:
    the metric is a pure function of the candidate values (position of
    each knob inside its bounds), so replays are exact.

      monotone    value rises with every knob raised
      regressing  value falls with every knob raised
      noisy       monotone plus deterministic hash jitter
      cliff       value rises BUT any knob above its default flips the
                  exactly-once flag False (the hard-gate fixture)
    """
    knobs = [_space.KNOBS[n] for n in spec.knobs]
    if curve not in ("monotone", "regressing", "noisy", "cliff"):
        raise ValueError(f"unknown mock curve {curve!r}")

    def position(vals: dict) -> float:
        total = 0.0
        for k in knobs:
            span = k.hi - k.lo
            total += ((float(vals[k.name]) - k.lo) / span) if span else 0.0
        return total / len(knobs) if knobs else 0.0

    def runner(vals: dict) -> dict:
        pos = position(vals)
        once = True
        if curve == "monotone":
            value = base * (1.0 + 0.8 * pos)
        elif curve == "regressing":
            value = base * max(0.05, 1.0 - 0.8 * pos)
        elif curve == "noisy":
            jitter = (zlib.crc32(_fingerprint(vals).encode())
                      % 1000) / 1000.0
            value = base * (1.0 + 0.8 * pos + 0.05 * (jitter - 0.5))
        else:  # cliff
            value = base * (1.0 + 0.8 * pos)
            once = all(float(vals[k.name]) <= k.default for k in knobs)
        return {spec.metric: round(value, 3),
                "p99_ms": round(50.0 * base / max(value, 1e-9), 3),
                "exactly_once_all": once}

    return runner


def make_ingest_runner(*, rates=(2400.0,), n_tx: int = 400, width: int = 1,
                       workers: int = 2, notary: str = "simple",
                       max_seconds: float = 240.0):
    """The real thing: each candidate runs a small multiprocess ingest
    sweep. Config-target knobs travel to every spawned node as ONE
    ``CORDA_TPU_CONFIG_OVERLAY`` env (merged over node.toml by
    ``NodeConfig.load``), env-target knobs as their own vars, harness
    knobs as loadtest kwargs — then the env is restored so candidates
    never leak into each other or the caller. Only values that MOVED
    from the hand-tuned defaults ship: the incumbent runs overlay-free
    (it IS the default config), and a default is not always a no-op to
    restate (a [notary_shards] section enables sharding even at the
    default count)."""
    from ..tools import loadtest as _loadtest

    def runner(vals: dict) -> dict:
        vals = _space.changed_values(vals)
        overlay = _space.overlay_for(vals)
        env_vars = _space.env_for(vals)
        if overlay:
            env_vars["CORDA_TPU_CONFIG_OVERLAY"] = json.dumps(
                overlay, sort_keys=True)
        saved = {k: os.environ.get(k) for k in env_vars}
        os.environ.update(env_vars)
        try:
            sweep = _loadtest.run_ingest_sweep(
                rates=tuple(rates), n_tx=n_tx, width=width,
                workers=workers, notary=notary, max_seconds=max_seconds,
                **_space.harness_kwargs_for(vals, "run_ingest_sweep"))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rows = [r for r in sweep.results.values()
                if isinstance(r, dict) and "error" not in r]
        if not rows:
            return {"error": "every offered rate failed"}
        peak = max(rows, key=lambda r: r.get("achieved_tx_s") or 0.0)
        return {
            "peak_achieved_tx_s": peak.get("achieved_tx_s"),
            "p99_ms": peak.get("p99_ms"),
            "exactly_once_all": all(bool(r.get("exactly_once"))
                                    for r in rows),
            "first_bottleneck": sweep.first_bottleneck,
        }

    return runner
