"""Always-on telemetry: counters, log-bucketed histograms, and the
flight recorder.

The port's own copy of ``corda_tpu/obs/telemetry.py``: the same metric
names, bucketing and snapshot shape, so a registry of either package
renders (obs/export.py) to the same Prometheus text. In this package the
verify sidecar counts its requests, batches and signatures here.

The trace subsystem (obs/trace.py) answers "where did THIS request go"
— but only when an operator re-runs with tracing armed. This module is
the other half of the observability plane: a process-global metric
registry that is armed at import time, cheap enough to leave on in the
flagship path, and captured automatically at the moment something goes
wrong.

Three pieces:

  * ``TelemetryRegistry`` — monotonic counters plus HDR-style
    power-of-two latency histograms. Every metric name comes from the
    single-source-of-truth tuples below (``COUNTER_NAMES`` /
    ``HISTOGRAM_NAMES``), the same registry pattern ``obs/stages.py``
    uses for span names; the analyzer's ``trace-stage-registry`` rule
    enforces it at every ``inc(...)`` / ``observe(...)`` site so a
    typo'd metric cannot silently vanish from every dashboard.
  * the **round profiler feed** — ``observe_round`` takes one wall-time
    plus the per-phase deltas the node run loop measures
    (``ROUND_PHASES``: poll, verify_wait, seal, replicate, apply,
    reply) and fans them into the per-phase counters/histograms through
    pre-interned handles: one attribute check when disarmed, a handful
    of dict-free adds when armed.
  * ``FlightRecorder`` — a bounded ring of recent metric deltas and
    notes that dumps ONE JSON artifact per trigger reason (SLO breach,
    overload spike, fsck failure, crash) so post-hoc diagnosis never
    requires reproducing the run.

Concurrency contract: counters and histograms are update-racy by design
("lock-light"). A counter ``+=`` from two threads can drop an increment;
that is an accepted monitoring-grade error bound — the round loop owns
almost every hot metric single-threaded, and the few cross-thread
writers (sidecar executor, admission controller) tolerate last-writer
drift. Nothing here is consensus state. The flight recorder's dump latch
IS locked: "exactly one artifact per reason" is a contract, not a trend.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = [
    "ACTIVE",
    "COUNTER_NAMES",
    "HISTOGRAM_NAMES",
    "METRIC_NAMES",
    "ROUND_PHASES",
    "Counter",
    "FlightRecorder",
    "Histogram",
    "TelemetryRegistry",
    "arm",
    "disarm",
    "ensure_flight",
    "flight_note",
    "flight_trigger",
    "format_breakdown",
    "inc",
    "observe",
    "observe_round",
    "snapshot",
]

# ---------------------------------------------------------------------------
# The metric name registry (single source of truth — the analyzer's
# trace-stage-registry rule checks every literal inc()/observe() name in
# the tree against these tuples, exactly as it checks span names against
# obs/stages.py).
# ---------------------------------------------------------------------------

# The round loop's named sub-phases, in breakdown display order. Every
# phase owns one `round_phase_<p>_seconds_total` counter and one
# `round_phase_<p>_seconds` histogram below.
ROUND_PHASES = ("poll", "verify_wait", "seal", "replicate", "apply",
                "reply")

COUNTER_NAMES = (
    # Round profiler (node.run_once): rounds and attributed wall time.
    "rounds_total",
    "round_wall_seconds_total",
    "round_phase_poll_seconds_total",
    "round_phase_verify_wait_seconds_total",
    "round_phase_seal_seconds_total",
    "round_phase_replicate_seconds_total",
    "round_phase_apply_seconds_total",
    "round_phase_reply_seconds_total",
    # Flow lifecycle (statemachine.py).
    "flows_started_total",
    "flows_completed_total",
    # Verify plane (statemachine micro-batches; sigs = signatures).
    "verify_batches_total",
    "verify_sigs_total",
    # Raft leader seal path (services/raft.py).
    "raft_seals_total",
    "raft_seal_entries_total",
    # Pipelined commit plane (services/raft.py apply executor): wall time
    # the executor overlapped under the consensus thread (kept OUT of the
    # round_phase_* family so phase coverage never double-counts it),
    # executor batches completed, and submissions shed off a full queue.
    "round_overlap_apply_seconds_total",
    "raft_apply_batches_total",
    "raft_apply_shed_total",
    # Admission controller (qos/admission.py).
    "admission_admitted_total",
    "admission_shed_total",
    # Sidecar server (crypto/sidecar.py).
    "sidecar_requests_total",
    "sidecar_batches_total",
    "sidecar_sigs_total",
    # Federation router (crypto/federation.py): batches dispatched to a
    # host channel, hedged re-dispatches fired, and per-host quarantine
    # events (a host demoted to its cooldown re-probe).
    "federation_dispatches_total",
    "federation_hedges_total",
    "federation_host_degraded_total",
    # The recorder's own audit trail.
    "flight_dumps_total",
    # The performance doctor (obs/doctor.py, bench.bench_doctor):
    # verdicts produced, and regressions the trajectory gate flagged.
    "doctor_runs_total",
    "doctor_gate_regressions_total",
    # Partition plane (round 20): pre-vote canvasses run / rejected
    # (services/raft.py), leaders deposed by check-quorum, and partition
    # cut activations from the fault engine (testing/faults.py).
    "raft_prevotes_total",
    "raft_prevote_rejections_total",
    "raft_checkquorum_stepdowns_total",
    "partition_cuts_total",
    # Autotune plane (round 21, corda_tpu/autotune/): sweep candidates
    # measured, candidates the incumbent gate vetoed, and runtime-leg
    # hard reverts (the revert-on-regression guard firing).
    "autotune_candidates_total",
    "autotune_gate_rejections_total",
    "autotune_reverts_total",
    # Indexed vault plane (round 22, node/services/vault.py): queries
    # answered (pages + coin selections), coins skipped because another
    # flow's soft lock held them, and expired reservations reaped by the
    # TTL sweep (each reap re-admits a coin a crashed flow had shadowed).
    "vault_queries_total",
    "vault_selection_conflicts_total",
    "vault_softlock_expired_total",
)

HISTOGRAM_NAMES = (
    "round_wall_seconds",
    "round_phase_poll_seconds",
    "round_phase_verify_wait_seconds",
    "round_phase_seal_seconds",
    "round_phase_replicate_seconds",
    "round_phase_apply_seconds",
    "round_phase_reply_seconds",
    "verify_batch_sigs",
    "raft_seal_entries",
    "raft_apply_batch_commands",
    "sidecar_batch_sigs",
)

METRIC_NAMES = frozenset(COUNTER_NAMES) | frozenset(HISTOGRAM_NAMES)

# ---------------------------------------------------------------------------
# Counters and histograms
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter. ``add`` is one float add — intentionally
    unlocked (see the module concurrency contract)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n


# Histograms bucket by power of two (HDR-style): bucket i holds values v
# with int(v * scale).bit_length() == i, i.e. v*scale in [2**(i-1), 2**i).
# Seconds-valued histograms scale to microseconds first so sub-second
# latencies spread over ~20 buckets instead of collapsing into one;
# count-valued histograms (batch sizes) use the raw integer. 64 buckets
# cover every representable magnitude — the index is clamped, never
# dropped.
_SECONDS_SCALE = 1_000_000
_MAX_BUCKET = 63


class Histogram:
    """Log-bucketed (power-of-two) histogram with exact count and sum.

    ``buckets`` is a sparse {index: count} dict; the upper bound of
    bucket i is ``2**i / scale`` (cumulative over indices <= i), which
    is what the Prometheus renderer in obs/export.py emits as ``le``."""

    __slots__ = ("name", "scale", "count", "sum", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.scale = _SECONDS_SCALE if name.endswith("_seconds") else 1
        self.count = 0
        self.sum = 0.0
        self.buckets: dict[int, int] = {}

    def observe(self, value: float) -> None:
        idx = int(value * self.scale).bit_length()
        if idx > _MAX_BUCKET:
            idx = _MAX_BUCKET
        self.count += 1
        self.sum += value
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def bucket_upper(self, idx: int) -> float:
        return (1 << idx) / self.scale

    def quantile(self, q: float) -> float | None:
        """Approximate quantile: the upper bound of the bucket where the
        cumulative count crosses q — an over-estimate by at most 2x
        (one power-of-two bucket), which is the HDR trade."""
        if not self.count:
            return None
        target = q * self.count
        run = 0
        for idx in sorted(self.buckets):
            run += self.buckets[idx]
            if run >= target:
                return self.bucket_upper(idx)
        return self.bucket_upper(max(self.buckets))

    def snap(self) -> dict:
        return {"count": self.count, "sum": round(self.sum, 9),
                "scale": self.scale,
                "buckets": {str(i): n for i, n in sorted(
                    self.buckets.items())}}


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


class TelemetryRegistry:
    """All registered counters/histograms, pre-interned at construction.

    Lookups by unregistered name raise — the runtime closes the same
    drop-a-metric hole the analyzer closes lexically (a dynamic name
    built outside obs/ cannot sneak past the literal-name rule)."""

    def __init__(self):
        self.counters = {n: Counter(n) for n in COUNTER_NAMES}
        self.histograms = {n: Histogram(n) for n in HISTOGRAM_NAMES}
        # Optional FlightRecorder, attached by ensure_flight(); None
        # means triggers are no-ops (the default for tests and ad-hoc
        # processes that configured no dump directory).
        self.flight: FlightRecorder | None = None
        # Pre-interned handles for the per-round fast path: one tuple
        # per phase, resolved once, so observe_round never does a name
        # lookup. (Dynamic name construction is fine HERE — obs/ is the
        # registry module and is excluded from the lexical rule.)
        self._rounds = self.counters["rounds_total"]
        self._round_wall_c = self.counters["round_wall_seconds_total"]
        self._round_wall_h = self.histograms["round_wall_seconds"]
        self._round_handles = tuple(
            (p, self.counters[f"round_phase_{p}_seconds_total"],
             self.histograms[f"round_phase_{p}_seconds"])
            for p in ROUND_PHASES)

    def counter(self, name: str) -> Counter:
        try:
            return self.counters[name]
        except KeyError:
            raise ValueError(
                f"telemetry counter {name!r} is not registered in "
                "obs/telemetry.py COUNTER_NAMES") from None

    def histogram(self, name: str) -> Histogram:
        try:
            return self.histograms[name]
        except KeyError:
            raise ValueError(
                f"telemetry histogram {name!r} is not registered in "
                "obs/telemetry.py HISTOGRAM_NAMES") from None

    def observe_round(self, wall_s: float, phases: dict) -> None:
        self._rounds.value += 1
        self._round_wall_c.value += wall_s
        self._round_wall_h.observe(wall_s)
        for name, counter, hist in self._round_handles:
            v = phases.get(name, 0.0)
            counter.value += v
            hist.observe(v)

    def snapshot(self) -> dict:
        """JSON-safe copy: {"counters": {name: value}, "histograms":
        {name: {count, sum, scale, buckets}}}. The exact shape
        obs/export.py renders, parses, and merges."""
        return {
            "counters": {n: round(c.value, 9)
                         for n, c in self.counters.items()},
            "histograms": {n: h.snap()
                           for n, h in self.histograms.items()},
        }

    def reset(self) -> None:
        for c in self.counters.values():
            c.value = 0.0
        for h in self.histograms.values():
            h.count = 0
            h.sum = 0.0
            h.buckets.clear()


# ---------------------------------------------------------------------------
# The flight recorder
# ---------------------------------------------------------------------------

FLIGHT_ENV = "CORDA_TPU_FLIGHT_DIR"


class FlightRecorder:
    """Bounded ring of recent metric deltas + notes; dumps one JSON
    artifact per trigger REASON and latches (a crash loop or a sustained
    overload produces one dump, not a disk-filling stream).

    ``tick`` entries are the "recent history" half of the artifact: the
    caller feeds whatever per-window snapshot it has (the cluster harness feeds
    per-rate sweep rows, a node could feed metric samples) and the
    recorder stores the numeric deltas vs the previous tick, so the
    window reads as rates, not lifetime totals."""

    def __init__(self, dump_dir: str, node: str = "",
                 capacity: int = 256):
        self.dump_dir = str(dump_dir)
        self.node = node
        self.ring: deque = deque(maxlen=int(capacity))
        self.dumped: dict[str, str] = {}  # reason -> artifact path
        self._last_tick: dict | None = None
        self._lock = threading.Lock()

    def tick(self, sample: dict) -> None:
        prev = self._last_tick or {}
        delta = {}
        for k, v in sample.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and isinstance(prev.get(k), (int, float)):
                delta[k] = round(v - prev[k], 9)
        self._last_tick = dict(sample)
        self.ring.append({"t": round(time.time(), 3), "kind": "tick",
                          "sample": sample, "delta": delta or None})

    def note(self, kind: str, **payload) -> None:
        self.ring.append({"t": round(time.time(), 3), "kind": kind,
                          **payload})

    def stats(self) -> dict:
        return {"dir": self.dump_dir, "node": self.node,
                "ring": len(self.ring),
                "dumped": dict(self.dumped)}

    def trigger(self, reason: str, extra: dict | None = None,
                spans: list | None = None) -> str | None:
        """Dump the artifact for ``reason`` (latched: the first trigger
        per reason writes, every later one returns the same path).
        Never raises — a broken disk must not take down the round loop
        it is trying to explain."""
        with self._lock:
            if reason in self.dumped:
                return self.dumped[reason]
            # Reserve the latch before the slow write so a concurrent
            # trigger can't double-dump.
            path = os.path.join(
                self.dump_dir,
                f"flight-{self.node or 'node'}-{reason}-{os.getpid()}"
                ".json")
            self.dumped[reason] = path
        try:
            if spans is None:
                from . import trace as _obs

                rec = _obs.ACTIVE
                spans = rec.snapshot()[-200:] if rec is not None else []
            reg = ACTIVE
            artifact = {
                "reason": reason,
                "ts": round(time.time(), 3),
                "node": self.node,
                "pid": os.getpid(),
                "window": list(self.ring),
                "metrics": reg.snapshot() if reg is not None else None,
                "spans": spans,
                "extra": extra,
            }
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(artifact, f, default=str)
            os.replace(tmp, path)
            inc("flight_dumps_total")
            return path
        # lint: allow(no-silent-except) flight recorder is best-effort diagnostics: a full disk or unserializable extra must never crash (or recurse into) the failing path that triggered the dump
        except Exception:
            return None


# ---------------------------------------------------------------------------
# Module-level arming + hot-path helpers
# ---------------------------------------------------------------------------

# Always-on: armed at import, unlike trace/faults/qos which arm on
# request. ``disarm()`` exists for tests that need to prove the
# one-attribute-check cost bound.
ACTIVE: TelemetryRegistry | None = TelemetryRegistry()


def arm() -> TelemetryRegistry:
    """Install a FRESH registry (and return it) — test/bench isolation;
    production processes keep the import-time instance."""
    global ACTIVE
    ACTIVE = TelemetryRegistry()
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def inc(name: str, n: float = 1.0) -> None:
    reg = ACTIVE
    if reg is None:
        return
    reg.counter(name).value += n


def observe(name: str, value: float) -> None:
    reg = ACTIVE
    if reg is None:
        return
    reg.histogram(name).observe(value)


def observe_round(wall_s: float, phases: dict) -> None:
    reg = ACTIVE
    if reg is None:
        return
    reg.observe_round(wall_s, phases)


def snapshot() -> dict | None:
    reg = ACTIVE
    return reg.snapshot() if reg is not None else None


def ensure_flight(dump_dir: str | None = None,
                  node: str = "") -> FlightRecorder | None:
    """Attach a FlightRecorder to the active registry (idempotent).
    ``dump_dir`` falls back to $CORDA_TPU_FLIGHT_DIR; with neither set
    this is a no-op and every trigger stays a no-op."""
    reg = ACTIVE
    if reg is None:
        return None
    if reg.flight is not None:
        return reg.flight
    dump_dir = dump_dir or os.environ.get(FLIGHT_ENV)
    if not dump_dir:
        return None
    reg.flight = FlightRecorder(dump_dir, node=node)
    return reg.flight


def flight_note(kind: str, **payload) -> None:
    reg = ACTIVE
    if reg is not None and reg.flight is not None:
        reg.flight.note(kind, **payload)


def flight_trigger(reason: str, extra: dict | None = None,
                   spans: list | None = None) -> str | None:
    reg = ACTIVE
    if reg is None or reg.flight is None:
        return None
    return reg.flight.trigger(reason, extra=extra, spans=spans)


# ---------------------------------------------------------------------------
# Round-breakdown formatting (shared by rpc.node_metrics, the node's
# metric history sampler, loadtest stamps, and bench_telemetry — one
# formatter so the artifact shape can't fork).
# ---------------------------------------------------------------------------


def format_breakdown(round_phase_s: dict | None) -> dict | None:
    """``round_phase_s`` (node.run_once accumulators: the six ROUND_PHASES
    plus "wall" and "rounds") -> the ``round_breakdown`` block:
    per-phase totals and wall-time shares, plus ``coverage`` — the
    fraction of measured round wall time the named phases attribute
    (the >= 0.9 acceptance bound)."""
    rp = round_phase_s or {}
    rounds = rp.get("rounds", 0)
    if not rounds:
        return None
    wall = rp.get("wall", 0.0) or 0.0
    phases = {}
    covered = 0.0
    for p in ROUND_PHASES:
        v = rp.get(p, 0.0) or 0.0
        covered += v
        phases[p] = {"total_s": round(v, 6),
                     "share": round(v / wall, 4) if wall else None}
    out = {
        "rounds": rounds,
        "wall_s": round(wall, 6),
        "phases": phases,
        "coverage": round(covered / wall, 4) if wall else None,
        "busiest_phase": max(ROUND_PHASES,
                             key=lambda p: rp.get(p, 0.0) or 0.0),
    }
    # Pipelined commit plane: executor wall time that ran UNDER the six
    # in-loop phases. Reported beside them, never inside — coverage stays
    # a partition of the consensus thread's wall time (no double counts),
    # and vs_wall > 0 is the self-describing proof rounds overlapped.
    overlap = rp.get("overlap_apply", 0.0) or 0.0
    if overlap:
        out["overlap"] = {"apply": {
            "total_s": round(overlap, 6),
            "vs_wall": round(overlap / wall, 4) if wall else None,
        }}
    return out
