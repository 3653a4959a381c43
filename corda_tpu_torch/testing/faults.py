"""Deterministic fault injection for the notary pipeline.

The port's own copy of ``corda_tpu/testing/faults.py``: the same points,
rules, seeded schedules, partition specs and TOML plan format, and the same
``PLAN_ENV`` name, so one plan file arms both packages' processes. In this
package the hooks fire from:

* ``transport.send`` -- inmem ``_transmit``: drop, delay, duplicate,
  reorder, crash;
* ``transport.recv`` -- inmem ``pump``: drop, delay, crash;
* ``transport.partition`` -- inmem ``_transmit`` / ``pump``: the
  schedule-driven cut (see below);
* ``verify.device`` -- the AsyncVerifyService feeder thread: fail, slow,
  crash;
* ``checkpoint.write`` -- SMM ``_write_checkpoint`` (:func:`fire_fsync`):
  fail, stall, crash;
* ``transport.send`` / ``transport.recv`` / ``transport.partition`` --
  also tcp ``send`` / ``send_many`` / ``_dispatch``;
* ``netmap.refresh`` -- Node ``refresh_netmap``: drop, stall, crash;
* ``disk.corrupt`` -- the checkpoint restore read
  (:func:`fire_disk_corrupt`): flip (a seeded bit-flip on read);
* ``disk.full`` -- the uniqueness provider's commit and the raft log
  append (:func:`fire_disk_full`): full, stall, crash;
* ``raft.append`` -- RaftMember ``_send`` (append traffic): drop, delay,
  duplicate, crash;
* ``raft.fsync`` -- the raft log append (sqlite insert and commit): fail,
  stall, crash;
* ``shard.handoff`` -- the reshard coordinator, per streamed state frame:
  drop, stall, crash;
* ``disk.corrupt`` -- also the raft log read path.

``builtin_plan`` names the reference's plans (``lossy``, ``slow-disk``,
``flaky-device``, ``reshard``, ``bitrot`` and the partition family) with
the same seeds and rules.

A process arms at most one :class:`FaultPlan`.  A hook consults the
module-level ``ACTIVE`` plan; when no plan is armed the hook is a single
attribute check (``faults.ACTIVE is not None``).

``transport.partition`` is NOT rule-driven: a plan carries a list of
:class:`PartitionSpec` entries (symmetric ``split``, one-way ``asym``,
toggling ``flap``) whose activity is a pure function of the point's
event counter — the transport offers every frame to
:func:`fire_partition` and drops it while a cut covering the
(sender, recipient) pair is live.  ``bind_partition_nodes`` resolves
auto-sided specs over the cluster identities; ``heal_partitions`` lifts
every cut.  TOML plans declare them as ``[[partition]]`` tables
(``kind`` / ``a`` / ``b`` / ``after`` / ``duration`` / ``period``).

``shard.handoff`` crash is the coordinator-death-mid-handoff case (the
next leader of the source group re-runs the idempotent sequence);
``netmap.refresh`` drop keeps a node routing on a stale shard directory —
its requests bounce ``WrongShardEpoch`` until a later refresh lands.

Determinism: every rule owns a ``random.Random`` seeded from
``(plan seed, point, rule index)``, and probability draws consume that
stream one draw per *event at that point*.  Two plans built from the same
seed and rule list therefore produce the same fault schedule regardless
of how events at different points interleave.

TOML plan format (see ``plan_from_toml``)::

    seed = 7

    [[rule]]
    point = "transport.send"
    action = "drop"
    p = 0.05           # fire probability per event (default 1.0)
    delay_s = 0.0      # delay/stall/slow duration (inmem: ticks)
    after = 0          # skip the first N events at this point
    max_fires = 100    # stop firing after N fires (0 = unlimited)
    node = "Raft1"     # only armed on this node (default: all)

Arming across OS processes: export ``CORDA_TPU_FAULT_PLAN=/path/plan.toml``
and call :func:`arm_from_env` with the process's node name so per-node
rules filter correctly.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "POINTS",
    "FaultRule",
    "FaultPlan",
    "PartitionSpec",
    "ACTIVE",
    "arm",
    "disarm",
    "injected",
    "fire",
    "fire_fsync",
    "fire_disk_corrupt",
    "fire_disk_full",
    "fire_partition",
    "partitioned",
    "bind_partition_nodes",
    "heal_partitions",
    "plan_from_toml",
    "arm_from_env",
    "builtin_plan",
    "PLAN_ENV",
]

POINTS = (
    "transport.send",
    "transport.recv",
    "transport.partition",
    "raft.append",
    "raft.fsync",
    "verify.device",
    "checkpoint.write",
    "shard.handoff",
    "netmap.refresh",
    "disk.corrupt",
    "disk.full",
)

# Exit code used by the "crash" action so harnesses can tell an injected
# crash from a genuine one.
CRASH_EXIT_CODE = 70

PLAN_ENV = "CORDA_TPU_FAULT_PLAN"


@dataclass
class FaultRule:
    """One named fault at one injection point."""

    point: str
    action: str           # drop | delay | duplicate | reorder | fail | stall | slow | crash
    p: float = 1.0        # fire probability per event
    delay_s: float = 0.0  # delay/stall/slow duration (ticks for inmem)
    after: int = 0        # skip the first N events at this point
    max_fires: int = 0    # 0 = unlimited
    node: str | None = None  # restrict to one node name

    # runtime state (not part of the plan identity)
    fires: int = field(default=0, compare=False)
    _rng: random.Random = field(default=None, compare=False, repr=False)

    def exhausted(self) -> bool:
        return self.max_fires > 0 and self.fires >= self.max_fires


@dataclass
class PartitionSpec:
    """One scheduled network partition (the ``transport.partition`` point).

    Scheduling is EVENT-counted, not wall-clocked: every frame offered to
    ``fire_partition`` advances the point's event counter, and a spec is
    active as a pure function of that counter — two runs of the same plan
    over the same traffic cut identically, with no timing dependence.

    ``kind``:
      * ``split`` — symmetric split-brain: frames between side ``a`` and
        side ``b`` drop in BOTH directions while the cut holds.
      * ``asym`` — one-way cut: frames from ``a`` to ``b`` drop; ``b`` to
        ``a`` still delivers (the half-open link Raft's paper warns about).
      * ``flap`` — a ``split`` that toggles every ``period`` events; a
        ``period`` of 0 derives one deterministically from the plan seed.

    Sides hold node identities (``str(transport address)`` — both
    transports offer their address objects and the engine normalizes
    with ``str()``, so TcpAddress and InMemoryAddress mix-ins match
    however a hook spells the endpoint). Empty sides resolve at
    ``bind_partition_nodes`` time: ``split``/``flap`` put the FIRST
    ``n//2`` bound ids on side ``a`` (the minority when n is odd, so a
    harness that binds the leader first proves the minority-leader case);
    ``asym`` isolates the first id's egress.
    """

    kind: str                     # split | asym | flap
    a: tuple = ()                 # side-a identities (empty = auto)
    b: tuple = ()                 # side-b identities (empty = auto)
    after: int = 0                # events before the cut arms
    duration: int = 0             # events the cut (or flap phase) spans;
    #                               0 = held until heal_partitions()
    period: int = 0               # flap half-cycle in events (0 = seeded)

    def active(self, seen: int) -> bool:
        """Pure schedule query: is this cut live after *seen* events?"""
        since = seen - self.after
        if since <= 0:
            return False
        if self.duration > 0 and since > self.duration:
            return False
        if self.kind == "flap":
            return ((since - 1) // max(1, self.period)) % 2 == 0
        return True

    def cuts(self, src: str, dst: str) -> bool:
        """Does this spec drop a *src* -> *dst* frame while active?"""
        if src in self.a and dst in self.b:
            return True
        return self.kind != "asym" and src in self.b and dst in self.a


class FaultPlan:
    """A seeded set of fault rules, armed process-wide via :func:`arm`.

    ``node_name`` filters rules with a ``node=`` restriction at
    construction time; filtering never perturbs the per-rule RNG streams
    because each rule is seeded from its index in the *original* rule
    list.
    """

    def __init__(self, seed: int, rules: list[FaultRule],
                 node_name: str | None = None,
                 partitions: list[PartitionSpec] | None = None):
        self.seed = int(seed)
        self.node_name = node_name
        self._lock = threading.Lock()
        # event counter per point (all events, fired or not)
        self.events: dict[str, int] = {}
        # fired counter per "point:action"
        self.counters: dict[str, int] = {}
        armed = []
        for idx, rule in enumerate(rules):
            if rule.point not in POINTS:
                raise ValueError(f"unknown injection point {rule.point!r}")
            rule._rng = random.Random(f"{self.seed}:{rule.point}:{idx}")
            rule.fires = 0
            if rule.node is not None and node_name is not None \
                    and rule.node != node_name:
                continue
            armed.append(rule)
        self.rules = armed
        self._by_point: dict[str, list[FaultRule]] = {}
        for rule in self.rules:
            self._by_point.setdefault(rule.point, []).append(rule)
        self.partitions: list[PartitionSpec] = list(partitions or [])
        for idx, spec in enumerate(self.partitions):
            if spec.kind not in ("split", "asym", "flap"):
                raise ValueError(f"unknown partition kind {spec.kind!r}")
            spec.a, spec.b = tuple(spec.a), tuple(spec.b)
            if spec.kind == "flap" and spec.period <= 0:
                # The seeded flap period the docstring promises.
                spec.period = random.Random(
                    f"{self.seed}:transport.partition:flap:{idx}"
                ).randrange(40, 160)
        self._partitions_healed = False
        # Edge-detection state per spec: a cut transition (inactive ->
        # active) counts once as "transport.partition:cut".
        self._partition_was_active = [False] * len(self.partitions)

    # -- the transport.partition point -------------------------------------

    def bind_partition_nodes(self, node_ids) -> None:
        """Resolve auto (empty-sided) partition specs over the cluster's
        identities, in the caller's order — the harness decides which
        side the leader lands on by binding it first."""
        ids = tuple(str(n) for n in node_ids)
        with self._lock:
            for spec in self.partitions:
                if spec.a and spec.b:
                    continue
                if spec.kind == "asym":
                    spec.a, spec.b = ids[:1], ids[1:]
                else:
                    spec.a, spec.b = ids[:len(ids) // 2], ids[len(ids) // 2:]

    def heal_partitions(self) -> None:
        """Permanently lift every cut (the harness's timed heal)."""
        with self._lock:
            self._partitions_healed = True

    def fire_partition(self, src, dst) -> bool:
        """Record one frame event at ``transport.partition``; return True
        when an active cut drops the *src* -> *dst* frame.  Unlike
        :meth:`partitioned` this ADVANCES the schedule — call it exactly
        once per offered frame."""
        src, dst = str(src), str(dst)
        with self._lock:
            self.events["transport.partition"] = seen = \
                self.events.get("transport.partition", 0) + 1
            if self._partitions_healed or not self.partitions:
                return False
            drop = False
            for idx, spec in enumerate(self.partitions):
                live = spec.active(seen)
                if live and not self._partition_was_active[idx]:
                    self.counters["transport.partition:cut"] = \
                        self.counters.get("transport.partition:cut", 0) + 1
                    try:  # telemetry is best-effort from the fault engine
                        from ..obs import telemetry as _tm

                        _tm.inc("partition_cuts_total")
                    # lint: allow(no-silent-except) the fault engine sits inside every transport send — a broken/partially-imported telemetry module must cost the counter, never the frame
                    except Exception:  # noqa: BLE001 - never fail a frame
                        pass
                self._partition_was_active[idx] = live
                if live and spec.cuts(src, dst):
                    drop = True
            if drop:
                self.counters["transport.partition:drop"] = \
                    self.counters.get("transport.partition:drop", 0) + 1
            return drop

    def partitioned(self, src, dst) -> bool:
        """Pure query: would a *src* -> *dst* frame drop RIGHT NOW?  Never
        advances the event counter — safe for polling (the TCP bridge
        parks on this instead of spin-resending across a held cut)."""
        src, dst = str(src), str(dst)
        with self._lock:
            if self._partitions_healed:
                return False
            seen = self.events.get("transport.partition", 0)
            return any(spec.active(seen) and spec.cuts(src, dst)
                       for spec in self.partitions)

    def fire(self, point: str) -> tuple[str, float] | None:
        """Record one event at *point*; return ``(action, delay_s)`` when a
        rule fires, else ``None``.  The ``crash`` action never returns."""
        rules = self._by_point.get(point)
        with self._lock:
            self.events[point] = self.events.get(point, 0) + 1
            seen = self.events[point]
            if not rules:
                return None
            for rule in rules:
                if rule.exhausted() or seen <= rule.after:
                    continue
                # one draw per event keeps the schedule independent of
                # which earlier rules fired
                if rule.p < 1.0 and rule._rng.random() >= rule.p:
                    continue
                rule.fires += 1
                key = f"{point}:{rule.action}"
                self.counters[key] = self.counters.get(key, 0) + 1
                if rule.action == "crash":
                    os._exit(CRASH_EXIT_CODE)
                return rule.action, rule.delay_s
        return None

    def injected(self) -> dict[str, int]:
        """Copy of the fired counters (``point:action`` -> count)."""
        with self._lock:
            return dict(self.counters)

    def event_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self.events)


# The armed plan.  Hooks read this exactly once per event:
#   if faults.ACTIVE is not None: ...
ACTIVE: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    global ACTIVE
    ACTIVE = plan
    return plan


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def injected() -> dict[str, int]:
    """Fired counters of the armed plan (empty dict when disarmed)."""
    plan = ACTIVE
    return plan.injected() if plan is not None else {}


def fire(point: str) -> tuple[str, float] | None:
    """Convenience: fire *point* against the armed plan, if any."""
    plan = ACTIVE
    return plan.fire(point) if plan is not None else None


def fire_partition(src, dst) -> bool:
    """Hook body for ``transport.partition``: True = drop the frame.
    Counts one schedule event; call once per offered frame."""
    plan = ACTIVE
    return plan.fire_partition(src, dst) if plan is not None else False


def partitioned(src, dst) -> bool:
    """Pure cut query against the armed plan (no schedule advance)."""
    plan = ACTIVE
    return plan.partitioned(src, dst) if plan is not None else False


def bind_partition_nodes(node_ids) -> None:
    """Resolve auto partition sides on the armed plan, if any."""
    plan = ACTIVE
    if plan is not None:
        plan.bind_partition_nodes(node_ids)


def heal_partitions() -> None:
    """Lift every cut on the armed plan, if any."""
    plan = ACTIVE
    if plan is not None:
        plan.heal_partitions()


def fire_fsync(point: str) -> None:
    """Shared hook body for durability points (``raft.fsync``,
    ``checkpoint.write``): ``stall`` sleeps, ``fail`` raises OSError."""
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire(point)
    if act is None:
        return
    action, delay_s = act
    if action == "stall" and delay_s > 0:
        time.sleep(delay_s)
    elif action in ("fail", "raise"):
        raise OSError(f"fault injected: {point} failure")


def fire_disk_corrupt(blob: bytes) -> bytes:
    """Hook body for ``disk.corrupt``: when a rule fires, return *blob*
    with ONE deterministically-chosen bit flipped (models media bitrot on
    a read path — the stored bytes are untouched, so detection + truncate
    + re-replication genuinely recovers).  The flipped position derives
    from the plan seed and the point's event count, so two runs of the
    same plan corrupt the same reads identically."""
    plan = ACTIVE
    if plan is None or not blob:
        return blob
    act = plan.fire("disk.corrupt")
    if act is None:
        return blob
    action, _delay_s = act
    if action not in ("flip", "corrupt"):
        return blob
    with plan._lock:
        event = plan.events.get("disk.corrupt", 0)
    pos = random.Random(f"{plan.seed}:disk.corrupt:bit:{event}").randrange(
        len(blob) * 8)
    flipped = bytearray(blob)
    flipped[pos // 8] ^= 1 << (pos % 8)
    return bytes(flipped)


def fire_disk_full() -> None:
    """Hook body for ``disk.full``: ``full``/``fail`` raises the exact
    OperationalError sqlite produces on disk exhaustion (so catch sites
    exercise the same string-match they use in production), ``stall``
    sleeps."""
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("disk.full")
    if act is None:
        return
    action, delay_s = act
    if action == "stall" and delay_s > 0:
        time.sleep(delay_s)
    elif action in ("full", "fail"):
        import sqlite3
        raise sqlite3.OperationalError("database or disk is full")


def plan_from_toml(text: str, node_name: str | None = None) -> FaultPlan:
    """Parse a TOML plan (see module docstring for the format)."""
    try:
        import tomllib
    except ModuleNotFoundError:  # Python < 3.11
        import tomli as tomllib

    data = tomllib.loads(text)
    seed = int(data.get("seed", 0))
    rules = []
    for raw in data.get("rule", []):
        rules.append(FaultRule(
            point=raw["point"],
            action=raw["action"],
            p=float(raw.get("p", 1.0)),
            delay_s=float(raw.get("delay_s", 0.0)),
            after=int(raw.get("after", 0)),
            max_fires=int(raw.get("max_fires", 0)),
            node=raw.get("node"),
        ))
    partitions = []
    for raw in data.get("partition", []):
        partitions.append(PartitionSpec(
            kind=raw["kind"],
            a=tuple(raw.get("a", ())),
            b=tuple(raw.get("b", ())),
            after=int(raw.get("after", 0)),
            duration=int(raw.get("duration", 0)),
            period=int(raw.get("period", 0)),
        ))
    return FaultPlan(seed, rules, node_name=node_name, partitions=partitions)


def arm_from_env(node_name: str | None = None) -> FaultPlan | None:
    """Arm from ``$CORDA_TPU_FAULT_PLAN`` (a TOML path) if set: called at
    a process's start, so child processes pick up a harness's plan without
    config changes."""
    path = os.environ.get(PLAN_ENV)
    if not path:
        return None
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return arm(plan_from_toml(text, node_name=node_name))


def builtin_plan(name: str, node_name: str | None = None) -> FaultPlan:
    """Named plans for the chaos loadtest / bench (``lossy``, ``slow-disk``,
    ``flaky-device``, ``reshard``, ``bitrot``, and the partition family
    ``split-brain`` / ``asym`` / ``flap`` — also reachable as
    ``partition.<name>`` for CLI pass-through)."""
    if name.startswith("partition."):
        name = name[len("partition."):]
    if name == "split-brain":
        # Symmetric split-brain with the familiar lossy rule riding along
        # (partitions and probabilistic rules compose in one plan): the
        # cut arms after 200 offered frames, holds for 2500, then heals —
        # the majority side must keep committing, the minority none.
        return FaultPlan(29, [
            FaultRule("transport.send", "drop", p=0.02, max_fires=200),
        ], node_name=node_name, partitions=[
            PartitionSpec("split", after=200, duration=2500),
        ])
    if name == "asym":
        # One-way cut: the first bound node can still HEAR the cluster
        # but nothing it sends gets out — the half-open link that makes
        # naive elections churn.
        return FaultPlan(31, [], node_name=node_name, partitions=[
            PartitionSpec("asym", after=200, duration=2000),
        ])
    if name == "flap":
        # Flapping split with a seeded half-cycle: the cut toggles every
        # `period` frames for 4000 frames — the rejoin-storm shape that
        # pre-vote exists to keep from inflating terms.
        return FaultPlan(37, [], node_name=node_name, partitions=[
            PartitionSpec("flap", after=200, duration=4000),
        ])
    if name == "lossy":
        # ~5% send-side loss; durable outbox re-poll recovers each loss
        # within ~1s, so the run completes with elevated tail latency.
        return FaultPlan(7, [
            FaultRule("transport.send", "drop", p=0.05, max_fires=500),
        ], node_name=node_name)
    if name == "reshard":
        # The reshard-under-fire plan: lossy transport THROUGH the
        # transition plus handoff-frame loss and one stale-directory
        # window, so the exactly-once audit exercises resubmitted install
        # frames and WrongShardEpoch bounces, not just the happy path.
        return FaultPlan(17, [
            FaultRule("transport.send", "drop", p=0.05, max_fires=500),
            FaultRule("shard.handoff", "drop", p=0.25, max_fires=8),
            FaultRule("netmap.refresh", "drop", p=0.10, max_fires=20),
        ], node_name=node_name)
    if name == "bitrot":
        # Storage-corruption soak (durability plane, round 14): seeded
        # bit-flips on the raft-log read path plus two bounded disk-full
        # write failures. Detection (crc mismatch) turns each flip into a
        # truncate-and-lag repair; the exactly-once audit must still hold.
        return FaultPlan(23, [
            FaultRule("disk.corrupt", "flip", p=0.02, max_fires=6),
            FaultRule("disk.full", "full", p=0.05, after=40, max_fires=2),
        ], node_name=node_name)
    if name == "slow-disk":
        return FaultPlan(11, [
            FaultRule("raft.fsync", "stall", p=0.10, delay_s=0.05,
                      max_fires=200),
        ], node_name=node_name)
    if name == "flaky-device":
        return FaultPlan(13, [
            FaultRule("verify.device", "fail", p=1.0, max_fires=1),
        ], node_name=node_name)
    raise ValueError(f"unknown builtin fault plan {name!r}")
