"""Deterministic fault injection.

The port's own copy of the rule engine of ``corda_tpu/testing/faults.py``:
the same points, rules, seeded schedules and TOML rule format, and the same
``PLAN_ENV`` name, so one plan file arms both packages' processes. In this
package the verify pump's feeder fires ``verify.device``
(crypto/async_verify.py), with the actions fail, slow and crash. The
reference's partition schedules and its fsync / disk-corrupt / disk-full
hooks belong to the notary pipeline's transport and storage, which this
package does not have yet; a plan that declares a partition is refused.

A process arms at most one :class:`FaultPlan`. A hook consults the
module-level ``ACTIVE`` plan; when no plan is armed it is a single
attribute check (``faults.ACTIVE is not None``).

Determinism: every rule owns a ``random.Random`` seeded from
``(plan seed, point, rule index)``, and probability draws consume that
stream one draw per *event at that point*.  Two plans built from the same
seed and rule list therefore produce the same fault schedule regardless
of how events at different points interleave.

TOML plan format (see ``plan_from_toml``)::

    seed = 7

    [[rule]]
    point = "verify.device"
    action = "fail"
    p = 0.05           # fire probability per event (default 1.0)
    delay_s = 0.0      # slow duration
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
from dataclasses import dataclass, field

__all__ = [
    "POINTS",
    "FaultRule",
    "FaultPlan",
    "ACTIVE",
    "arm",
    "disarm",
    "injected",
    "fire",
    "plan_from_toml",
    "arm_from_env",
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


class FaultPlan:
    """A seeded set of fault rules, armed process-wide via :func:`arm`.

    ``node_name`` filters rules with a ``node=`` restriction at
    construction time; filtering never perturbs the per-rule RNG streams
    because each rule is seeded from its index in the *original* rule
    list.
    """

    def __init__(self, seed: int, rules: list[FaultRule],
                 node_name: str | None = None):
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
    if data.get("partition"):
        raise ValueError("partition schedules need the notary pipeline's "
                         "transport, which this package does not have")
    return FaultPlan(seed, rules, node_name=node_name)


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
