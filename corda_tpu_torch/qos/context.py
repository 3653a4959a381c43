"""QosContext — the request-class + deadline plane, propagated like trace
context.

The port's own copy of ``corda_tpu/qos/context.py``.

The QoS plane mirrors the obs/trace arming pattern exactly, and for the
same reason: one module-level ``ACTIVE`` object guarded by a single
attribute check at every instrumentation point. Disarmed (``ACTIVE is
None``, the default) every touch point short-circuits before building
anything — no context objects, no extra wire fields, no scheduling
deviation — which is what makes the ``qos = false`` config path
bit-identical to the pre-QoS tree.

Armed, a :class:`QosContext` travels with a flow exactly the way trace
context does:

  * stamped onto the FlowStateMachine at ``add()`` (flow start),
  * pushed into a thread-local around ``step()`` / service polls,
  * picked up by both transports at ``send()`` and carried on the wire
    (in-memory: the object rides the Message; TCP: one 17-byte
    ``<BQQ`` field appended to the frame tuple),
  * joined by the responder's FSM at SessionInit,
  * linked to Raft ``request_id``s through the plane's bounded link map so
    batch formation can see the deadline of each buffered command.

Deadlines are EPOCH nanoseconds (``time.time_ns``) so they remain
meaningful across process boundaries (client node -> notary node ->
sidecar), same rationale as the epoch stamps in obs spans. Deadline
*evaluation* lives here — ``QosPlane.near_deadline`` — so consensus
modules never read a clock themselves: the scheduling decision ("seal this
batch early") is leader/coordinator-side and never taken inside an apply
path, preserving the determinism contract.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from dataclasses import dataclass

__all__ = [
    "ACTIVE",
    "ENV_VAR",
    "LANES",
    "LANE_BULK",
    "LANE_INTERACTIVE",
    "QosContext",
    "QosPlane",
    "arm",
    "arm_from_env",
    "clear_context",
    "disarm",
    "get_context",
    "lane_code",
    "now_ns",
    "set_context",
]

LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"
LANES = (LANE_INTERACTIVE, LANE_BULK)

_LANE_CODES = {LANE_INTERACTIVE: 0, LANE_BULK: 1}
_LANE_NAMES = {code: name for name, code in _LANE_CODES.items()}

ENV_VAR = "CORDA_TPU_QOS"

# One wire field: lane code (u8), deadline_ns (u64), admitted_ns (u64).
_WIRE = struct.Struct("<BQQ")
WIRE_SIZE = _WIRE.size

# Bounded request_id -> QosContext map (same sizing discipline as the obs
# link map: a leaked link must never grow without bound, so the map clears
# wholesale when full — losing priority attribution for in-flight requests
# is strictly better than losing the process).
LINK_MAP_MAX = 16384


def now_ns() -> int:
    """Epoch nanoseconds — the QoS deadline clock (cross-process)."""
    return time.time_ns()


def lane_code(lane: str) -> int:
    return _LANE_CODES.get(lane, 0)


@dataclass(frozen=True)
class QosContext:
    """One request's class and latency contract.

    ``deadline_ns`` / ``admitted_ns`` are epoch nanoseconds; 0 means "no
    deadline" / "not stamped". An unlabelled request (no context at all)
    schedules exactly like interactive — the plane deprioritizes only what
    is explicitly marked bulk, so arming QoS over unlabelled traffic
    changes nothing.
    """

    lane: str = LANE_INTERACTIVE
    deadline_ns: int = 0
    admitted_ns: int = 0

    def to_wire(self) -> bytes:
        return _WIRE.pack(_LANE_CODES.get(self.lane, 0),
                          self.deadline_ns & 0xFFFFFFFFFFFFFFFF,
                          self.admitted_ns & 0xFFFFFFFFFFFFFFFF)

    @staticmethod
    def from_wire(raw) -> "QosContext | None":
        """Decode one wire field; None (never an exception) on junk —
        transports drop malformed frames, they do not crash readers."""
        if not isinstance(raw, (bytes, bytearray)) or len(raw) != WIRE_SIZE:
            return None
        code, deadline_ns, admitted_ns = _WIRE.unpack(bytes(raw))
        lane = _LANE_NAMES.get(code)
        if lane is None:
            return None
        return QosContext(lane, deadline_ns, admitted_ns)


class QosPlane:
    """The armed QoS plane: scheduler parameters + counters + the bounded
    request_id link map. One instance per process (module ``ACTIVE``)."""

    def __init__(self, node_name: str = "", slo_ms: float = 50.0,
                 deadline_guard_ms: float = 5.0, bulk_every: int = 4):
        self.node_name = node_name
        self.slo_ms = float(slo_ms)
        self.deadline_guard_ns = int(float(deadline_guard_ms) * 1e6)
        # Anti-starvation ratio: when both classes are runnable, every
        # bulk_every'th pick takes the oldest bulk step.
        self.bulk_every = max(2, int(bulk_every))
        self._links: dict[bytes, QosContext] = {}
        self._links_lock = threading.Lock()
        self.counters = {
            "interactive_flows": 0,
            "bulk_flows": 0,
            "bulk_antistarvation_picks": 0,
            "verify_early_flushes": 0,
            "links_dropped": 0,
        }

    # -- deadline evaluation (the one place QoS reads a clock) -------------

    def near_deadline(self, ctx: QosContext | None) -> bool:
        """True when ``ctx`` is an interactive request whose deadline is
        within the guard window — the signal every queueing point uses to
        stop coalescing and flush."""
        return (ctx is not None
                and ctx.lane == LANE_INTERACTIVE
                and ctx.deadline_ns > 0
                and time.time_ns() + self.deadline_guard_ns
                >= ctx.deadline_ns)

    def deadline_near_ns(self, deadline_ns: int) -> bool:
        """Same check for call sites that track only the minimum
        interactive deadline (SMM verify micro-batch)."""
        return (deadline_ns > 0
                and time.time_ns() + self.deadline_guard_ns >= deadline_ns)

    def new_context(self, lane: str, slo_ms: float | None = None,
                    admitted_ns: int | None = None) -> QosContext:
        """Entry-point constructor: stamp admitted-at now and derive the
        deadline from the lane's SLO (interactive only — bulk carries no
        deadline; it is the sheddable class)."""
        t = now_ns() if admitted_ns is None else admitted_ns
        if lane == LANE_INTERACTIVE:
            ms = self.slo_ms if slo_ms is None else float(slo_ms)
            deadline = t + int(ms * 1e6) if ms > 0 else 0
        else:
            deadline = 0
        return QosContext(lane, deadline, t)

    # -- request_id links (Raft/shard commit attribution) ------------------

    def register_link(self, request_id: bytes, ctx: QosContext) -> None:
        with self._links_lock:
            if len(self._links) >= LINK_MAP_MAX:
                self.counters["links_dropped"] += len(self._links)
                self._links.clear()
            self._links[request_id] = ctx

    def pop_link(self, request_id: bytes) -> QosContext | None:
        with self._links_lock:
            return self._links.pop(request_id, None)

    def peek_link(self, request_id: bytes) -> QosContext | None:
        return self._links.get(request_id)

    # -- stamping ----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "slo_ms": self.slo_ms,
            "deadline_guard_ms": self.deadline_guard_ns / 1e6,
            "bulk_every": self.bulk_every,
            "links": len(self._links),
            **self.counters,
        }


# ---------------------------------------------------------------------------
# Module state: the armed plane + per-thread current context
# ---------------------------------------------------------------------------

ACTIVE: QosPlane | None = None

_ctx = threading.local()


def set_context(ctx: QosContext | None) -> None:
    _ctx.current = ctx


def get_context() -> QosContext | None:
    return getattr(_ctx, "current", None)


def clear_context() -> None:
    _ctx.current = None


def arm(node_name: str = "", slo_ms: float = 50.0,
        deadline_guard_ms: float = 5.0, bulk_every: int = 4) -> QosPlane:
    global ACTIVE
    ACTIVE = QosPlane(node_name, slo_ms=slo_ms,
                      deadline_guard_ms=deadline_guard_ms,
                      bulk_every=bulk_every)
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None
    clear_context()


def arm_from_env(node_name: str = "") -> QosPlane | None:
    """Arm from ``CORDA_TPU_QOS``: unset/empty/"0"/"off" stays disarmed;
    "1"/"on" arms with defaults; otherwise a comma-separated k=v list
    (``slo_ms=50,guard_ms=5,bulk_every=4``). Process-wide, like the obs
    arming — harness-spawned nodes arm from their [qos] config instead."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw or raw.lower() in ("0", "off", "false"):
        return None
    kwargs: dict[str, float] = {}
    if raw.lower() not in ("1", "on", "true"):
        for part in raw.split(","):
            if "=" not in part:
                continue
            key, _, value = part.partition("=")
            try:
                val = float(value)
            except ValueError:
                continue
            key = key.strip()
            if key in ("slo_ms", "deadline_guard_ms", "bulk_every"):
                kwargs[key] = val
            elif key == "guard_ms":
                kwargs["deadline_guard_ms"] = val
    if "bulk_every" in kwargs:
        kwargs["bulk_every"] = int(kwargs["bulk_every"])
    return arm(node_name, **kwargs)
