"""Per-node span recording + trace-context propagation (Dapper-style).

The port's own copy of ``corda_tpu/obs/trace.py``; the port's verify pump
(crypto/async_verify.py) records its queue_wait / device_verify /
sidecar_wait / sidecar_verify batch spans here. Beyond the reference, the
``VERIFY`` recorder is always present: while the torch profiler collects,
the device verify provider (crypto/provider.py) records each device
batch's provider_* spans into it, armed or not.

Arming mirrors testing/faults.py exactly: a module-level ``ACTIVE`` recorder
that every instrumentation point guards with ``if _obs.ACTIVE is not None:``
— the disarmed cost of the whole subsystem is that one attribute check, and
tests assert it (tests/test_obs_trace.py overhead guard).

Span model
----------
A span is ``(trace_id, span_id, parent, name, node, t_start, t_end, attrs)``.
ids are 8 random bytes; timestamps are epoch ``time.time()`` seconds so spans
recorded in different OS processes merge onto one harness-side timeline without
clock translation (perf_counter would be per-process). ``attrs`` is a small
dict; batch-level spans (device verify, raft append/fsync/replication) carry
``attrs["member_traces"]`` — the hex trace ids of every transaction that rode
the batch — which is how fan-in stages attribute back to individual traces.

The recorder is a fixed-capacity ring: when full it overwrites the oldest
span and counts the drop. Appends take no lock — the node is single-threaded
except for the verify feeder, and list.append / index assignment are atomic
under the GIL; ``snapshot()`` copies before reading.

Context propagation
-------------------
The current (trace_id, span_id) rides a thread-local, set by the state
machine around each flow step / service poll, read by the transports when
stamping outbound messages. Cross-process it rides two extra fields on the
TCP wire frame; in-process it rides ``Message.trace``. The request-id link
map lets RaftMember (which sees only PutAllCommand.request_id at batch-seal
time) recover the submitting flow's trace without plumbing trace arguments
through the consensus API.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "ACTIVE",
    "VERIFY",
    "Span",
    "SpanRecorder",
    "arm",
    "disarm",
    "arm_from_env",
    "new_trace_id",
    "new_span_id",
    "set_context",
    "get_context",
    "clear_context",
    "record",
    "register_link",
    "pop_link",
]

ENV_VAR = "CORDA_TPU_TRACE"
DEFAULT_CAPACITY = 65536
LINK_MAP_MAX = 16384

# THE switch. Hot paths guard every tracing touch with
# `if _obs.ACTIVE is not None:` — disarmed cost is this one attribute check.
ACTIVE: "SpanRecorder | None" = None


def new_trace_id() -> bytes:
    return os.urandom(8)


def new_span_id() -> bytes:
    return os.urandom(8)


class Span:
    """One timed operation. Slotted: a loaded node records tens of
    thousands of these per second when armed."""

    __slots__ = ("trace_id", "span_id", "parent", "name", "node",
                 "t_start", "t_end", "attrs")

    def __init__(self, trace_id, span_id, parent, name, node,
                 t_start, t_end, attrs=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent = parent
        self.name = name
        self.node = node
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = attrs

    def as_dict(self) -> dict:
        """JSON-safe form (ids hex-encoded) for /api/trace + RPC export."""
        return {
            "trace_id": self.trace_id.hex(),
            "span_id": self.span_id.hex(),
            "parent": self.parent.hex() if self.parent else None,
            "name": self.name,
            "node": self.node,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "attrs": self.attrs or {},
        }


class SpanRecorder:
    """Fixed-size ring of spans for one node (or one in-process network —
    MockNetwork nodes share the process-global recorder and distinguish
    themselves via the per-span ``node`` field)."""

    def __init__(self, node_name: str = "", capacity: int = DEFAULT_CAPACITY):
        self.node_name = node_name
        self.capacity = max(1, int(capacity))
        self._ring: list = []
        self._next = 0          # overwrite cursor once the ring is full
        self.dropped = 0        # spans that overwrote an unread slot
        self.recorded = 0
        # request_id -> (trace_id, span_id): the flow→raft correlation map.
        self._links: dict[bytes, tuple] = {}

    # -- recording ---------------------------------------------------------

    def record(self, name: str, t_start: float, t_end: float, *,
               trace_id: bytes | None = None, span_id: bytes | None = None,
               parent: bytes | None = None, node: str | None = None,
               attrs: dict | None = None) -> Span:
        span = Span(
            trace_id if trace_id is not None else new_trace_id(),
            span_id if span_id is not None else new_span_id(),
            parent, name,
            node if node is not None else self.node_name,
            t_start, t_end, attrs,
        )
        ring = self._ring
        if len(ring) < self.capacity:
            ring.append(span)
        else:
            cursor = self._next
            ring[cursor] = span
            self._next = (cursor + 1) % self.capacity
            self.dropped += 1
        self.recorded += 1
        return span

    # -- raft correlation --------------------------------------------------

    def register_link(self, request_id: bytes, trace_id: bytes,
                      span_id: bytes) -> None:
        """Remember which flow trace submitted `request_id` so the raft
        batch seal can stamp member_traces without API plumbing. Bounded:
        a wedged consensus round must not grow this forever."""
        links = self._links
        if len(links) >= LINK_MAP_MAX:
            links.clear()  # rare; losing correlation beats losing memory
        links[request_id] = (trace_id, span_id)

    def pop_link(self, request_id: bytes):
        return self._links.pop(request_id, None)

    def peek_link(self, request_id: bytes):
        return self._links.get(request_id)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """JSON-safe copy of every buffered span (oldest-first)."""
        ring = list(self._ring)
        if len(ring) == self.capacity and self._next:
            ring = ring[self._next:] + ring[:self._next]
        return [s.as_dict() for s in ring]

    def stats(self) -> dict:
        return {
            "recorded": self.recorded,
            "buffered": len(self._ring),
            "dropped": self.dropped,
            "capacity": self.capacity,
            "links": len(self._links),
        }

    def clear(self) -> None:
        self._ring.clear()
        self._next = 0
        self._links.clear()


# The device verify provider's spans (obs/stages.py PROVIDER_SPANS): four a
# batch that takes the device while the torch profiler collects, one trace
# id a batch. Never armed or disarmed, so that a caller that can only start
# a profiler (a benchmark run) still finds them; at four spans a batch the
# ring holds the newest 16,384 batches.
VERIFY = SpanRecorder("", DEFAULT_CAPACITY)


# ---------------------------------------------------------------------------
# Module-level conveniences over ACTIVE (callers still guard on ACTIVE first)
# ---------------------------------------------------------------------------


def record(name: str, t_start: float, t_end: float, **kw) -> "Span | None":
    rec = ACTIVE
    if rec is None:
        return None
    return rec.record(name, t_start, t_end, **kw)


def register_link(request_id: bytes, trace_id: bytes, span_id: bytes) -> None:
    rec = ACTIVE
    if rec is not None:
        rec.register_link(request_id, trace_id, span_id)


def pop_link(request_id: bytes):
    rec = ACTIVE
    if rec is None:
        return None
    return rec.pop_link(request_id)


# ---------------------------------------------------------------------------
# Current-context: which (trace_id, span_id) is executing on this thread
# ---------------------------------------------------------------------------

_ctx = threading.local()


def set_context(trace_id: bytes, span_id: bytes) -> None:
    _ctx.current = (trace_id, span_id)


def get_context() -> "tuple | None":
    return getattr(_ctx, "current", None)


def clear_context() -> None:
    _ctx.current = None


# ---------------------------------------------------------------------------
# Arming (mirrors faults.arm / disarm / arm_from_env)
# ---------------------------------------------------------------------------


def arm(node_name: str = "", capacity: int = DEFAULT_CAPACITY) -> SpanRecorder:
    global ACTIVE
    recorder = SpanRecorder(node_name, capacity)
    ACTIVE = recorder
    return recorder


def disarm() -> None:
    global ACTIVE
    ACTIVE = None
    clear_context()


def arm_from_env(node_name: str = "") -> "SpanRecorder | None":
    """Arm tracing in a freshly exec'd node process when CORDA_TPU_TRACE is
    set (the cluster harness's --trace vector; called from node.main() next to
    faults.arm_from_env). Value is "1"/"on" for the default buffer or an
    integer span capacity."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    raw = raw.strip().lower()
    capacity = DEFAULT_CAPACITY
    if raw not in ("1", "on", "true", "yes"):
        try:
            capacity = int(raw)
        except ValueError:
            return None
    return arm(node_name, capacity)


def now() -> float:
    """Epoch seconds — the one clock every span uses so multi-process
    snapshots merge without skew handling beyond NTP's."""
    return time.time()
