"""The state machine manager: flow scheduling, sessions, checkpoints, and the
micro-batched verification seam.

Capability match for the reference's StateMachineManager +
FlowStateMachineImpl (reference: node/src/main/kotlin/net/corda/node/services/
statemachine/StateMachineManager.kt, FlowStateMachineImpl.kt):

  * session wire protocol SessionInit/Confirm/Reject/Data/End exactly as the
    reference defines it (StateMachineManager.kt:443-482), carried on topic
    "platform.session" with the recipient's session id as the message session
    (StateMachineManager.kt:209-217);
  * flow-factory registration for service-initiated flows
    (onSessionInit, StateMachineManager.kt:257-286);
  * checkpoint on every suspension (updateCheckpoint,
    StateMachineManager.kt:399-408) — but instead of Kryo-serializing a fiber
    stack the checkpoint records (flow name, constructor args, ordered results
    of completed suspensions, session states); restore re-runs the flow
    generator and replays the recorded results (deterministic replay — the
    explicit-state-machine design SURVEY.md §7 stage 3 calls for);
  * restore-on-start (restoreFibersFromCheckpoints,
    StateMachineManager.kt:190-226).

The batched-verify addition — the *verification pump*: flows suspend on
VerifyTxRequest and the manager aggregates every pending request across all
concurrent flows into ONE batched signature-verification call (the seam the
reference lacks: its per-tx loop at SignedTransaction.kt:83-87 becomes a
cross-transaction batch sized by concurrency). Single-threaded cooperative
scheduling makes this deterministic: flows run until all are parked, then
the batch flushes.

The port's own copy of ``corda_tpu/node/statemachine.py``. The verifier
defaults to ``crypto.provider.get_verifier()``, the port's
``TorchVerifier("cuda")``: each flushed micro-batch at or above the size
crossover runs the SHA-512 challenge kernel and the verify kernel on the
card. Two changes from the reference: ``reprobe_cooldown_s`` is a
constructor argument (the port's ``degrade_device`` takes its cooldown
explicitly; the default is the reference's 5 s), and a raised device
verify on a verifier whose device tier is this package's CUDA kernels
(``kernel_backend == "cuda"``) is never re-run on the host: it reaches the
waiting flows as an error, as a raised synchronous flush does. Degrade and
re-verify stays for the other device-backed verifiers (the sidecar client,
whose device tier is another process; ``TorchVerifier("cpu")``).
"""

from __future__ import annotations

import hashlib
import inspect as _inspect
import logging
import os
import time as _time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

from ..crypto.hashes import SecureHash
from ..crypto.keys import SignatureError
from ..crypto.party import Party
from ..crypto.provider import BatchVerifier, VerifyJob, get_verifier
from ..flows.api import (
    FlowException,
    FlowLogic,
    FlowSessionException,
    ReceiveRequest,
    SendAndReceiveRequest,
    SendRequest,
    ServiceRequest,
    UntrustworthyData,
    VerifySigRequest,
    VerifyTxRequest,
    flow_registry,
)
from ..obs import telemetry as _tm
from ..obs import trace as _obs
from ..qos import context as _qos
from ..serialization.codec import (
    DeserializationError,
    deserialize,
    register,
    serialize,
)
from ..serialization.tokens import TokenContext
from ..testing import faults as _faults
from ..utils.excheckpoint import record_exception, rebuild_exception
from .messaging.api import DEFAULT_SESSION_ID, Message, MessagingService, TopicSession

logger = logging.getLogger(__name__)

SESSION_TOPIC = "platform.session"


# ---------------------------------------------------------------------------
# Session wire messages (reference: StateMachineManager.kt:443-482)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class SessionInit:
    initiator_session_id: int
    flow_name: str
    initiator_party: Party
    first_payload: Any = None


@register
@dataclass(frozen=True)
class SessionConfirm:
    initiator_session_id: int
    initiated_session_id: int


@register
@dataclass(frozen=True)
class SessionReject:
    initiator_session_id: int
    error_message: str


@register
@dataclass(frozen=True)
class SessionData:
    recipient_session_id: int
    payload: Any


@register
@dataclass(frozen=True)
class SessionEnd:
    recipient_session_id: int


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class SessionCheckpoint:
    """Serializable session state."""

    party: Party
    local_id: int
    peer_id: int | None
    state: str  # initiating | open | ended
    receive_buffer: tuple = ()
    outgoing_buffer: tuple = ()
    send_count: int = 0
    scope: str = ""


@register
@dataclass(frozen=True)
class Checkpoint:
    """One flow's durable state (reference: node/.../services/api/
    CheckpointStorage.kt:33 — here replay state instead of a fiber blob)."""

    run_id: bytes
    flow_name: str
    flow_args: tuple
    resolved: tuple = ()  # ('v', value) | ('e', exc_type_name, message)
    sessions: tuple = ()  # SessionCheckpoint...
    next_session_seq: int = 0

    @property
    def id(self) -> SecureHash:
        return SecureHash.sha256(serialize(self).bytes)


class CheckpointStorage:
    """Interface over serialized checkpoint blobs (reference:
    CheckpointStorage.kt:10-30). Blobs, not objects: serialization happens on
    every suspend (as in the reference), so unserializable flow state fails
    fast, and service references pass through the token context."""

    def update_checkpoint(self, run_id: bytes, blob: bytes) -> None:
        raise NotImplementedError

    def remove_checkpoint(self, run_id: bytes) -> None:
        raise NotImplementedError

    def checkpoints(self) -> list[bytes]:
        raise NotImplementedError


class InMemoryCheckpointStorage(CheckpointStorage):
    def __init__(self):
        self._by_run: dict[bytes, bytes] = {}

    def update_checkpoint(self, run_id: bytes, blob: bytes) -> None:
        self._by_run[run_id] = blob

    def remove_checkpoint(self, run_id: bytes) -> None:
        self._by_run.pop(run_id, None)

    def checkpoints(self) -> list[bytes]:
        return list(self._by_run.values())

    def __len__(self):
        return len(self._by_run)


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------


class EventLog:
    """Bounded append-only event feed with ABSOLUTE cursors: old events are
    evicted but cursor arithmetic stays valid, so RPC pollers
    (state_machine_changes) never index a shifted list. Events are tuples —
    ('add'|'remove', run_id) or ('progress', run_id, path)."""

    def __init__(self, keep: int = 10_000):
        self._keep = keep
        self.base = 0  # absolute index of _events[0]
        self._events: list[tuple] = []

    def append(self, event: tuple) -> None:
        self._events.append(event)
        overflow = len(self._events) - self._keep
        if overflow > 0:
            del self._events[:overflow]
            self.base += overflow

    def since(self, cursor: int) -> tuple[int, tuple]:
        """(new_cursor, events at absolute index >= cursor)."""
        start = max(cursor - self.base, 0)
        return (self.base + len(self._events), tuple(self._events[start:]))

    # list-compat conveniences (tests introspect the feed directly)
    def __len__(self):
        return self.base + len(self._events)

    def __iter__(self):
        return iter(self._events)

    def __getitem__(self, item):
        return self._events[item]


class FlowFuture:
    """Synchronous future resolved by the manager's pump."""

    def __init__(self):
        self._done = False
        self._result = None
        self._exception: BaseException | None = None
        self._callbacks: list[Callable] = []

    def set_result(self, value) -> None:
        self._done, self._result = True, value
        for cb in self._callbacks:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        self._done, self._exception = True, exc
        for cb in self._callbacks:
            cb(self)

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            raise RuntimeError("flow not finished — pump the network first")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self) -> BaseException | None:
        return self._exception

    def add_done_callback(self, cb: Callable) -> None:
        if self._done:
            cb(self)
        else:
            self._callbacks.append(cb)


@dataclass
class FlowHandle:
    run_id: bytes
    result: FlowFuture
    logic: FlowLogic


# ---------------------------------------------------------------------------
# Sessions (runtime form)
# ---------------------------------------------------------------------------


@dataclass
class FlowSession:
    party: Party
    local_id: int
    peer_id: int | None = None
    state: str = "initiating"
    receive_buffer: list = field(default_factory=list)
    outgoing_buffer: list = field(default_factory=list)  # payloads pre-confirm
    send_count: int = 0
    scope: str = ""

    @property
    def key(self) -> str:
        return f"{self.scope}|{self.party.name}"

    def to_checkpoint(self) -> SessionCheckpoint:
        return SessionCheckpoint(
            party=self.party,
            local_id=self.local_id,
            peer_id=self.peer_id,
            state=self.state,
            receive_buffer=tuple(self.receive_buffer),
            outgoing_buffer=tuple(self.outgoing_buffer),
            send_count=self.send_count,
            scope=self.scope,
        )

    @staticmethod
    def from_checkpoint(sc: SessionCheckpoint) -> "FlowSession":
        return FlowSession(
            party=sc.party,
            local_id=sc.local_id,
            peer_id=sc.peer_id,
            state=sc.state,
            receive_buffer=list(sc.receive_buffer),
            outgoing_buffer=list(sc.outgoing_buffer),
            send_count=sc.send_count,
            scope=sc.scope,
        )


# ---------------------------------------------------------------------------
# The per-flow state machine
# ---------------------------------------------------------------------------

_RUNNABLE = "runnable"
_WAIT_RECEIVE = "wait_receive"
_WAIT_VERIFY = "wait_verify"
_WAIT_SERVICE = "wait_service"
_DONE = "done"


class FlowStateMachine:
    """Drives one FlowLogic generator; owns its sessions and replay log."""

    def __init__(
        self,
        manager: "StateMachineManager",
        logic: FlowLogic,
        run_id: bytes,
        resolved: list | None = None,
        sessions: dict[str, FlowSession] | None = None,
        next_session_seq: int = 0,
    ):
        self.manager = manager
        self.logic = logic
        self.run_id = run_id
        self.resolved: list = resolved or []  # completed suspension results
        self.sessions: dict[str, FlowSession] = sessions or {}  # by scope|party
        self.next_session_seq = next_session_seq
        self._subflow_counter = 0
        self.future = FlowFuture()
        self.state = _RUNNABLE
        self.waiting_on: ReceiveRequest | None = None
        self.pending_value = None  # (kind, value) to feed into generator
        self._gen = None
        self._replay_cursor = 0
        self.created_at = _time.monotonic()  # per-flow timing
        # Tracing context (obs/trace.py). All None while disarmed; set by the
        # manager at creation when obs.ACTIVE is armed. trace_parent is the
        # initiating peer's span id for session-initiated flows.
        self.trace_id: bytes | None = None
        self.trace_span: bytes | None = None
        self.trace_parent: bytes | None = None
        self.trace_t0: float = 0.0  # epoch seconds (cross-process merge)
        # QoS context (qos/context.py): None while the plane is disarmed or
        # the flow is unlabelled; set at add() or joined at SessionInit.
        self.qos = None
        logic.state_machine = self
        logic.service_hub = manager.service_hub

    # -- session helpers ---------------------------------------------------

    def _session_id(self, seq: int) -> int:
        digest = hashlib.sha256(self.run_id + seq.to_bytes(4, "big")).digest()
        return int.from_bytes(digest[:8], "big") >> 1  # positive int64

    def allocate_subflow_scope(self) -> str:
        """Deterministic scope names for sub-flow sessions; replay re-derives
        the same values because sub_flow calls re-execute in order."""
        self._subflow_counter += 1
        return str(self._subflow_counter)

    def get_or_open_session(
        self, party: Party, scope: str = "", flow_name: str = "", first_payload=None
    ) -> FlowSession:
        key = f"{scope}|{party.name}"
        session = self.sessions.get(key)
        if session is not None:
            return session
        local_id = self._session_id(self.next_session_seq)
        self.next_session_seq += 1
        session = FlowSession(party=party, local_id=local_id, scope=scope)
        self.sessions[key] = session
        self.manager._register_session(self, session)
        if not self.replaying:
            self.manager._send_session_message(
                party,
                DEFAULT_SESSION_ID,
                SessionInit(
                    initiator_session_id=local_id,
                    flow_name=flow_name
                    or type(self.logic).flow_name
                    or type(self.logic).__qualname__,
                    initiator_party=self.manager.our_identity,
                    first_payload=first_payload,
                ),
            )
            if first_payload is not None:
                session.send_count += 1
        return session

    def open_initiated_session(self, party: Party, local_id: int, peer_id: int) -> FlowSession:
        session = FlowSession(party=party, local_id=local_id, peer_id=peer_id, state="open")
        self.sessions[session.key] = session
        self.manager._register_session(self, session)
        return session

    def _send_on_session(self, request) -> None:
        key = f"{request.scope}|{request.party.name}"
        session = self.sessions.get(key)
        if session is None:
            self.get_or_open_session(
                request.party, request.scope, request.flow_name,
                first_payload=request.payload,
            )
            return
        if self.replaying:
            return  # effect already happened before the checkpoint
        if session.state == "initiating":
            session.outgoing_buffer.append(request.payload)
        elif session.state == "open":
            self.manager._send_session_message(
                request.party,
                session.peer_id,
                SessionData(session.peer_id, request.payload),
            )
            session.send_count += 1
        else:
            raise FlowSessionException(f"session with {request.party} has ended")

    # -- replay ------------------------------------------------------------

    @property
    def replaying(self) -> bool:
        return self._replay_cursor < len(self.resolved)

    def _record(self, kind: str, value=None, err: BaseException | None = None):
        """Append a suspension result; returns the entry so callers feed the
        generator the SAME tuple live as replay will (payloads included —
        typed exceptions must rebuild identically on both paths)."""
        if kind == "v":
            entry = ("v", value)
        else:
            entry = record_exception(err)
        self.resolved.append(entry)
        self._replay_cursor = len(self.resolved)
        return entry

    def _next_feed(self):
        """What to send into the generator for the current step."""
        if self._replay_cursor < len(self.resolved):
            entry = self.resolved[self._replay_cursor]
            self._replay_cursor += 1
            return entry
        pv, self.pending_value = self.pending_value, None
        return pv

    # -- stepping ----------------------------------------------------------

    def step(self) -> None:
        """Advance the generator until it parks or finishes. Called only by
        the manager's pump (single-threaded)."""
        if self.state == _DONE:
            return
        qos_armed = _qos.ACTIVE is not None and self.qos is not None
        if qos_armed:
            # Session sends and service submissions this step makes carry
            # the flow's lane + deadline, exactly like trace context.
            _qos.set_context(self.qos)
        try:
            if _obs.ACTIVE is not None and self.trace_id is not None:
                # Everything this flow does while stepping — session sends,
                # service submissions — inherits its trace context.
                _obs.set_context(self.trace_id, self.trace_span)
                try:
                    self._step_inner()
                finally:
                    _obs.clear_context()
            else:
                self._step_inner()
        finally:
            if qos_armed:
                _qos.clear_context()

    def _step_inner(self) -> None:
        try:
            if self._gen is None:
                out = self.logic.call()
                if not _inspect.isgenerator(out):
                    self._finish(out)
                    return
                self._gen = out
                feed = None
            else:
                feed = self._next_feed()

            while True:
                if feed is None:
                    request = next(self._gen)
                elif feed[0] == "v":
                    request = self._gen.send(feed[1])
                else:
                    request = self._gen.throw(_rebuild_exception(feed))

                feed = self._handle_request(request)
                if feed is _PARKED:
                    return
        except StopIteration as stop:
            self._finish(stop.value)
        except BaseException as e:  # flow failed
            self._fail(e)

    def _handle_request(self, request):
        """Execute or park on a yielded request. Returns the next feed tuple,
        or _PARKED if the flow must suspend."""
        if isinstance(request, SendRequest):
            if self.replaying:
                self._send_on_session(request)  # suppressed
                return self._consume_replay_entry()
            self._send_on_session(request)
            self._record("v", None)
            self.manager._checkpoint(self)
            return ("v", None)
        if isinstance(request, SendAndReceiveRequest):
            self._send_on_session(request)
            return self._park_receive(
                ReceiveRequest(
                    request.party, request.expected_type, request.scope, request.flow_name
                )
            )
        if isinstance(request, ReceiveRequest):
            self.get_or_open_session(request.party, request.scope, request.flow_name)
            return self._park_receive(request)
        if isinstance(request, (VerifyTxRequest, VerifySigRequest)):
            if self.replaying:
                # Completed before the crash — replay the recorded outcome.
                return self._consume_replay_entry()
            # Crashed (or first reached) while pending: (re-)enqueue.
            self.state = _WAIT_VERIFY
            self.manager._enqueue_verify(self, request)
            return _PARKED
        if isinstance(request, ServiceRequest):
            if self.replaying:
                return self._consume_replay_entry()
            # Live (or restored): (re-)launch the async operation; the node's
            # run loop polls it. start() must be idempotent across restarts.
            self.state = _WAIT_SERVICE
            self.manager._enqueue_service(self, request.start())
            return _PARKED
        raise FlowException(f"flow yielded unknown request {request!r}")

    def _consume_replay_entry(self):
        entry = self.resolved[self._replay_cursor]
        self._replay_cursor += 1
        return entry

    def _park_receive(self, request: ReceiveRequest):
        if self.replaying:
            entry = self.resolved[self._replay_cursor]
            self._replay_cursor += 1
            return entry
        session = self.sessions[f"{request.scope}|{request.party.name}"]
        if session.receive_buffer:
            payload = session.receive_buffer.pop(0)
            return self._resolve_received(request, payload)
        self.state = _WAIT_RECEIVE
        self.waiting_on = request
        self.manager._checkpoint(self)
        return _PARKED

    def _resolve_received(self, request: ReceiveRequest, payload):
        """Type-check an inbound payload and produce the feed entry."""
        if isinstance(payload, _SessionEndedMarker):
            err = FlowSessionException(
                f"Counterparty flow on {request.party} has ended before sending data"
            )
            entry = self._record("e", err=err)
            self.manager._checkpoint(self)
            return entry
        if not isinstance(payload, request.expected_type):
            err = FlowSessionException(
                f"Expected {request.expected_type.__name__}, got {type(payload).__name__}"
            )
            entry = self._record("e", err=err)
            self.manager._checkpoint(self)
            return entry
        value = UntrustworthyData(payload)
        self._record("v", value)  # wrapped, so replay feeds the same shape
        self.manager._checkpoint(self)
        return ("v", value)

    # -- events from the manager ------------------------------------------

    def deliver_session_payload(self, session: FlowSession, payload) -> None:
        if (
            self.state == _WAIT_RECEIVE
            and self.waiting_on is not None
            and self.waiting_on.party.name == session.party.name
            and self.waiting_on.scope == session.scope
        ):
            request, self.waiting_on = self.waiting_on, None
            self.state = _RUNNABLE
            self.pending_value = self._resolve_received(request, payload)
            self.manager._mark_runnable(self)
        else:
            session.receive_buffer.append(payload)
            self.manager._checkpoint(self)

    def deliver_verify_result(self, ok: bool, error: BaseException | None) -> None:
        assert self.state == _WAIT_VERIFY
        self.state = _RUNNABLE
        if ok:
            self.pending_value = self._record("v", None)
        else:
            self.pending_value = self._record("e", err=error)
        self.manager._checkpoint(self)
        self.manager._mark_runnable(self)

    def deliver_service_result(self, value=None,
                               error: BaseException | None = None) -> None:
        assert self.state == _WAIT_SERVICE
        self.state = _RUNNABLE
        if error is None:
            self.pending_value = self._record("v", value)
        else:
            self.pending_value = self._record("e", err=error)
        self.manager._checkpoint(self)
        self.manager._mark_runnable(self)

    def session_confirmed(self, session: FlowSession) -> None:
        session.state = "open"
        for payload in session.outgoing_buffer:
            self.manager._send_session_message(
                session.party, session.peer_id, SessionData(session.peer_id, payload)
            )
            session.send_count += 1
        session.outgoing_buffer.clear()
        self.manager._checkpoint(self)

    def session_rejected(self, session: FlowSession, reason: str) -> None:
        session.state = "ended"
        self.deliver_session_payload(session, _SESSION_ENDED)

    def session_ended(self, session: FlowSession) -> None:
        session.state = "ended"
        if (
            self.state == _WAIT_RECEIVE
            and self.waiting_on is not None
            and self.waiting_on.party.name == session.party.name
            and self.waiting_on.scope == session.scope
        ):
            self.deliver_session_payload(session, _SESSION_ENDED)

    # -- completion --------------------------------------------------------

    def _finish(self, result) -> None:
        self.state = _DONE
        self._progress_done()
        self._record_root_span()
        self.manager._flow_finished(self)
        self.future.set_result(result)

    def _fail(self, exc: BaseException) -> None:
        self.state = _DONE
        self._progress_done()
        self._record_root_span(failed=True)
        logger.debug("flow %s failed: %s", self.run_id.hex()[:8], exc)
        self.manager._flow_finished(self)
        self.future.set_exception(exc)

    def _record_root_span(self, failed: bool = False) -> None:
        """The flow's whole-lifetime span — the end-to-end anchor a trace's
        stage breakdown is measured against (obs/collect.py)."""
        if _obs.ACTIVE is None or self.trace_id is None:
            return
        attrs = {"run_id": self.run_id.hex()}
        if failed:
            attrs["failed"] = True
        _obs.record(
            f"flow:{type(self.logic).__name__}",
            self.trace_t0, _obs.now(),
            trace_id=self.trace_id, span_id=self.trace_span,
            parent=self.trace_parent, attrs=attrs)

    def _progress_done(self) -> None:
        """The framework, not each flow, marks trackers Done on completion —
        success or failure — so observers never see a finished flow stuck on
        its last step."""
        tracker = self.logic.progress_tracker
        if tracker is not None:
            from ..utils.progress import DONE

            if tracker.current_step != DONE:
                tracker.current_step = DONE

    def to_checkpoint(self) -> Checkpoint:
        return Checkpoint(
            run_id=self.run_id,
            flow_name=type(self.logic).flow_name or type(self.logic).__qualname__,
            flow_args=self.logic.checkpoint_args(),
            resolved=tuple(self.resolved),
            sessions=tuple(s.to_checkpoint() for s in self.sessions.values()),
            next_session_seq=self.next_session_seq,
        )


class _Parked:
    pass


_PARKED = _Parked()


@register
@dataclass(frozen=True)
class _SessionEndedMarker:
    """Sentinel buffered when a peer ends/rejects; serializable because it can
    sit in a checkpointed receive buffer."""


_SESSION_ENDED = _SessionEndedMarker()


def _rebuild_exception(entry) -> BaseException:
    """Typed rebuild via the excheckpoint whitelist; unregistered types
    degrade to a generic FlowException with the original name in the text."""
    exc = rebuild_exception(entry)
    if exc is not None:
        return exc
    _, type_name, message, *_rest = entry
    return FlowException(f"{type_name}: {message}")


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class StateMachineManager:
    """Owns every live flow on a node; single-threaded cooperative pump."""

    def __init__(
        self,
        service_hub,
        messaging: MessagingService,
        checkpoint_storage: CheckpointStorage | None = None,
        verifier: BatchVerifier | None = None,
        our_identity: Party | None = None,
        token_context: "TokenContext | None" = None,
        defer_verify: bool = False,
        defer_checkpoints: bool = False,
        reprobe_cooldown_s: float = 5.0,
    ):
        # defer_verify: leave VerifyTxRequests queued until the scheduler
        # calls flush_pending_verifies() — lets a node accumulate sig checks
        # across ALL messages delivered in a scheduling round, maximising the
        # device batch (the max-wait micro-batching of SURVEY.md §7 stage 6).
        self.defer_verify = defer_verify
        # Seconds a degraded device tier waits before its re-probe
        # (_degrade_and_reverify -> crypto.provider.degrade_device).
        self.reprobe_cooldown_s = reprobe_cooldown_s
        # defer_checkpoints: record WHICH flows changed and serialize/write
        # each one ONCE per scheduling round (flush_checkpoints), instead of
        # at every suspension — a flow suspends ~4-9 times per round on the
        # notary path, and each eager write re-serialized the whole growing
        # checkpoint. Sound because the design is replay-based: a crash
        # re-runs from the last durable checkpoint and the transport
        # redelivers anything un-ACKed (the node run loop flushes checkpoints
        # inside the same db round-transaction that holds the round's outbox
        # writes, and ACKs only after it commits).
        self.defer_checkpoints = defer_checkpoints
        self._dirty_checkpoints: dict[bytes, "FlowStateMachine"] = {}
        self.service_hub = service_hub
        self.messaging = messaging
        self.checkpoint_storage = (
            checkpoint_storage if checkpoint_storage is not None
            else InMemoryCheckpointStorage()  # ("or" would drop an empty storage)
        )
        self.token_context = token_context or TokenContext()
        self.verifier = verifier or get_verifier()
        self.our_identity = our_identity or (
            service_hub.my_info.legal_identity if service_hub and service_hub.my_info else None
        )
        self.flows: dict[bytes, FlowStateMachine] = {}
        self._sessions_by_local_id: dict[int, tuple[FlowStateMachine, FlowSession]] = {}
        self._session_handlers: dict[int, Any] = {}
        self._flow_factories: dict[str, Callable[[Party], FlowLogic]] = {}
        self._runnable: list[FlowStateMachine] = []
        self._verify_queue: list[tuple[FlowStateMachine, VerifyTxRequest]] = []
        self._verify_sig_count = 0
        self._verify_waiting_since = 0.0
        # QoS plane (qos/context.py), all inert while disarmed: pump pick
        # counter for the bulk anti-starvation ratio, and the earliest
        # interactive deadline among queued verify jobs (epoch ns, 0 =
        # none) driving the run loop's early micro-batch flush.
        self._qos_pick_counter = 0
        self._verify_qos_deadline_ns = 0
        self._service_queue: list[tuple[FlowStateMachine, Callable]] = []
        # Async verify pipeline (crypto/async_verify.AsyncVerifyService),
        # installed by the node assembly when batch.async_verify is on;
        # None = the classic synchronous flush path.
        self.async_verify = None
        self.recent_results: dict[bytes, FlowFuture] = {}
        self._pumping = False
        # Session-send coalescer (round 15): sends issued while the pump is
        # running are buffered and flushed at pump-end as per-destination
        # multi-frame bursts (transport send_many), so a burst of N flow
        # starts costs O(destinations) transport round-trips instead of N.
        # Each entry carries the obs/qos contexts captured at the flow step
        # that queued it — the transport stamps frames from thread-locals
        # at SEND time, so the flush re-installs them per group.
        self._send_buffer: list = []
        # Optional on-demand network-map refresh (set by the node assembly):
        # consulted once when a send target is missing from the cache.
        self.netmap_refresh: Callable[[], None] | None = None
        self.changes = EventLog()  # bounded flow/progress event feed
        # Metrics (reference: StateMachineManager.kt:105-113)
        self.metrics = {"started": 0, "finished": 0, "checkpointing_rate": 0,
                        "verify_batches": 0, "verify_sigs": 0,
                        # ServiceRequest seam (Raft commit_async etc.):
                        # completions per poll pass attribute how many
                        # commits a round hands the consensus group-commit
                        # buffer at once (the upstream half of the raft
                        # entries_per_batch stamp).
                        "service_polls": 0, "service_completions": 0,
                        "service_round_max": 0,
                        # Device-verifier failures absorbed by the host
                        # tier (degrade_device) instead of rejecting flows.
                        "verify_device_degraded": 0,
                        # Session handler deregistrations that raced flow
                        # teardown (handler already gone): counted, never
                        # silently swallowed.
                        "handler_remove_failures": 0,
                        # Durability plane: wire frames that failed codec
                        # decode (hostile or damaged bytes) and checkpoints
                        # quarantined at restore because their blob no
                        # longer decodes — each is a flow declared failed,
                        # never a silent drop.
                        "undecodable_messages": 0,
                        "checkpoints_quarantined": 0,
                        # Ingest plane: session sends issued from inside a
                        # pump (coalescer-eligible), bursts actually shipped
                        # via transport send_many, and frames those bursts
                        # carried — frames/burst is the client-side wire
                        # amortization the round-15 firehose relies on.
                        "session_sends": 0,
                        "session_bursts": 0,
                        "session_burst_frames": 0}
        # Per-flow-name timing aggregates (the JMX/Jolokia capability the
        # reference exports per-MBean, reference: Node.kt:313 — here over
        # RPC node_metrics + /api/metrics): count / total_ms / max_ms per
        # flow class, recorded at completion. Bounded: a pathological
        # stream of distinct flow names cannot grow it without limit.
        self.flow_timings: dict[str, dict] = {}
        self.FLOW_TIMINGS_MAX_NAMES = 256

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.messaging.add_message_handler(
            SESSION_TOPIC, DEFAULT_SESSION_ID, self._on_session_init_message
        )
        self._restore_checkpoints()
        self._pump()

    def register_flow_initiator(
        self, initiator_flow_name: str, factory: Callable[[Party], FlowLogic]
    ) -> None:
        """When a SessionInit for `initiator_flow_name` arrives, build the
        responding flow with the initiating party
        (reference: ServiceHubInternal.registerFlowInitiator)."""
        self._flow_factories[initiator_flow_name] = factory

    def add(self, logic: FlowLogic, qos=None) -> FlowHandle:
        """Start a new flow (reference: StateMachineManager.kt:381-397)."""
        # Random run ids: a counter would restart at 0 after a crash and
        # collide with checkpoint-restored flows.
        run_id = os.urandom(16)
        fsm = FlowStateMachine(self, logic, run_id)
        if _tm.ACTIVE is not None:
            _tm.inc("flows_started_total")
        if _obs.ACTIVE is not None:
            # A client-started flow roots a NEW trace; everything downstream
            # (sessions, verify batches, raft commits) stitches under it.
            fsm.trace_id = _obs.new_trace_id()
            fsm.trace_span = _obs.new_span_id()
            fsm.trace_t0 = _obs.now()
        if _qos.ACTIVE is not None:
            # Explicit lane wins; otherwise inherit the starting thread's
            # context (a flow started from inside another flow's step
            # shares its lane, same semantics as sub-flows).
            if qos is None:
                qos = _qos.get_context()
            fsm.qos = qos
            if qos is not None:
                lane_key = (f"{qos.lane}_flows"
                            if qos.lane in _qos.LANES else None)
                if lane_key is not None:
                    _qos.ACTIVE.counters[lane_key] += 1
        self.flows[run_id] = fsm
        self.metrics["started"] += 1
        self._subscribe_progress(logic, run_id)
        # Write-through even in deferred mode: a freshly added flow (RPC
        # start) must be durable before the caller learns its run id.
        self._write_checkpoint(fsm)
        self._mark_runnable(fsm)
        self.changes.append(("add", run_id))
        self._pump()
        return FlowHandle(run_id, fsm.future, logic)

    def _subscribe_progress(self, logic: FlowLogic, run_id: bytes) -> None:
        """Surface a flow's tracker steps on the manager's change feed (the
        reference streams these to RPC, CordaRPCOps.kt:66-67). Called at
        EVERY flow-creation site — add(), session-initiated factories and
        checkpoint restore — so restored flows keep reporting."""
        if logic.progress_tracker is not None:
            logic.progress_tracker.subscribe(
                lambda change, rid=run_id:
                self.changes.append(("progress", rid, change.path)))

    @property
    def in_flight_count(self) -> int:
        return len(self.flows)

    def _record_flow_timing(self, fsm: "FlowStateMachine") -> None:
        try:
            name = fsm.logic._my_flow_name()
        except Exception:
            name = type(fsm.logic).__name__
        timing = self.flow_timings.get(name)
        if timing is None:
            if len(self.flow_timings) >= self.FLOW_TIMINGS_MAX_NAMES:
                return  # bounded; established names keep aggregating
            timing = self.flow_timings[name] = {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0}
        duration_ms = (_time.monotonic() - fsm.created_at) * 1e3
        timing["count"] += 1
        timing["total_ms"] = round(timing["total_ms"] + duration_ms, 3)
        timing["max_ms"] = round(max(timing["max_ms"], duration_ms), 3)
        if _tm.ACTIVE is not None:
            _tm.inc("flows_completed_total")

    # -- checkpoint & restore ---------------------------------------------

    def _checkpoint(self, fsm: FlowStateMachine) -> None:
        if fsm.state == _DONE:
            return
        if self.defer_checkpoints:
            self._dirty_checkpoints[fsm.run_id] = fsm
            return
        self._write_checkpoint(fsm)

    def _write_checkpoint(self, fsm: FlowStateMachine) -> None:
        if _faults.ACTIVE is not None:
            _faults.fire_fsync("checkpoint.write")
        self.metrics["checkpointing_rate"] += 1
        blob = self._serialize_checkpoint(fsm)
        self.checkpoint_storage.update_checkpoint(fsm.run_id, blob)

    def _serialize_checkpoint(self, fsm: FlowStateMachine) -> bytes:
        try:
            with self.token_context:
                return serialize(fsm.to_checkpoint()).bytes
        except Exception as e:
            # Unserializable flow state is a programming error; fail loudly.
            raise FlowException(f"cannot checkpoint flow: {e}") from e

    def flush_checkpoints(self) -> int:
        """Serialize + write every round-dirty flow checkpoint (deferred
        mode). Called by the node run loop inside the round transaction,
        before the transport ACKs the round's inbound messages.

        A flow whose state will not SERIALIZE is failed in place — exactly
        what an exception raised inside one of its handlers would do — and
        the round stays committable. Propagating instead would roll back the
        whole round and exit the node; on restart the flow would replay to
        the same unserializable state and crash it again — a permanent
        crash loop triggered by one bad flow (round-3 advisor finding).
        Storage-level write failures still abort the round: those compromise
        every flow's durability, not one flow's.
        """
        if not self._dirty_checkpoints:
            return 0
        dirty, self._dirty_checkpoints = self._dirty_checkpoints, {}
        n = 0
        for fsm in dirty.values():
            if fsm.state == _DONE:
                continue  # finished mid-round; checkpoint already removed
            self.metrics["checkpointing_rate"] += 1
            try:
                blob = self._serialize_checkpoint(fsm)
            except FlowException as e:
                logger.error(
                    "flow %s has unserializable state; failing the flow: %s",
                    fsm.run_id.hex()[:8], e)
                fsm._fail(e)
                continue
            self.checkpoint_storage.update_checkpoint(fsm.run_id, blob)
            n += 1
        return n

    def _restore_checkpoints(self) -> None:
        """Rebuild flows by deterministic replay
        (reference: StateMachineManager.kt:190-226)."""
        # items() (durability plane) yields CRC-verified (run_id, blob)
        # pairs and quarantines rows whose checksum fails before we ever
        # decode them; plain checkpoints() is the fallback for storage
        # implementations that predate it.
        items = getattr(self.checkpoint_storage, "items", None)
        pairs = items() if items is not None else [
            (None, blob) for blob in self.checkpoint_storage.checkpoints()]
        for run_id, blob in pairs:
            try:
                with self.token_context:
                    cp = deserialize(blob)
            except DeserializationError as e:
                # A checkpoint that passed (or predates) its CRC but no
                # longer decodes is damage the codec caught: quarantine it
                # so replay is never poisoned, and surface the loss — the
                # flow is failed, not silently forgotten.
                self.metrics["checkpoints_quarantined"] += 1
                quarantine = getattr(
                    self.checkpoint_storage, "quarantine", None)
                if quarantine is not None and run_id is not None:
                    quarantine(run_id, blob, f"undecodable checkpoint: {e}")
                logger.error("quarantined undecodable checkpoint: %s", e)
                continue
            try:
                logic = flow_registry.create(cp.flow_name, tuple(cp.flow_args))
            except FlowException:
                logger.error("dropping checkpoint for unknown flow %s", cp.flow_name)
                continue
            restored = [FlowSession.from_checkpoint(sc) for sc in cp.sessions]
            sessions = {s.key: s for s in restored}
            self._subscribe_progress(logic, cp.run_id)
            fsm = FlowStateMachine(
                self,
                logic,
                cp.run_id,
                resolved=list(cp.resolved),
                sessions=sessions,
                next_session_seq=cp.next_session_seq,
            )
            for session in sessions.values():
                self._register_session(fsm, session)
            self.flows[cp.run_id] = fsm
            self._mark_runnable(fsm)
            self.changes.append(("restore", cp.run_id))

    # -- scheduling --------------------------------------------------------

    def _mark_runnable(self, fsm: FlowStateMachine) -> None:
        if fsm not in self._runnable and fsm.state != _DONE:
            fsm.state = _RUNNABLE
            self._runnable.append(fsm)
            if (_qos.ACTIVE is not None and fsm.qos is not None
                    and _obs.ACTIVE is not None
                    and fsm.trace_id is not None):
                # Stamp for the lane_queue_wait span closed at pick time.
                fsm.qos_runnable_since = _obs.now()

    def _next_runnable(self) -> FlowStateMachine:
        """Pop the next flow step. Disarmed: strict FIFO (pop(0)), the
        pre-QoS behaviour. Armed: interactive and unlabelled flows form
        one priority class served FIFO ahead of bulk, with every
        ``bulk_every``'th pick taking the oldest bulk step when both
        classes are runnable (anti-starvation) — so a tree that never
        marks a lane still schedules in exact FIFO order."""
        plane = _qos.ACTIVE
        if plane is None:
            return self._runnable.pop(0)
        runnable = self._runnable
        pri_idx = bulk_idx = None
        for i, fsm in enumerate(runnable):
            ctx = fsm.qos
            if ctx is not None and ctx.lane == _qos.LANE_BULK:
                if bulk_idx is None:
                    bulk_idx = i
            elif pri_idx is None:
                pri_idx = i
            if pri_idx is not None and bulk_idx is not None:
                break
        if pri_idx is None or bulk_idx is None:
            idx = 0  # one class present: FIFO
        else:
            self._qos_pick_counter += 1
            if self._qos_pick_counter % plane.bulk_every == 0:
                idx = bulk_idx
                plane.counters["bulk_antistarvation_picks"] += 1
            else:
                idx = pri_idx
        fsm = runnable.pop(idx)
        since = getattr(fsm, "qos_runnable_since", None)
        if since is not None:
            fsm.qos_runnable_since = None
            if (_obs.ACTIVE is not None and fsm.trace_id is not None
                    and fsm.qos is not None):
                _obs.record("lane_queue_wait", since, _obs.now(),
                            trace_id=fsm.trace_id, parent=fsm.trace_span,
                            attrs={"lane": fsm.qos.lane})
        return fsm

    def _pump(self) -> None:
        """Run flows until everything is parked; then flush verify batches.
        Re-entrant calls fold into the outer pump."""
        if self._pumping:
            return
        self._pumping = True
        try:
            while True:
                while self._runnable:
                    fsm = self._next_runnable()
                    if fsm.state != _DONE:
                        fsm.step()
                if self._verify_queue and not self.defer_verify:
                    self._flush_verify_batch()
                    continue
                # Ship buffered session sends as coalesced bursts INSIDE
                # the loop: on the in-memory transport delivery is
                # synchronous and may mark flows runnable again — flushing
                # after the loop would strand them parked.
                if self._flush_session_sends():
                    continue
                break
        finally:
            self._pumping = False
            # Safety net: an exception mid-pump must not strand buffered
            # frames (their flows already suspended expecting delivery).
            # _pumping is already False, so re-entrant pumps from any
            # synchronous delivery run fresh.
            if self._send_buffer:
                self._flush_session_sends()

    def _flush_session_sends(self) -> bool:
        """Ship every buffered session send, grouped into per-destination
        multi-frame bursts (transport send_many) when contexts allow;
        returns True if anything was sent. Grouping key includes session
        topic, destination and the CAPTURED obs/qos contexts — per-session
        frame order is preserved (a session's frames stay in queue order
        inside one group) and traced/QoS-labelled frames keep their own
        stamps (they degrade to smaller groups rather than borrowing the
        flush thread's context)."""
        if not self._send_buffer:
            return False
        buffered, self._send_buffer = self._send_buffer, []
        groups: dict = {}  # key -> [address, obs_ctx, qos_ctx, items]
        order: list = []
        for ts, blob, address, obs_ctx, qos_ctx in buffered:
            key = (ts.topic, ts.session_id, str(address), obs_ctx,
                   id(qos_ctx))
            g = groups.get(key)
            if g is None:
                groups[key] = g = [address, obs_ctx, qos_ctx, []]
                order.append(key)
            g[3].append((ts, blob))
        send_many = getattr(self.messaging, "send_many", None)
        outer_obs = _obs.get_context()
        outer_qos = _qos.get_context()
        try:
            for key in order:
                address, obs_ctx, qos_ctx, items = groups[key]
                if obs_ctx is not None:
                    _obs.set_context(*obs_ctx)
                else:
                    _obs.clear_context()
                _qos.set_context(qos_ctx)
                if send_many is not None and len(items) > 1:
                    send_many(items[0][0], [blob for _, blob in items],
                              address)
                    self.metrics["session_bursts"] += 1
                    self.metrics["session_burst_frames"] += len(items)
                else:
                    for ts, blob in items:
                        self.messaging.send(ts, blob, address)
        finally:
            if outer_obs is not None:
                _obs.set_context(*outer_obs)
            else:
                _obs.clear_context()
            _qos.set_context(outer_qos)
        return True

    def flush_pending_verifies(self) -> int:
        """Flush the accumulated verify micro-batch (deferred mode); returns
        the number of requests satisfied."""
        n = len(self._verify_queue)
        if n:
            self._flush_verify_batch()
            self._pump()
        return n

    # -- the verification pump (the batched-verify seam) -------------------

    def _enqueue_verify(
        self, fsm: FlowStateMachine,
        request: "VerifyTxRequest | VerifySigRequest",
    ) -> None:
        if not self._verify_queue:
            self._verify_waiting_since = _time.monotonic()
        if _obs.ACTIVE is not None and fsm.trace_id is not None:
            # Stamp when this flow's request joined the micro-batch; the
            # verify_wait span closes when the batch flushes/submits.
            fsm.trace_verify_enq = _obs.now()
        if _qos.ACTIVE is not None:
            ctx = fsm.qos
            if (ctx is not None and ctx.lane == _qos.LANE_INTERACTIVE
                    and ctx.deadline_ns > 0
                    and (self._verify_qos_deadline_ns == 0
                         or ctx.deadline_ns < self._verify_qos_deadline_ns)):
                self._verify_qos_deadline_ns = ctx.deadline_ns
        self._verify_queue.append((fsm, request))
        if isinstance(request, VerifySigRequest):
            self._verify_sig_count += 1
            return
        # Count at least 1 per request: a zero-signature request (can't arise
        # from SignedTransaction today, which demands >=1 sig, but belt-and-
        # braces) must still trip the flush gate or its flow parks forever.
        self._verify_sig_count += max(len(request.stx.sigs), 1)

    @property
    def verify_pending_sigs(self) -> int:
        """Signatures waiting in the micro-batch (max-wait scheduler input)."""
        return self._verify_sig_count

    @property
    def verify_waiting_since(self) -> float:
        """monotonic() when the current micro-batch started accumulating."""
        return self._verify_waiting_since

    def verify_deadline_pressure(self) -> bool:
        """True when the earliest interactive deadline in the verify
        micro-batch is within the QoS guard window — the run loop flushes
        early instead of waiting out max_wait_ms (deadline-aware
        coalescing at queueing point 1 of 3)."""
        plane = _qos.ACTIVE
        if plane is None or not self._verify_queue:
            return False
        return plane.deadline_near_ns(self._verify_qos_deadline_ns)

    def qos_queue_depth(self) -> int:
        """Runnable backlog the admission watermark judges bulk against:
        ready flow steps + flows parked on a service poll (commit in
        flight) — the work interactive requests must traverse."""
        return len(self._runnable) + len(self._service_queue)

    def _qos_verify_hint(self) -> None:
        """Advisory (lane, deadline_ns) for the verifier client: a sidecar
        verifier forwards it on the wire so the SERVER's scheduler can
        deadline-flush across processes. Reset with the micro-batch."""
        plane = _qos.ACTIVE
        if plane is None:
            return
        dl = self._verify_qos_deadline_ns
        self.verifier.qos_hint = (
            (_qos.LANE_INTERACTIVE, dl) if dl > 0 else None)

    # -- async service polling (Raft commit etc.) --------------------------

    def _enqueue_service(self, fsm: FlowStateMachine, poll: Callable) -> None:
        self._service_queue.append((fsm, poll))

    @property
    def service_pending(self) -> int:
        """Flows parked on a ServiceRequest (e.g. awaiting a raft commit)."""
        return len(self._service_queue)

    def poll_services(self) -> int:
        """Poll every parked ServiceRequest; resume flows whose operation
        finished. Called from the node's run loop. Returns completions.

        This is the round -> group-submit seam of the commit pipeline: every
        commit_async poll that (re)submits during ONE pass lands in the raft
        leader's pending batch together, and flush_appends seals them into
        one group-commit entry right after (node.run_once ordering)."""
        if not self._service_queue:
            return 0
        done = 0
        still_pending = []
        traced = _obs.ACTIVE is not None
        qos_armed = _qos.ACTIVE is not None
        for fsm, poll in self._service_queue:
            if fsm.state != _WAIT_SERVICE:  # flow died/was restored elsewhere
                continue
            if traced and fsm.trace_id is not None:
                # commit_async submissions inside poll() must carry the
                # submitting flow's context (raft link registration).
                _obs.set_context(fsm.trace_id, fsm.trace_span)
            if qos_armed:
                # Same rule for the QoS link: a (re)submission this poll
                # makes must register under ITS flow's lane/deadline, so
                # set-or-clear per iteration, never inherit a neighbour's.
                _qos.set_context(fsm.qos)
            try:
                outcome = poll()
            except Exception as e:
                fsm.deliver_service_result(error=e)
                done += 1
                continue
            if outcome is None:
                still_pending.append((fsm, poll))
            else:
                fsm.deliver_service_result(value=outcome)
                done += 1
        if traced:
            _obs.clear_context()
        if qos_armed:
            _qos.clear_context()
        self._service_queue = still_pending
        self.metrics["service_polls"] += 1
        if done:
            self.metrics["service_completions"] += done
            self.metrics["service_round_max"] = max(
                self.metrics["service_round_max"], done)
            self._pump()
        return done

    def _flush_verify_batch(self) -> None:
        """One batched kernel call covering every parked VerifyTxRequest and
        VerifySigRequest (the synchronous path: verify on THIS thread)."""
        self._qos_verify_hint()
        batch, self._verify_queue = self._verify_queue, []
        self._verify_sig_count = 0
        self._verify_qos_deadline_ns = 0
        if _obs.ACTIVE is not None:
            self._record_verify_wait(batch)
        jobs, spans = self._build_verify_jobs(batch)
        ok = self.verifier.verify_batch(jobs) if jobs else []
        self.metrics["verify_batches"] += 1
        self.metrics["verify_sigs"] += len(jobs)
        if _tm.ACTIVE is not None:
            _tm.inc("verify_batches_total")
            _tm.inc("verify_sigs_total", len(jobs))
            _tm.observe("verify_batch_sigs", len(jobs))
        self._deliver_verify_results(spans, ok)

    def _record_verify_wait(self, batch) -> None:
        """Close each traced flow's verify_wait span: time from joining the
        verify micro-batch to the batch leaving the queue (flush or async
        submit) — the batching-delay component of notarise latency."""
        now = _obs.now()
        for fsm, _request in batch:
            enq = getattr(fsm, "trace_verify_enq", None)
            if fsm.trace_id is None or enq is None:
                continue
            fsm.trace_verify_enq = None
            _obs.record("verify_wait", enq, now,
                        trace_id=fsm.trace_id, parent=fsm.trace_span)

    def _build_verify_jobs(
        self, batch: "list[tuple[FlowStateMachine, Any]]",
    ) -> "tuple[list[VerifyJob], list[tuple[FlowStateMachine, Any, int, int]]]":
        """Flatten parked requests into one VerifyJob list plus per-request
        spans mapping result ranges back to the waiting flows."""
        jobs: list[VerifyJob] = []
        spans: list[tuple[FlowStateMachine, Any, int, int]] = []
        for fsm, request in batch:
            start = len(jobs)
            if isinstance(request, VerifySigRequest):
                jobs.append(VerifyJob(
                    pubkey=request.pubkey, message=request.message,
                    sig=request.sig_bytes))
            else:
                jobs.extend(
                    VerifyJob(
                        pubkey=sig.by.encoded,
                        message=request.stx.id.bytes,
                        sig=sig.bytes,
                    )
                    for sig in request.stx.sigs
                )
            spans.append((fsm, request, start, len(jobs)))
        return jobs, spans

    def _deliver_verify_results(self, spans, ok) -> None:
        """Resume every flow a finished batch was verifying. Flows that left
        _WAIT_VERIFY while an async batch was in flight (failed in place by
        checkpoint serialization, or torn down) are skipped — their park is
        gone and the result has nowhere to land."""
        for fsm, request, start, end in spans:
            if fsm.state != _WAIT_VERIFY:
                continue
            fsm_ok, error = True, None
            if isinstance(request, VerifySigRequest):
                if not all(ok[start:end]):
                    fsm_ok = False
                    error = SignatureError(
                        f"Signature did not match: {request.description}")
                fsm.deliver_verify_result(fsm_ok, error)
                continue
            if not all(ok[start:end]):
                fsm_ok = False
                bad = [
                    request.stx.sigs[i - start].by
                    for i in range(start, end)
                    if not ok[i]
                ]
                error = SignatureError(f"Signature did not match for keys: {bad}")
            else:
                # Math passed; check completeness on the host (cheap).
                try:
                    missing = request.stx.get_missing_signatures()
                    needed = missing - set(request.allowed_to_be_missing)
                    if needed:
                        from ..transactions.signed import SignaturesMissingException

                        fsm_ok = False
                        error = SignaturesMissingException(
                            needed, [], request.stx.id
                        )
                except Exception as e:
                    fsm_ok, error = False, e
            fsm.deliver_verify_result(fsm_ok, error)

    # -- the async pipeline (crypto/async_verify.py) -----------------------

    def submit_pending_verifies(self) -> int:
        """Hand the accumulated micro-batch to the async feeder thread and
        return immediately (the pipelined counterpart of
        flush_pending_verifies); returns the number of jobs submitted.
        The parked flows stay in _WAIT_VERIFY until drain_async_verifies
        delivers the completed batch on a later round."""
        self._qos_verify_hint()
        batch, self._verify_queue = self._verify_queue, []
        self._verify_sig_count = 0
        self._verify_qos_deadline_ns = 0
        if not batch:
            return 0
        if _obs.ACTIVE is not None:
            self._record_verify_wait(batch)
        jobs, spans = self._build_verify_jobs(batch)
        if _tm.ACTIVE is not None:
            _tm.inc("verify_batches_total")
            _tm.inc("verify_sigs_total", len(jobs))
            _tm.observe("verify_batch_sigs", len(jobs))
        self.async_verify.submit(jobs, spans)
        return len(jobs)

    def drain_async_verifies(self) -> int:
        """Deliver every batch the feeder thread has finished (run-loop
        thread only — flow state crosses back here and nowhere else).
        A batch whose verify RAISED rejects its waiting flows with the
        error instead of hanging them. Returns batches delivered."""
        svc = self.async_verify
        if svc is None:
            return 0
        done = 0
        for handle in svc.drain():
            done += 1
            self.metrics["verify_batches"] += 1
            self.metrics["verify_sigs"] += len(handle.jobs)
            if handle.error is not None:
                if self._degrade_and_reverify(handle):
                    continue
                for fsm, request, start, end in handle.context:
                    if fsm.state != _WAIT_VERIFY:
                        continue
                    fsm.deliver_verify_result(False, handle.error)
            else:
                self._deliver_verify_results(handle.context, handle.ok)
        if done:
            self._pump()
        return done

    def _degrade_and_reverify(self, handle) -> bool:
        """A raised verify on a DEVICE-backed verifier must not reject the
        waiting flows — an infrastructure fault is not a bad signature.
        Demote the device tier (crypto.provider.degrade_device installs the
        gate + cooldown re-probe) and re-verify this batch synchronously on
        the host tier, which has the same accept set. Returns True when the
        batch was delivered that way; False (verifier has no device tier,
        its device tier is this package's CUDA kernels, or the host
        re-verify itself raised) falls back to rejection."""
        verifier = getattr(self.async_verify, "verifier", None)
        if verifier is None or getattr(verifier, "device_min_sigs", None) is None:
            return False
        if getattr(verifier, "kernel_backend", None) == "cuda":
            # A failed kernel launch is an error the flows see, never a
            # silent re-run of the batch on the host.
            return False
        from ..crypto.provider import degrade_device, host_verify

        try:
            degrade_device(verifier, cooldown_s=self.reprobe_cooldown_s)
            ok = host_verify(handle.jobs)
        except Exception:
            logging.getLogger(__name__).exception(
                "host re-verify after device degrade failed")
            return False
        self.metrics["verify_device_degraded"] += 1
        logging.getLogger(__name__).warning(
            "device verify failed (%s); batch of %d re-verified on host, "
            "device tier degraded pending re-probe",
            handle.error, len(handle.jobs))
        self._deliver_verify_results(handle.context, ok)
        return True

    # -- messaging ---------------------------------------------------------

    def _register_session(self, fsm: FlowStateMachine, session: FlowSession) -> None:
        self._sessions_by_local_id[session.local_id] = (fsm, session)
        # Route future messages addressed to this session id.
        registration = self.messaging.add_message_handler(
            SESSION_TOPIC, session.local_id, self._on_existing_session_message
        )
        self._session_handlers[session.local_id] = registration

    def _send_session_message(self, party: Party, session_id: int, payload) -> None:
        node = self.service_hub.network_map_cache.get_node_by_legal_identity(party)
        if node is None and self.netmap_refresh is not None:
            # A peer we've never heard of usually means OUR cache is stale,
            # not that the peer doesn't exist (e.g. a client that registered
            # after our last refresh sends us a SessionInit; the reply
            # address is missing). Refresh on demand and retry once before
            # failing — otherwise the reply is lost and the initiator stalls
            # in redelivery backoff until the periodic refresh catches up.
            self.netmap_refresh()
            node = self.service_hub.network_map_cache \
                .get_node_by_legal_identity(party)
        if node is None:
            raise FlowException(f"don't know where to send to {party}")
        ts = TopicSession(SESSION_TOPIC, session_id or DEFAULT_SESSION_ID)
        blob = serialize(payload).bytes
        if self._pumping:
            # Mid-pump: defer to the pump-end flush so a burst of flow
            # steps ships as ONE multi-frame transport call per
            # destination. Contexts are captured NOW (this flow's step
            # installed them); the flush re-installs them before sending.
            self.metrics["session_sends"] += 1
            self._send_buffer.append(
                (ts, blob, node.address, _obs.get_context(),
                 _qos.get_context()))
            return
        self.messaging.send(ts, blob, node.address)

    def _on_session_init_message(self, message: Message) -> None:
        try:
            payload = deserialize(message.data)
        except DeserializationError as e:
            # Hostile/corrupt bytes must not halt the delivery pump — but
            # ONLY codec rejections are droppable; anything else is a real
            # bug that must surface. Counted so node_metrics shows the rate.
            self.metrics["undecodable_messages"] += 1
            logger.warning("dropping undecodable init message: %s", e)
            return
        if not isinstance(payload, SessionInit):
            logger.warning("non-init message on init session: %r", payload)
            return
        factory = self._flow_factories.get(payload.flow_name)
        initiator = payload.initiator_party
        if factory is None:
            self._send_session_message(
                initiator,
                payload.initiator_session_id,
                SessionReject(
                    payload.initiator_session_id,
                    f"no flow registered for {payload.flow_name}",
                ),
            )
            self._pump()
            return
        logic = factory(initiator)
        run_id = os.urandom(16)
        self._subscribe_progress(logic, run_id)
        fsm = FlowStateMachine(self, logic, run_id)
        if _obs.ACTIVE is not None and message.trace is not None:
            # Session-initiated flow: JOIN the initiator's trace — its span
            # parents ours, which is how one tx's spans stitch across nodes.
            fsm.trace_id, fsm.trace_parent = message.trace
            fsm.trace_span = _obs.new_span_id()
            fsm.trace_t0 = _obs.now()
        if _qos.ACTIVE is not None and message.qos is not None:
            # Join the initiator's lane + deadline: the responder (the
            # notary) schedules this flow under the CLIENT's contract.
            fsm.qos = message.qos
        self.flows[run_id] = fsm
        self.metrics["started"] += 1
        local_id = fsm._session_id(fsm.next_session_seq)
        fsm.next_session_seq += 1
        session = fsm.open_initiated_session(
            initiator, local_id, payload.initiator_session_id
        )
        self._send_session_message(
            initiator,
            payload.initiator_session_id,
            SessionConfirm(payload.initiator_session_id, local_id),
        )
        if payload.first_payload is not None:
            session.receive_buffer.append(payload.first_payload)
        self._checkpoint(fsm)
        self._mark_runnable(fsm)
        self.changes.append(("add", run_id))
        self._pump()

    def _on_existing_session_message(self, message: Message) -> None:
        entry = self._sessions_by_local_id.get(message.topic_session.session_id)
        if entry is None:
            logger.warning("message for unknown session %s", message.topic_session)
            return
        fsm, session = entry
        try:
            payload = deserialize(message.data)
        except Exception as e:
            logger.warning("dropping undecodable session message: %s", e)
            return
        if isinstance(payload, SessionConfirm):
            session.peer_id = payload.initiated_session_id
            fsm.session_confirmed(session)
        elif isinstance(payload, SessionReject):
            fsm.session_rejected(session, payload.error_message)
        elif isinstance(payload, SessionData):
            fsm.deliver_session_payload(session, payload.payload)
        elif isinstance(payload, SessionEnd):
            fsm.session_ended(session)
        else:
            logger.warning("unknown session payload %r", payload)
        self._pump()

    # -- completion --------------------------------------------------------

    def _flow_finished(self, fsm: FlowStateMachine) -> None:
        self.flows.pop(fsm.run_id, None)
        self._dirty_checkpoints.pop(fsm.run_id, None)
        self.checkpoint_storage.remove_checkpoint(fsm.run_id)
        self.metrics["finished"] += 1
        self._record_flow_timing(fsm)
        # Bounded outcome cache so RPC clients can fetch results after the
        # flow leaves the registry (the reference returns a future over RPC).
        self.recent_results[fsm.run_id] = fsm.future
        while len(self.recent_results) > 1000:
            self.recent_results.pop(next(iter(self.recent_results)))
        self.changes.append(("remove", fsm.run_id))
        for session in fsm.sessions.values():
            self._sessions_by_local_id.pop(session.local_id, None)
            registration = self._session_handlers.pop(session.local_id, None)
            if registration is not None:
                try:
                    self.messaging.remove_message_handler(registration)
                except (LookupError, ValueError):
                    # Teardown race: the handler was already removed (node
                    # stop or duplicate finish). Count it — a nonzero rate
                    # here means deregistration logic regressed.
                    self.metrics["handler_remove_failures"] += 1
            if session.state == "open" and session.peer_id is not None:
                try:
                    self._send_session_message(
                        session.party, session.peer_id, SessionEnd(session.peer_id)
                    )
                except FlowException:
                    pass
            session.state = "ended"
