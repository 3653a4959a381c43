"""RPC: the client-facing node API over the messaging transport.

Capability match for the reference's RPC tier (reference:
node/src/main/kotlin/net/corda/node/services/messaging/CordaRPCOps.kt:62-117
— the ops interface; RPCDispatcher.kt:33-60 — server-side dispatch;
client/src/main/kotlin/net/corda/client/CordaRPCClient.kt:29-60 — the client;
node/.../services/RPCUserService.kt — user/password auth from config).

Shape: requests ride the normal messaging transport on topic "platform.rpc"
as whitelisted codec payloads; the dispatcher authenticates, looks the method
up on NodeRpcOps (never arbitrary attributes), and replies to the sender's
address. Streams (the reference's Observables) map to polling methods with
explicit cursors — idiomatic for a request/reply transport and crash-safe
(a reconnecting client re-polls from its last cursor).

The client is deliberately node-free: it opens its own TcpMessaging endpoint,
so any process that can reach the node's socket can drive it.

The port's own copy of ``corda_tpu/node/rpc.py``. ``node_metrics``'s ``kernel_backend`` stamp is the port's
(``"cuda"`` when the newest verify ran the card's kernels, ``"torch-cpu"``
for the plain versions); the client splits ``call`` into ``submit`` and
``take_reply``, so an open-loop generator need not wait for each reply.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

from ..crypto.hashes import SecureHash
from ..flows.api import flow_registry
from ..obs import telemetry as _tm
from ..obs import trace as _obs
from ..qos import context as _qos
from ..serialization.codec import deserialize, register, serialize
from ..testing import faults as _faults
from .messaging.api import Message, MessagingService, TopicSession
from .services import integrity as _integrity

# Codec-whitelist imports: every type that can cross the RPC boundary must be
# REGISTERED in the client process too, and registration happens at module
# import. A standalone RpcClient (no Node constructed) would otherwise fail
# to deserialize replies containing NodeInfo, StateAndRef, SignedTransaction…
from ..contracts import structures as _structures  # noqa: F401
from ..transactions import signed as _signed  # noqa: F401
from .services import api as _services_api  # noqa: F401

RPC_TOPIC = "platform.rpc"


@register
@dataclass(frozen=True)
class RpcRequest:
    request_id: bytes
    user: str
    password: str
    method: str
    args: tuple = ()


@register
@dataclass(frozen=True)
class RpcReply:
    request_id: bytes
    ok: bool
    value: Any = None
    error: str | None = None


@register
@dataclass(frozen=True)
class FlowHandleInfo:
    """What start_flow returns over the wire."""

    run_id: bytes


@register
@dataclass(frozen=True)
class RpcPushEvent:
    """Server-push frame for a change subscription (the reference marshals
    rx Observables to per-client queues, RPCDispatcher.kt:33-60; here the
    stream rides the durable messaging transport as pushed frames with
    ABSOLUTE cursors, so a reconnecting client resumes from its last seen
    cursor without loss)."""

    subscription_id: bytes
    cursor: int         # absolute cursor AFTER `events`
    events: tuple       # (kind, run_id[, path]) tuples from the change log


@register
@dataclass(frozen=True)
class RpcUser:
    """reference: RPCUserService.kt — username/password/permissions."""

    username: str
    password: str
    permissions: tuple[str, ...] = ()  # flow names; ("ALL",) = everything

    def may_start(self, flow_name: str) -> bool:
        return "ALL" in self.permissions or flow_name in self.permissions


class NodeRpcOps:
    """The dispatchable surface (CordaRPCOps.kt:62-117 capability). Every
    public method here is callable over RPC — nothing else is."""

    def __init__(self, node):
        self._node = node

    # -- flows -------------------------------------------------------------

    def start_flow_dynamic(self, flow_name: str, args: tuple) -> FlowHandleInfo:
        logic = flow_registry.create(flow_name, tuple(args))
        handle = self._node.smm.add(logic)
        return FlowHandleInfo(run_id=handle.run_id)

    def flow_result(self, run_id: bytes):
        """(done, value) — poll until done; raises the flow's error."""
        fsm = self._node.smm.flows.get(run_id)
        if fsm is not None:
            if not fsm.future.done:
                return (False, None)
            return (True, fsm.future.result())
        future = self._node.smm.recent_results.get(run_id)
        if future is None:
            raise KeyError(f"unknown flow {run_id.hex()}")
        return (True, future.result())

    def state_machines_snapshot(self) -> tuple:
        return tuple(self._node.smm.flows.keys())

    def state_machine_changes(self, cursor: int) -> tuple:
        """(new_cursor, events since cursor) — the polling form of the
        reference's stateMachinesAndUpdates observable. Cursors are absolute
        indices into a bounded event log; evicted history is simply absent."""
        return self._node.smm.changes.since(cursor)

    # -- ledger ------------------------------------------------------------

    def vault_snapshot(self) -> tuple:
        return tuple(self._node.services.vault_service.current_vault.states)

    def vault_page(self, after_txhash: bytes | None = None,
                   after_index: int = 0, page_size: int = 256) -> tuple:
        """One keyset page of unconsumed states: (states, cursor) where
        cursor is (txhash_bytes, index) to pass back as after_* for the
        next page, or None at the end. The paginated sibling of
        vault_snapshot — a million-state vault streams page by page
        instead of one giant frame."""
        from .services.vault import VaultQuery

        after = None
        if after_txhash is not None:
            after = (bytes(after_txhash), int(after_index))
        page = self._node.services.vault_service.query(
            VaultQuery(after=after, page_size=int(page_size)))
        return (page.states, page.next_cursor)

    def vault_balances(self) -> dict:
        """Per-currency unconsumed totals — an O(1) aggregate read on the
        indexed engine, never a vault materialization."""
        return dict(self._node.services.vault_service.balances())

    def verified_transaction(self, tx_id: SecureHash):
        return self._node.services.storage_service.validated_transactions \
            .get_transaction(tx_id)

    def state_machine_recorded_transaction_mapping(self) -> tuple:
        """Snapshot of the flow-run → tx provenance log (reference:
        CordaRPCOps.kt:86). The observable half rides the push stream as
        ("tx_recorded", run_id, tx_id_bytes) change events — subscribe via
        subscribe_changes for live updates, poll this for the full join."""
        mapping = self._node.services.storage_service \
            .state_machine_recorded_transaction_mapping
        return tuple(mapping.mappings()) if mapping is not None else ()

    # -- network -----------------------------------------------------------

    def network_map_snapshot(self) -> tuple:
        return tuple(self._node.services.network_map_cache.party_nodes)

    def node_identity(self):
        return self._node.identity

    # -- observability (MonitoringService.kt:11 capability: the metric
    # registry, exported here over RPC instead of JMX) ---------------------

    def node_metrics(self) -> dict:
        smm = self._node.smm
        # Self-describing verification stamps (round-4 verdict: trend lines
        # silently changed meaning because nothing recorded WHICH verifier /
        # kernel backend produced a number).
        from ..ops import last_backend_if_loaded

        kernel_backend = last_backend_if_loaded()
        av_stats = (smm.async_verify.stats()
                    if smm.async_verify is not None else None)
        return dict(smm.metrics) | {
            "flows_in_flight": smm.in_flight_count,
            "verify_pending_sigs": smm.verify_pending_sigs,
            "verifier": getattr(smm.verifier, "name", None),
            "kernel_backend": kernel_backend,
            # Size-crossover routing (TorchVerifier): how many
            # batches actually went to the device vs the host tier.
            "verify_device_batches": getattr(
                smm.verifier, "device_batches", None),
            "verify_host_batches": getattr(
                smm.verifier, "host_batches", None),
            # Device gate state: False while a degraded device tier
            # re-probes (batches host-route until then), True once it is
            # back, None when no gate was installed (a cpu verifier, or a
            # device tier that never degraded: start() warms it in line).
            "verify_device_ready": (
                smm.verifier.device_gate.is_set()
                if getattr(smm.verifier, "device_gate", None) is not None
                else None),
            # The size crossover currently in force (the adaptive tuner
            # moves it at runtime); None for verifiers with no device tier.
            "verify_device_min_sigs": getattr(
                smm.verifier, "device_min_sigs", None),
            # The EFFECTIVE crossover: AdaptiveCrossover's learned value
            # previously lived only in memory — stamped so artifacts show
            # why traffic routed where it did. Falls back to the verifier's
            # live value when no tuner is attached (same number today,
            # since the tuner rewrites the verifier in place).
            "verify_effective_min_sigs": (
                (av_stats or {}).get(
                    "effective_min_sigs",
                    getattr(smm.verifier, "device_min_sigs", None))),
            "verify_static_min_sigs": (
                (av_stats or {}).get("static_min_sigs")),
            # Async pipeline counters (crypto/async_verify.py): submitted/
            # in-flight/completed batches, queue wait vs device wall, and
            # the adaptive crossover state; None in synchronous mode.
            "async_verify": av_stats,
            # Sidecar client stamps (node/verify_client.py): batches/sigs
            # shipped to the host's shared verify server, fallbacks,
            # degrade gate state; None when no sidecar is configured.
            "sidecar": (smm.verifier.sidecar_stats()
                        if hasattr(smm.verifier, "sidecar_stats")
                        else None),
            # Commit-pipeline stamps (services/raft.py): group-commit
            # entries/batch, pipelined-replication frames, reply coalescing,
            # replication RTT; None on non-raft nodes.
            "raft": (self._node.raft_member.stamp()
                     if getattr(self._node, "raft_member", None) is not None
                     else None),
            # Sharded-notary coordinator stamps (services/sharding.py):
            # fast-path vs cross-shard counts, aborts, reserve retries;
            # None when this node is not a shard member.
            "sharding": (self._node.uniqueness_provider.stamp()
                         if hasattr(getattr(self._node,
                                            "uniqueness_provider", None),
                                    "stamp")
                         else None),
            # Transport burst stamps (messaging/tcp.py): outbox executemany
            # bursts + bridge writev flushes; None on non-TCP fakes.
            "transport": (self._node.messaging.transport_stats()
                          if hasattr(self._node.messaging, "transport_stats")
                          else None),
            # Per-flow-name completion timings (count/total_ms/max_ms) —
            # the per-flow half of the reference's JMX metrics export.
            "flow_timings": {k: dict(v)
                             for k, v in smm.flow_timings.items()},
            # Armed fault-injection counters (testing/faults.py): fired
            # "point:action" counts, or None when no plan is armed — lets a
            # chaos harness audit what a node actually injected.
            "faults": (_faults.ACTIVE.injected()
                       if _faults.ACTIVE is not None else None),
            # Tracing recorder stamps (obs/trace.py): recorded/buffered/
            # dropped span counts, or None while disarmed.
            "obs": (_obs.ACTIVE.stats()
                    if _obs.ACTIVE is not None else None),
            # Durability plane stamps (services/integrity.py): process-wide
            # quarantine/shed counters plus this node's online-scrubber
            # scan/error counts when one is armed.
            "durability": _integrity.stats(
                getattr(self._node, "scrubber", None)),
            # QoS plane stamps (qos/context.py): per-lane flow counts,
            # anti-starvation picks, early flushes — plus the admission
            # controller's admitted/shed counters when one is attached to
            # the notary service. None while disarmed.
            "qos": (_qos.ACTIVE.stats()
                    if _qos.ACTIVE is not None else None),
            "admission": (
                self._node.notary_service.admission.stats()
                if getattr(getattr(self._node, "notary_service", None),
                           "admission", None) is not None else None),
            # Device-tier degrade bookkeeping (crypto/provider.py
            # degrade_device): demotions and re-probe outcomes.
            "verify_device_degrades": getattr(smm.verifier, "degraded", None),
            "verify_device_reprobes_ok": getattr(
                smm.verifier, "reprobes_ok", None),
            "verify_device_reprobes_failed": getattr(
                smm.verifier, "reprobes_failed", None),
            # Round profiler (obs/telemetry.py): the always-on per-phase
            # attribution of round wall time — the block that explains a
            # first_bottleneck of "rounds". None before the first round.
            "round_breakdown": _tm.format_breakdown(
                smm.metrics.get("round_phase_s")),
            # Process-global telemetry registry counters (the histogram
            # halves export via /metrics and telemetry_snapshot — counters
            # alone keep this stamp grep-sized). None only if a test
            # disarmed the always-on registry.
            "telemetry": ((_tm.snapshot() or {}).get("counters")
                          if _tm.ACTIVE is not None else None),
        }

    def telemetry_snapshot(self) -> dict:
        """The full telemetry registry (counters + histograms) for the
        driver-side cluster collector (obs/export.py collect_cluster) —
        the RPC twin of GET /metrics, JSON instead of exposition text so
        the collector merges exact sparse buckets, not parsed ones."""
        return {
            "node": self._node.config.name,
            "armed": _tm.ACTIVE is not None,
            "snapshot": _tm.snapshot(),
            "flight": (_tm.ACTIVE.flight.stats()
                       if _tm.ACTIVE is not None
                       and _tm.ACTIVE.flight is not None else None),
        }

    def trace_snapshot(self) -> dict:
        """This node's span buffer (obs/trace.py) for the driver-side trace
        collector — the RPC twin of GET /api/trace, so the loadtest can
        gather spans from cluster members that run without a webserver."""
        rec = _obs.ACTIVE
        return {
            "node": self._node.config.name,
            "armed": rec is not None,
            "spans": rec.snapshot() if rec is not None else [],
            "stats": rec.stats() if rec is not None else None,
        }


class RpcDispatcher:
    """Server side: authenticate, dispatch, reply (RPCDispatcher.kt:33-60).

    Also owns PUSH subscriptions: a client subscribes to the state-machine
    change feed once, and the node run loop pushes new events to the
    client's address as they appear (push_pending) — the reference's
    Observable-over-queues capability, with cursor-resume instead of
    handle counters. Subscriptions expire unless renewed (a vanished
    client must not grow an outbox forever).
    """

    SUBSCRIPTION_TTL_S = 120.0

    def __init__(self, node, users: tuple[RpcUser, ...]):
        self.ops = NodeRpcOps(node)
        self.users = {u.username: u for u in users}
        self._node = node
        self._messaging = node.messaging
        # subscription_id -> [sender_address, cursor, expires_at]
        self._subscriptions: dict[bytes, list] = {}
        self._messaging.add_message_handler(RPC_TOPIC, 0, self._on_request)

    def _on_request(self, message: Message) -> None:
        try:
            req = deserialize(message.data)
        except Exception:
            return
        if not isinstance(req, RpcRequest):
            return
        if req.method == "subscribe_changes":
            reply = self._handle_subscribe(req, message.sender)
        else:
            reply = self._handle(req)
        self._messaging.send(TopicSession(RPC_TOPIC, 1),
                             serialize(reply).bytes, message.sender)

    def _handle_subscribe(self, req: RpcRequest, sender) -> RpcReply:
        """subscribe_changes(subscription_id, cursor) — register (or renew/
        resume: same id re-subscribing keeps streaming from the given
        cursor, which is how a reconnecting client resumes without loss)."""
        user = self.users.get(req.user)
        if user is None or user.password != req.password:
            return RpcReply(req.request_id, False,
                            error="authentication failed")
        try:
            subscription_id, cursor = req.args
            subscription_id = bytes(subscription_id)
            cursor = int(cursor)
        except Exception:
            return RpcReply(req.request_id, False,
                            error="subscribe_changes(subscription_id, cursor)")
        head = len(self._node.smm.changes)
        # A cursor AHEAD of our head means the client outlived a node
        # restart (the change log reset): snap to head so the stream
        # resumes instead of stalling until the old cursor is re-reached.
        # The client snaps its own cursor from the returned head too.
        self._subscriptions[subscription_id] = [
            sender, min(cursor, head),
            time.monotonic() + self.SUBSCRIPTION_TTL_S]
        return RpcReply(req.request_id, True, value=head)

    def push_pending(self) -> int:
        """Push new change-feed events to every live subscription; called
        by the node run loop each round. Returns frames pushed."""
        if not self._subscriptions:
            return 0
        now = time.monotonic()
        pushed = 0
        for sid in list(self._subscriptions):
            entry = self._subscriptions[sid]
            sender, cursor, expires_at = entry
            if now > expires_at:
                del self._subscriptions[sid]
                continue
            new_cursor, events = self._node.smm.changes.since(cursor)
            if not events:
                continue
            frame = RpcPushEvent(sid, new_cursor, tuple(events))
            self._messaging.send(TopicSession(RPC_TOPIC, 2),
                                 serialize(frame).bytes, sender)
            entry[1] = new_cursor
            pushed += 1
        return pushed

    def _handle(self, req: RpcRequest) -> RpcReply:
        user = self.users.get(req.user)
        if user is None or user.password != req.password:
            return RpcReply(req.request_id, False, error="authentication failed")
        if req.method.startswith("_") or not hasattr(NodeRpcOps, req.method):
            return RpcReply(req.request_id, False,
                            error=f"no such method {req.method!r}")
        if req.method == "start_flow_dynamic" and not user.may_start(
                req.args[0] if req.args else ""):
            return RpcReply(req.request_id, False,
                            error=f"user {req.user!r} may not start "
                                  f"{req.args[0] if req.args else '?'}")
        try:
            value = getattr(self.ops, req.method)(*req.args)
            return RpcReply(req.request_id, True, value=value)
        except Exception as e:
            return RpcReply(req.request_id, False,
                            error=f"{type(e).__name__}: {e}")


class RpcError(Exception):
    pass


class RpcClient:
    """Client proxy (CordaRPCClient.kt:29-60 capability): opens its own
    transport endpoint and round-trips requests to the node's address."""

    def __init__(self, node_address, user: str, password: str,
                 host: str = "127.0.0.1", timeout: float = 15.0):
        from .messaging.tcp import TcpMessaging

        self._node_address = node_address
        self._user, self._password = user, password
        self.timeout = timeout
        self._messaging = TcpMessaging(host, 0).start()
        self._replies: dict[bytes, RpcReply] = {}
        self._decode_errors: list[str] = []
        self._push_callbacks: dict[bytes, Any] = {}
        self._push_cursor: dict[bytes, int] = {}
        # subscription_id -> count of events lost to server-side eviction
        # (the push stream is lossless only within the server's bounded
        # retention window; holes are detected and counted, never silent).
        self.push_gaps: dict[bytes, int] = {}
        self._messaging.add_message_handler(RPC_TOPIC, 1, self._on_reply)
        self._messaging.add_message_handler(RPC_TOPIC, 2, self._on_push)

    def _on_reply(self, message: Message) -> None:
        try:
            reply = deserialize(message.data)
        except Exception as e:
            # The request_id is inside the undecodable payload, so the
            # matching call() cannot be resolved — but it must NOT time out
            # silently: the usual cause is a reply type whose codec
            # registration module was never imported in THIS process, and
            # that is a caller bug worth a loud message.
            self._decode_errors.append(f"{type(e).__name__}: {e}")
            return
        if isinstance(reply, RpcReply):
            self._replies[reply.request_id] = reply

    def submit(self, method: str, *args) -> bytes:
        """Send one request and return its id without waiting: the reply
        arrives while the transport pumps (``call``, ``poll_push``) and
        ``take_reply`` collects it. A load generator starts work on its
        schedule this way, whatever has completed."""
        request_id = os.urandom(12)
        req = RpcRequest(request_id, self._user, self._password, method,
                         tuple(args))
        self._messaging.send(TopicSession(RPC_TOPIC, 0),
                             serialize(req).bytes, self._node_address)
        return request_id

    def take_reply(self, request_id: bytes) -> tuple[bool, Any]:
        """(True, value) once the reply to ``request_id`` has arrived, else
        (False, None); an error reply raises RpcError."""
        reply = self._replies.pop(request_id, None)
        if reply is None:
            return (False, None)
        if not reply.ok:
            raise RpcError(reply.error)
        return (True, reply.value)

    def call(self, method: str, *args):
        # Only decode failures observed DURING this call are attributed to
        # it: a previous call's late undecodable reply must not poison an
        # unrelated method.
        self._decode_errors.clear()
        request_id = self.submit(method, *args)
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            self._messaging.pump(timeout=0.05)
            done, value = self.take_reply(request_id)
            if done:
                return value
        # A decode error seen during the call is most likely OUR reply (a
        # value type whose codec registration module was never imported in
        # this process) — but it could also be a previous call's late
        # arrival, so it must not abort a call whose own reply may still
        # decode; it is attached to the timeout instead of being swallowed.
        msg = f"rpc {method} timed out after {self.timeout}s"
        if self._decode_errors:
            errors, self._decode_errors = self._decode_errors, []
            msg += ("; undecodable replies arrived during the call (is the "
                    "value's codec registration module imported in this "
                    "process?): " + "; ".join(errors))
        raise RpcError(msg)

    # -- push subscriptions -----------------------------------------------

    def _on_push(self, message: Message) -> None:
        try:
            frame = deserialize(message.data)
        except Exception as e:
            self._decode_errors.append(f"{type(e).__name__}: {e}")
            return
        if not isinstance(frame, RpcPushEvent):
            return
        callback = self._push_callbacks.get(frame.subscription_id)
        if callback is None:
            return
        # Frames carry the ABSOLUTE cursor after their events; the
        # at-least-once transport may redeliver, so trim anything at or
        # below our last seen cursor instead of double-delivering.
        last = self._push_cursor.get(frame.subscription_id, 0)
        if frame.cursor <= last:
            return
        start = frame.cursor - len(frame.events)
        if start > last:
            # Events between `last` and `start` were evicted server-side
            # before we caught up (resume is lossless only within the
            # server's bounded retention window). Never silently: count
            # the hole and log it so a monitoring UI can say "feed
            # incomplete" instead of showing stale truth.
            self.push_gaps[frame.subscription_id] = (
                self.push_gaps.get(frame.subscription_id, 0)
                + (start - last))
            import logging

            logging.getLogger("corda_tpu_torch.rpc").warning(
                "push subscription %s lost %d evicted events",
                frame.subscription_id.hex()[:8], start - last)
        events = frame.events[max(0, last - start):]
        self._push_cursor[frame.subscription_id] = frame.cursor
        callback(tuple(events), frame.cursor)

    def subscribe_changes(self, callback, subscription_id: bytes | None = None,
                          cursor: int | None = None) -> bytes:
        """Server-push subscription to the node's state-machine change feed
        (flow add/remove/progress events). `callback(events, cursor)` fires
        during any transport pump (a call() or poll_push()). Re-invoke with
        the SAME id after a reconnect to resume from the last seen cursor —
        lossless within the server's bounded retention window; larger holes
        are detected and counted in `push_gaps`, never skipped silently.
        Re-invoke periodically (< the server's 120 s TTL) to keep the
        subscription alive."""
        sid = subscription_id or os.urandom(12)
        self._push_callbacks[sid] = callback
        if cursor is None:
            cursor = self._push_cursor.get(sid, 0)
        self._push_cursor.setdefault(sid, cursor)
        head = self.call("subscribe_changes", sid, cursor)
        if isinstance(head, int) and head < self._push_cursor[sid]:
            # Our cursor is beyond the server's head: the node restarted
            # and its change log reset. Snap down so the resumed stream's
            # frames are not dropped as duplicates (the server snapped its
            # stored cursor the same way).
            self._push_cursor[sid] = head
        return sid

    def poll_push(self, timeout: float = 0.05) -> None:
        """Give pushed frames a chance to arrive outside of call()s."""
        self._messaging.pump(timeout=timeout)

    # -- convenience wrappers ---------------------------------------------

    def start_flow(self, flow_name: str, *args) -> FlowHandleInfo:
        return self.call("start_flow_dynamic", flow_name, tuple(args))

    def wait_for_flow(self, handle: FlowHandleInfo, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done, value = self.call("flow_result", handle.run_id)
            if done:
                return value
            time.sleep(0.05)
        raise RpcError("flow did not finish in time")

    def close(self) -> None:
        self._messaging.stop()
