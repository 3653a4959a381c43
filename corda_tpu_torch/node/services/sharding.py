"""Sharded notary: StateRef-partitioned uniqueness over N Raft groups.

One Raft group caps committed tx/s no matter how fast the verify plane gets
(ROADMAP item 3). This subsystem partitions the input-state space by
StateRef hash across N independent Raft groups — each group runs the full
PR 2 machinery (group commit, pipelined replication, coalesced frames)
over its own slice of the keyspace, so committed throughput scales with
shard count.

Shard map
---------
``shard_of(ref, n)`` is a pure function of the StateRef alone: the first 8
bytes of the ref's txhash (already uniform — it is a SHA-256 Merkle root)
XOR the output index, mod n. Every party computes it locally; the only
shared datum is the shard COUNT, which rides the netmap as one advertised
service string per shard member (``corda.notary.shard.<g>``), so clients
build the directory from the network map they already have.

Commit protocol
---------------
* Single-shard transaction whose owning group is the local member's group:
  the exact RaftUniquenessProvider path — same PutAllCommand, same group
  commit, same reply protocol. Semantics identical to the unsharded notary.
* Otherwise, a two-phase coordinator drives the owning groups:

    phase 1  ReserveCommand on every touched group, acquired strictly in
             sorted group order (the next group only once the previous
             hold is in hand — lock ordering, so live coordinators
             contending on the same groups serialize instead of
             deadlocking half-holds). Atomic per group: every input free
             (or held/committed by this tx) or none; rejected with a
             final conflict if committed by another tx, bounced BUSY if
             held by another unexpired 2PC.
    phase 2  all reserved -> CommitReservedCommand everywhere;
             any conflict  -> AbortReservedCommand everywhere (best effort)
             and the conflict surfaces to the caller.

  Reservations carry a TTL stamped by the coordinator (issued_at + ttl_s),
  and expiry is judged by comparing OTHER commands' issued_at stamps
  against it — replicas never consult a local clock, so the state machines
  cannot diverge (node/services/raft.py make_apply_command). A coordinator
  that crashes between phases therefore never wedges inputs: its holds
  become steals for any later command stamped past the expiry.

  A retried 2PC for the same tx_id converges: reserve treats
  committed-by-this-tx as success and CommitReserved is idempotent, so
  exactly-once holds across coordinator retries, keyed on tx_id — the same
  invariant the single-group path gets from first-committer-wins.

Cross-group transport rides the existing Raft client channel: the
coordinator sends ClientCommit(command, reply_to=<my member name>) to a
member of the target group, and decisions come back as ClientReply frames
into the local member's ``decided`` mailbox. The member resolves reply
addresses beyond its own peers through the netmap resolver the node
injects (RaftMember.resolve_addr).

Elastic resharding (round 13)
-----------------------------
The shard map is EPOCH'd: service strings carry ``@<epoch>`` past epoch 0
and clients prefer the highest *complete* epoch when building the
directory. A reshard is restricted to a doubling split (N -> 2N) or a
halving merge (2M -> M) because the hash is consistent under exactly those
moves: ``h % N == g`` implies ``h % 2N in {g, g+N}`` and
``h % M == g % M`` — every target group receives keys from exactly ONE
source group, so a single source leader can coordinate each handoff
without cross-source agreement.

The transition is a replicated fence + idempotent state stream
(node/services/raft.py ShardFenceCommand / InstallShardStateCommand):
the source group SEALS (its fence's log position linearizes the handoff
snapshot — moved refs bounce ``WrongShardEpoch`` from that entry on),
streams its moved ``committed_states``/``reserved_states`` rows to the
target group (first frame fences the target ``importing``), ACTIVATES the
target, then activates (or retires) itself — at which point activation
purges the moved rows, so the ledger-side audit (sum of per-group rows)
never double-counts. Every step is replicated and idempotent: a crashed
coordinator is survived by the next leader of the source group re-running
the whole sequence, and streamed reservations keep their original
coordinator-stamped ``expires_at`` so the TTL backstop carries across the
handoff unchanged. Clients that raced the transition get the retryable
``WrongShardEpochException`` and re-derive the directory
(flows/notary.py notarise_with_retry) — a p99 blip, not an outage.

Failure matrix: ARCHITECTURE.md "Elastic resharding (round 13)".

The port's own copy of ``corda_tpu/node/services/sharding.py``, line for
line, over the port's raft.py.
"""

from __future__ import annotations

import os
import time as _time
from typing import Any, Callable, Sequence

from ...crypto.hashes import SecureHash
from ...crypto.party import Party
from ...obs import trace as _obs
from ...qos import context as _qos
from ...serialization.codec import deserialize
from ...testing import faults as _faults
from . import integrity as _integrity
from .api import UniquenessException, UniquenessProvider
from .raft import (
    AbortReservedCommand,
    ClientCommit,
    CommitReservedCommand,
    CommitTimeoutException,
    InstallShardStateCommand,
    PutAllCommand,
    RaftMember,
    RaftUniquenessProvider,
    ReserveCommand,
    ShardFenceCommand,
    WrongShardEpochException,
)

__all__ = [  # re-exports: the fence exception is raised here and in raft
    "SHARD_SERVICE_PREFIX", "RESHARD_PLAN_PREFIX", "RESHARD_PLAN_ENTRY",
    "shard_of", "split_by_shard", "shard_service_string",
    "parse_shard_service", "parse_shard_service_full",
    "reshard_plan_string", "parse_reshard_plan", "publish_reshard_plan",
    "ShardedUniquenessProvider", "WrongShardEpochException",
]

# Netmap service-string prefix: member of shard group g advertises
# f"{SHARD_SERVICE_PREFIX}{g}of{count}" so clients recover both the group
# id and the total shard count from the directory they already sync.
# Past epoch 0 the string carries "@<epoch>" so a directory mixing old and
# new advertisements is disambiguated by epoch, not by count alone.
SHARD_SERVICE_PREFIX = "corda.notary.shard."

# Reshard plans ride the SAME network map, as one service string on a
# control pseudo-entry (name RESHARD_PLAN_ENTRY). Node.refresh_netmap
# skips "_"-prefixed entries when building the party directory and parses
# the plan out of them instead — no new channel, no new watcher.
RESHARD_PLAN_PREFIX = "corda.notary.reshard."
RESHARD_PLAN_ENTRY = "_reshard"


def shard_of(ref, count: int) -> int:
    """Owning group of a StateRef — a pure function every party computes
    identically from the ref alone (txhash is a SHA-256 Merkle root, so the
    leading 8 bytes are already uniform; XOR the index so the outputs of
    one transaction spread instead of clustering on one group)."""
    if count <= 1:
        return 0
    return (int.from_bytes(ref.txhash.bytes[:8], "big") ^ ref.index) % count


def split_by_shard(refs, count: int) -> dict[int, tuple]:
    """Group refs by owning shard, preserving order within each group."""
    by_group: dict[int, list] = {}
    for ref in refs:
        by_group.setdefault(shard_of(ref, count), []).append(ref)
    return {g: tuple(v) for g, v in by_group.items()}


def shard_service_string(group: int, count: int, epoch: int = 0) -> str:
    """Advertised service string for a group. Epoch 0 (the boot map) keeps
    the original bare format so pre-reshard directories stay byte-stable;
    later epochs append ``@<epoch>``."""
    base = f"{SHARD_SERVICE_PREFIX}{group}of{count}"
    return base if epoch <= 0 else f"{base}@{epoch}"


def parse_shard_service(service: str) -> tuple[int, int] | None:
    """(group, count) from an advertised service string, else None."""
    full = parse_shard_service_full(service)
    return None if full is None else full[:2]


def parse_shard_service_full(service: str) -> tuple[int, int, int] | None:
    """(group, count, epoch) from an advertised service string, else None.
    A bare (pre-reshard) string parses as epoch 0."""
    if not service.startswith(SHARD_SERVICE_PREFIX):
        return None
    tail = service[len(SHARD_SERVICE_PREFIX):]
    tail, _, epoch_s = tail.partition("@")
    group_s, _, count_s = tail.partition("of")
    try:
        group, count = int(group_s), int(count_s)
        epoch = int(epoch_s) if epoch_s else 0
    except ValueError:
        return None
    if count <= 0 or epoch < 0 or not 0 <= group < count:
        return None
    return group, count, epoch


def reshard_plan_string(epoch: int, from_count: int, to_count: int) -> str:
    return f"{RESHARD_PLAN_PREFIX}{epoch}:{from_count}to{to_count}"


def parse_reshard_plan(service: str) -> tuple[int, int, int] | None:
    """(epoch, from_count, to_count) from a plan service string, else None.
    Only shape-valid plans parse: a doubling split or a halving merge with
    a positive epoch (epoch 0 is the boot map and can never be a target)."""
    if not service.startswith(RESHARD_PLAN_PREFIX):
        return None
    tail = service[len(RESHARD_PLAN_PREFIX):]
    epoch_s, _, counts = tail.partition(":")
    from_s, _, to_s = counts.partition("to")
    try:
        epoch, from_count, to_count = int(epoch_s), int(from_s), int(to_s)
    except ValueError:
        return None
    if epoch <= 0 or from_count <= 0 or to_count <= 0:
        return None
    if to_count != 2 * from_count and from_count != 2 * to_count:
        return None  # only doubling splits / halving merges are consistent
    return epoch, from_count, to_count


def publish_reshard_plan(network_map: str, epoch: int, from_count: int,
                         to_count: int, owning_key) -> None:
    """Publish (or supersede) the reshard plan through the network map.
    The plan is one service string on a control pseudo-entry — every node
    picks it up on its ordinary netmap refresh cadence; the affected source
    group leaders start the handoff, everyone else just learns the epoch."""
    plan = reshard_plan_string(epoch, from_count, to_count)
    if parse_reshard_plan(plan) is None:
        raise ValueError(
            f"invalid reshard plan: epoch={epoch} {from_count}->{to_count} "
            f"(only doubling splits / halving merges; epoch must be > 0)")
    from ..config import netmap_register
    netmap_register(network_map, RESHARD_PLAN_ENTRY, "0.0.0.0", 0,
                    owning_key, (plan,))


class ShardedUniquenessProvider(UniquenessProvider):
    """RaftUniquenessProvider-compatible facade over N Raft groups.

    The local member belongs to exactly ONE group (its raft_cluster); this
    provider routes single-shard traffic for that group straight through
    the plain provider and coordinates the two-phase protocol for
    everything else. Poll-driven like commit_async everywhere else in the
    framework: the returned callable is parked on a ServiceRequest and the
    node's run loop drives it, so the notary flow never blocks the message
    pump that consensus (and the cross-group channel) rides on.
    """

    RESUBMIT_EVERY = 0.5  # sec; matches RaftUniquenessProvider pacing

    def __init__(self, member: RaftMember, pump: Callable[[], None],
                 shards, timeout: float = 25.0):
        self.member = member
        self._pump = pump
        self.timeout = timeout
        self._local = RaftUniquenessProvider(member, pump, timeout)
        self.count = int(shards.count)
        self.epoch = 0
        self.groups = tuple(tuple(g) for g in shards.groups)
        self.ttl_s = float(shards.reserve_ttl_s)
        # The groups list may be LONGER than count: groups >= count are
        # PENDING split targets, booted and electable but owning no keys
        # until a reshard epoch activates them.
        self.my_group = next(
            (i for i, g in enumerate(self.groups) if member.name in g), None)
        # At most one live handoff this member coordinates (source leader).
        self._reshard: dict | None = None
        # Replay a persisted fence (restart mid- or post-reshard): the
        # routing count/epoch must match what the group's state machine
        # already enforces, or every local fast-path commit would bounce.
        fence = self._read_fence()
        if fence is not None and fence.get("mode") in ("active", "retired"):
            self.count = int(fence["count"])
            self.epoch = int(fence["epoch"])
        # Per-group preferred target member for the cross-group channel:
        # starts at the group's first member, follows leader hints from
        # bounce replies (satellite-1 semantics: hints are PER GROUP — a
        # deposed leader's hint from group 0 never redirects group 1).
        self._targets: dict[int, str] = {
            g: members[0] for g, members in enumerate(self.groups) if members}
        self.metrics = {
            "single_shard": 0,    # fast-path commits routed locally
            "cross_shard": 0,     # two-phase coordinations started
            "remote_single": 0,   # single-group txs owned by another group
            "aborts_sent": 0,     # phase-1 failures unwound
            "reserve_retries": 0,  # busy/leaderless resubmissions, phase 1
            "wrong_epoch": 0,     # fence bounces surfaced to callers
            "handoff_frames": 0,  # InstallShardState frames acked (as src)
            "resharded": 0,       # handoffs this member coordinated to done
        }

    # -- commit ------------------------------------------------------------

    def commit_async(self, states: Sequence, tx_id: SecureHash,
                     caller_identity: Party) -> Callable[[], bool | None]:
        refs = tuple(states)
        by_group = split_by_shard(refs, self.count)
        touched = set(by_group)
        if not touched or touched == {self.my_group}:
            # Fast path: everything this member's own group owns — the
            # exact unsharded protocol, byte-identical commands. Only the
            # wrong_epoch accounting wraps it: a reshard fence can bounce
            # the local group too, and the bench counts every bounce.
            self.metrics["single_shard"] += 1
            inner = self._local.commit_async(refs, tx_id, caller_identity)

            def poll():
                try:
                    return inner()
                except WrongShardEpochException:
                    self.metrics["wrong_epoch"] += 1
                    raise

            return poll
        if len(touched) == 1:
            # Single foreign group: no atomicity to coordinate — one remote
            # PutAll through the cross-group channel (a 2PC would add a
            # round trip for nothing).
            self.metrics["remote_single"] += 1
            return self._remote_put_poll(next(iter(touched)),
                                         refs, tx_id, caller_identity)
        self.metrics["cross_shard"] += 1
        return self._two_phase_poll(by_group, tx_id, caller_identity)

    def commit(self, states: Sequence, tx_id: SecureHash,
               caller_identity: Party) -> None:
        poll = self.commit_async(states, tx_id, caller_identity)
        while True:
            outcome = poll()
            if outcome is not None:
                return
            self._pump()

    # -- op plumbing -------------------------------------------------------

    def _new_op(self, group: int) -> dict:
        return {"group": group, "rid": os.urandom(16), "submitted_at": 0.0,
                "done": False, "conflict": None, "wrong_epoch": False}

    def _dispatch(self, op: dict, command) -> None:
        """Send one command toward its owning group: local group submits to
        the local member (the ordinary follower-forwarding path applies);
        remote groups get a ClientCommit frame addressed to the tracked
        target member, replies landing in the local member's mailbox."""
        if op["group"] == self.my_group:
            self.member.submit(command)
            return
        target = self._targets.get(op["group"])
        addr = self.member._peer_addr(target)
        if addr is None:
            # Target not resolvable yet (netmap lag): leave submitted_at so
            # the pacing loop retries; the periodic netmap refresh fills
            # the resolver.
            return
        self.member._send(addr, ClientCommit(command, self.member.name))

    def _poll_op(self, op: dict, make_command, now: float) -> None:
        """Advance one outstanding command: consume a decision if present,
        otherwise (re)submit on the RESUBMIT_EVERY pace with a fresh
        issued_at stamp (same rid — idempotent through leader changes and
        deterministic against reservation expiry)."""
        if op["done"] or op["conflict"] is not None or op["wrong_epoch"]:
            return
        reply = self.member.decided.pop(op["rid"], None)
        if reply is not None:
            if reply.ok:
                op["done"] = True
                return
            if reply.conflict is not None:
                op["conflict"] = reply.conflict
                return
            if reply.wrong_epoch:
                # Reshard fence bounce: resubmitting to this group can
                # never succeed — flag it and stop the pacing loop; the
                # poll machine surfaces WrongShardEpochException.
                op["wrong_epoch"] = True
                return
            # Busy hold or leaderless bounce: follow the hint WITHIN this
            # group only, and let the pacing below resubmit.
            hint = reply.leader_hint
            if hint and hint in self.groups[op["group"]]:
                self._targets[op["group"]] = hint
            op["retries"] = op.get("retries", 0) + 1
        if (op["submitted_at"] == 0.0
                or now - op["submitted_at"] >= self.RESUBMIT_EVERY):
            self._dispatch(op, make_command(op))
            op["submitted_at"] = now

    def _send_aborts(self, by_group: dict[int, tuple], tx_id) -> None:
        """Best-effort unwind: one AbortReservedCommand per touched group.
        Fire-and-forget — a lost abort is exactly the crashed-coordinator
        case, and the reservation TTL releases the holds deterministically."""
        self.metrics["aborts_sent"] += 1
        for group, refs in by_group.items():
            op = self._new_op(group)
            self._dispatch(op, AbortReservedCommand(refs, tx_id,
                                                    op["rid"]))

    # -- poll machines -----------------------------------------------------

    def _remote_put_poll(self, group: int, refs, tx_id, caller):
        op = self._new_op(group)
        deadline = _time.monotonic() + self.timeout
        ctx = _obs.get_context() if _obs.ACTIVE is not None else None
        if ctx is not None:
            _obs.register_link(op["rid"], ctx[0], ctx[1])
            t0 = _obs.now()
        qctx = _qos.get_context() if _qos.ACTIVE is not None else None
        if qctx is not None:
            # QoS link beside the trace link: the owning group's leader
            # sees the lane/deadline when deciding whether to seal early.
            _qos.ACTIVE.register_link(op["rid"], qctx)

        def make_command(op):
            return PutAllCommand(
                refs, tx_id, caller, op["rid"],
                # lint: allow(no-wallclock-in-apply) coordinator stamping site: clock read once, carried in the command, applied identically by every replica
                issued_at=_time.time())

        def poll():
            now = _time.monotonic()
            self._poll_op(op, make_command, now)
            if op["conflict"] is not None:
                raise UniquenessException(op["conflict"])
            if op["wrong_epoch"]:
                self.metrics["wrong_epoch"] += 1
                if ctx is not None and _obs.ACTIVE is not None:
                    _obs.pop_link(op["rid"])
                if qctx is not None and _qos.ACTIVE is not None:
                    _qos.ACTIVE.pop_link(op["rid"])
                raise WrongShardEpochException(
                    f"group {group} fenced off {tx_id} (reshard in "
                    f"progress; re-derive the shard directory)")
            if op["done"]:
                if ctx is not None and _obs.ACTIVE is not None:
                    _obs.record("raft_commit", t0, _obs.now(),
                                trace_id=ctx[0], parent=ctx[1],
                                attrs={"ok": True, "remote_group": group})
                    _obs.pop_link(op["rid"])
                if qctx is not None and _qos.ACTIVE is not None:
                    _qos.ACTIVE.pop_link(op["rid"])
                return True
            if now >= deadline:
                raise CommitTimeoutException(
                    f"remote shard {group} did not decide {tx_id} within "
                    f"{self.timeout}s (target: {self._targets.get(group)})")
            return None

        return poll

    def _two_phase_poll(self, by_group: dict[int, tuple], tx_id, caller):
        groups = sorted(by_group)
        deadline = _time.monotonic() + self.timeout
        ctx = _obs.get_context() if _obs.ACTIVE is not None else None
        state = {
            "phase": "reserve",
            "ops": {g: self._new_op(g) for g in groups},
            "t_phase": _obs.now() if ctx is not None else 0.0,
        }
        if ctx is not None:
            for op in state["ops"].values():
                _obs.register_link(op["rid"], ctx[0], ctx[1])
        qctx = _qos.get_context() if _qos.ACTIVE is not None else None
        if qctx is not None:
            for op in state["ops"].values():
                _qos.ACTIVE.register_link(op["rid"], qctx)

        def reserve_command(op):
            return ReserveCommand(
                by_group[op["group"]], tx_id, caller, op["rid"],
                # lint: allow(no-wallclock-in-apply) coordinator stamping site: the TTL baseline rides the command; replicas compare stamps, never their own clocks
                issued_at=_time.time(), ttl_s=self.ttl_s)

        def commit_command(op):
            return CommitReservedCommand(by_group[op["group"]], tx_id,
                                         caller, op["rid"])

        def _record_phase(name: str) -> None:
            if ctx is not None and _obs.ACTIVE is not None:
                _obs.record(name, state["t_phase"], _obs.now(),
                            trace_id=ctx[0], parent=ctx[1],
                            attrs={"groups": len(groups)})
                state["t_phase"] = _obs.now()

        def poll():
            now = _time.monotonic()
            make = (reserve_command if state["phase"] == "reserve"
                    else commit_command)
            if state["phase"] == "reserve":
                # ORDERED acquisition: groups reserve strictly in sorted
                # order, the next group only after the previous hold is in
                # hand. Two live coordinators contending on the same groups
                # therefore serialize at the lowest contended group instead
                # of deadlocking half-holds against each other until both
                # TTL-steal simultaneously (a partial-commit window). Costs
                # one group RTT per extra group in phase 1; the TTL remains
                # the backstop for CRASHED coordinators only.
                for g in groups:
                    op = state["ops"][g]
                    before = op.get("retries", 0)
                    self._poll_op(op, make, now)
                    self.metrics["reserve_retries"] += (
                        op.get("retries", 0) - before)
                    if not op["done"] and op["conflict"] is None:
                        break
            else:
                for op in state["ops"].values():
                    self._poll_op(op, make, now)
            conflict = next((op["conflict"]
                             for op in state["ops"].values()
                             if op["conflict"] is not None), None)
            if conflict is not None:
                if state["phase"] == "reserve":
                    # Some input is finally spent elsewhere: release every
                    # hold this attempt may have taken, then surface the
                    # conflict (final — the client sees a double-spend).
                    self._send_aborts(by_group, tx_id)
                _record_phase("shard_reserve" if state["phase"] == "reserve"
                              else "shard_commit")
                raise UniquenessException(conflict)
            if any(op["wrong_epoch"] for op in state["ops"].values()):
                # A touched group resharded under this coordination. The
                # whole 2PC must re-route: release what phase 1 took (best
                # effort — an abort a sealed group bounces is covered by
                # the streamed reservation + TTL backstop) and surface the
                # retryable epoch error. A retry of the same tx_id at the
                # new directory CONVERGES: reserve treats held-by-this-tx
                # (including holds streamed during the handoff) as success
                # and commit-reserved is idempotent.
                if state["phase"] == "reserve":
                    self._send_aborts(by_group, tx_id)
                self.metrics["wrong_epoch"] += 1
                _record_phase("shard_reserve" if state["phase"] == "reserve"
                              else "shard_commit")
                raise WrongShardEpochException(
                    f"cross-shard {state['phase']} of {tx_id} bounced off "
                    f"a reshard fence; re-derive the shard directory")
            if all(op["done"] for op in state["ops"].values()):
                if state["phase"] == "reserve":
                    _record_phase("shard_reserve")
                    state["phase"] = "commit"
                    state["ops"] = {g: self._new_op(g) for g in groups}
                    if ctx is not None:
                        for op in state["ops"].values():
                            _obs.register_link(op["rid"], ctx[0], ctx[1])
                    if qctx is not None and _qos.ACTIVE is not None:
                        for op in state["ops"].values():
                            _qos.ACTIVE.register_link(op["rid"], qctx)
                    return None
                _record_phase("shard_commit")
                return True
            if now >= deadline:
                if state["phase"] == "reserve":
                    # Could not assemble the full reservation set in time:
                    # unwind (best effort; TTL is the deterministic
                    # backstop) and report retryable unavailability.
                    self._send_aborts(by_group, tx_id)
                # Phase 2 deadline: do NOT abort — some groups may already
                # have committed, and a retry of the same tx_id converges to
                # the full commit (reserve/commit are idempotent per tx).
                raise CommitTimeoutException(
                    f"cross-shard {state['phase']} of {tx_id} over groups "
                    f"{groups} not decided within {self.timeout}s")
            return None

        return poll

    # -- elastic resharding ------------------------------------------------

    def _read_fence(self) -> dict | None:
        """The group's APPLIED fence state (what its replicated state
        machine currently enforces), from the member's settings table."""
        import json
        raw = self.member.db.get_setting("shard_fence")
        return json.loads(raw) if raw else None

    def reconfigure(self, count: int, epoch: int) -> None:
        """Adopt a new shard-map epoch for ROUTING. Monotonic: an older or
        equal epoch is a no-op (directory races must never roll the router
        back). Correctness never depends on this — fences enforce; a stale
        router just buys bounces and retries."""
        if int(epoch) <= self.epoch:
            return
        self.count = int(count)
        self.epoch = int(epoch)

    def _reshard_role(self, from_count: int, to_count: int
                      ) -> tuple[int, int] | None:
        """(source_group, target_group) if this member's group hands state
        off under the plan, else None. Split g -> {g, g+N}: sources are the
        first N groups, targets the pending upper half. Merge: sources are
        the retiring upper half, each folding into group g - M."""
        g = self.my_group
        if g is None:
            return None
        if to_count == 2 * from_count and g < from_count:
            return g, g + from_count
        if from_count == 2 * to_count and to_count <= g < from_count:
            return g, g - to_count
        return None

    def _handoff_frames(self, target: int, to_count: int,
                        rows_per_frame: int = 256) -> list:
        """Snapshot the moved slice of this group's ledger, chunked for the
        client channel. Read AFTER the seal is applied locally: the seal's
        log position linearizes the snapshot — nothing can commit or
        reserve a moved ref behind it, so the read is complete. Always at
        least one (possibly empty) frame: the first frame is also what
        fences the target ``importing``."""
        db = self.member.db
        with db.lock:
            crows = db.conn.execute(
                "SELECT state_ref, consuming, crc FROM committed_states"
            ).fetchall()
            rrows = db.conn.execute(
                "SELECT state_ref, tx_id, expires_at, crc "
                "FROM reserved_states"
            ).fetchall()
        # Handoff doubles as an integrity sweep: every row leaving this
        # group is CRC-verified in passing. Detection only — the row still
        # streams (dropping a spent-input record would un-spend it on the
        # target, which is worse than forwarding a flagged one); repair is
        # the scrubber/fsck's job, and the counter makes the damage visible.
        for row in crows:
            if row[2] is not None and _integrity.committed_crc(
                    bytes(row[0]), bytes(row[1])) != int(row[2]):
                self.member.metrics["integrity_errors"] += 1
        for row in rrows:
            if row[3] is not None and _integrity.reserved_crc(
                    bytes(row[0]), bytes(row[1]),
                    float(row[2])) != int(row[3]):
                self.member.metrics["integrity_errors"] += 1
        moved_c = [(bytes(b), bytes(c)) for b, c, _crc in crows
                   if shard_of(deserialize(bytes(b)), to_count) == target]
        moved_r = [(bytes(b), bytes(t), float(e)) for b, t, e, _crc in rrows
                   if shard_of(deserialize(bytes(b)), to_count) == target]
        frames, i = [], 0
        while i < max(len(moved_c), len(moved_r)) or not frames:
            frames.append((tuple(moved_c[i:i + rows_per_frame]),
                           tuple(moved_r[i:i + rows_per_frame])))
            i += rows_per_frame
        return frames

    def reshard_tick(self, plan: tuple[int, int, int] | None,
                     now: float) -> None:
        """Advance (at most) one live handoff this member coordinates.
        Called every run-loop round by the node — non-blocking, one
        outstanding command at a time, paced by _poll_op.

        Only the CURRENT LEADER of a source group drives; followers and
        deposed leaders drop their local progress dict, because every step
        is replicated + idempotent and a new leader simply re-runs the
        whole seal -> stream -> activate-target -> activate-self sequence
        from its own applied state. Crash-mid-handoff (the
        ``shard.handoff`` fault point) is therefore survived by the next
        election, and streamed reservations keep their original
        expires_at, so a coordinator that dies forever still releases its
        holds by TTL."""
        if self.member.role != "leader":
            self._reshard = None
            return
        st = self._reshard
        if st is None:
            if plan is None:
                return
            epoch, from_count, to_count = plan
            if epoch <= self.epoch:
                return  # already adopted (or superseded): nothing to do
            fence = self._read_fence()
            if fence is not None and int(fence.get("epoch", 0)) >= epoch \
                    and fence.get("mode") in ("active", "retired"):
                # Applied state says the handoff finished (e.g. this member
                # just won an election after the old coordinator completed
                # everything but its own routing bump).
                self.reconfigure(int(fence["count"]), int(fence["epoch"]))
                return
            role = self._reshard_role(from_count, to_count)
            if role is None:
                return  # not a source group: fences/netmap carry the news
            src, target = role
            st = self._reshard = {
                "epoch": epoch, "from": from_count, "to": to_count,
                "src": src, "target": target, "stage": "seal",
                "op": None, "frames": None, "frame_idx": 0,
                "t0": _obs.now() if _obs.ACTIVE is not None else 0.0,
            }
        e, fc, tc = st["epoch"], st["from"], st["to"]
        if st["stage"] == "seal":
            if st["op"] is None:
                st["op"] = self._new_op(st["src"])
            self._poll_op(
                st["op"],
                lambda op: ShardFenceCommand(st["src"], fc, tc, e, "seal",
                                             op["rid"]),
                now)
            if st["op"]["done"]:
                st["stage"], st["op"] = "stream", None
            return
        if st["stage"] == "stream":
            if st["frames"] is None:
                st["frames"] = self._handoff_frames(st["target"], tc)
            if st["frame_idx"] >= len(st["frames"]):
                st["stage"], st["op"] = "activate_target", None
                return
            if st["op"] is None:
                st["op"] = self._new_op(st["target"])
                # Chaos hook, fired once per streamed frame: drop models a
                # lost frame (first send deferred one pacing interval —
                # the idempotent resubmit recovers), stall a slow link,
                # crash the coordinator-death-mid-handoff case.
                if _faults.ACTIVE is not None:
                    act = _faults.ACTIVE.fire("shard.handoff")
                    if act is not None:
                        action, delay_s = act
                        if action == "drop":
                            st["op"]["submitted_at"] = now
                        elif delay_s > 0.0:
                            _time.sleep(delay_s)
            committed, reserved = st["frames"][st["frame_idx"]]
            self._poll_op(
                st["op"],
                lambda op: InstallShardStateCommand(
                    committed, reserved, st["target"], fc, tc, e,
                    op["rid"]),
                now)
            if st["op"]["done"]:
                self.metrics["handoff_frames"] += 1
                st["frame_idx"] += 1
                st["op"] = None
            return
        if st["stage"] == "activate_target":
            if st["op"] is None:
                st["op"] = self._new_op(st["target"])
            self._poll_op(
                st["op"],
                lambda op: ShardFenceCommand(st["target"], fc, tc, e,
                                             "activate", op["rid"]),
                now)
            if st["op"]["done"]:
                st["stage"], st["op"] = "activate_self", None
            return
        if st["stage"] == "activate_self":
            # Target is durably active first: from here the moved rows
            # exist on the target's quorum, so purging them at our own
            # activation (raft.py _apply_fence) cannot lose state.
            if st["op"] is None:
                st["op"] = self._new_op(st["src"])
            self._poll_op(
                st["op"],
                lambda op: ShardFenceCommand(st["src"], fc, tc, e,
                                             "activate", op["rid"]),
                now)
            if st["op"]["done"]:
                if _obs.ACTIVE is not None:
                    _obs.record("shard_handoff", st["t0"], _obs.now(),
                                attrs={"epoch": e, "from": fc, "to": tc,
                                       "src": st["src"],
                                       "target": st["target"],
                                       "frames": len(st["frames"] or ())})
                self.metrics["resharded"] += 1
                self._reshard = None
                self.reconfigure(tc, e)

    # -- introspection -----------------------------------------------------

    @property
    def committed_count(self) -> int:
        (n,) = self.member.db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        return n

    def leader_hint(self) -> str | None:
        """The LOCAL group's believed leader (NotaryUnavailable replies are
        answered by a member of one group; its hint must only ever redirect
        clients within that group — flows/notary.py keys hints per group)."""
        return self.member.leader_name

    def stamp(self) -> dict:
        m = self.metrics
        return {
            "shards": self.count,
            "epoch": self.epoch,
            "my_group": self.my_group,
            "single_shard": m["single_shard"],
            "remote_single": m["remote_single"],
            "cross_shard": m["cross_shard"],
            "aborts_sent": m["aborts_sent"],
            "reserve_retries": m["reserve_retries"],
            "wrong_epoch": m["wrong_epoch"],
            "handoff_frames": m["handoff_frames"],
            "resharded": m["resharded"],
        }
