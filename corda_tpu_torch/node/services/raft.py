"""Raft-replicated uniqueness provider — the distributed notary commit log.

Capability match for the reference's Raft tier (reference:
node/src/main/kotlin/net/corda/node/services/transactions/
RaftUniquenessProvider.kt:44-115 and DistributedImmutableMap.kt:24-106, built
on Copycat/Atomix): a cluster of notary nodes replicates a first-committer-
wins input map through leader-based consensus, so notarisation survives the
loss of a minority of cluster members.

Design (idiomatic to this framework, not a Copycat port):
  * consensus state machine implements the Raft paper's core: randomized
    election timeouts, RequestVote/AppendEntries over the node's existing
    MessagingService (TCP in production, the in-memory fake in tests — the
    reference runs its own Netty transport; ours rides the one transport);
  * the replicated command is PutAll{refs -> ConsumingTx}; apply = the same
    first-committer-wins check/insert as PersistentUniquenessProvider, so
    conflict detection is byte-identical to the single-node path;
  * log + term/votedFor persist in the NodeDatabase (raft_log/raft_meta
    tables) — a restarted member rejoins with its log intact;
  * RaftUniquenessProvider.commit() submits to the local member; a follower
    forwards to the leader. While waiting it pumps the node's messaging so
    consensus traffic flows — SMM flow dispatch is re-entrancy-guarded, so
    session messages queue up and run after the flow step completes.

Commit pipeline (ARCHITECTURE.md "Commit pipeline"): the leader merges a
round's submissions into ONE PutAllBatch log entry (group commit, per-
request conflict isolation at apply), replication streams pre-encoded entry
blobs through per-peer in-flight windows (pipelined nextIndex — a tail goes
out once, in bounded chunks), and decisions coalesce into multi-outcome
ClientReplyBatch frames. RaftConfig(group_commit=False) restores the
one-command-per-entry path.

Timing is injected (clock callable) so tests can drive elections
deterministically fast.

The port's own copy of ``corda_tpu/node/services/raft.py``, line for line:
no JAX is in it, but the port imports nothing of the JAX package. The codec
strips the package prefix from wire names, so its commands, frames and log
blobs are byte-identical to the JAX package's and members of either
package can share one cluster.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import random
import sqlite3
import threading
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from ...crypto.hashes import SecureHash
from ...crypto.party import Party
from ...obs import telemetry as _tm
from ...obs import trace as _obs
from ...qos import context as _qos
from ...serialization.codec import deserialize, register, serialize
from ...testing import faults as _faults
from . import integrity as _integrity
from ..messaging.api import MessagingService, TopicSession
from .api import (
    ConsumingTx,
    UniquenessConflict,
    UniquenessException,
    UniquenessProvider,
    UniquenessUnavailableException,
)

RAFT_TOPIC = "platform.raft"

_RAFT_SCHEMA = """
CREATE TABLE IF NOT EXISTS raft_log (
    idx  INTEGER PRIMARY KEY,
    term INTEGER NOT NULL,
    blob BLOB NOT NULL,
    crc  INTEGER
);
CREATE TABLE IF NOT EXISTS raft_meta (
    singleton INTEGER PRIMARY KEY CHECK (singleton = 1),
    term      INTEGER NOT NULL,
    voted_for TEXT
);
CREATE TABLE IF NOT EXISTS reserved_states (
    state_ref  BLOB PRIMARY KEY,
    tx_id      BLOB NOT NULL,
    expires_at REAL NOT NULL,
    crc        INTEGER
);
"""


# -- wire messages ----------------------------------------------------------


@register
@dataclass(frozen=True)
class PutAllCommand:
    """The replicated command: claim `refs` for tx_id (DistributedImmutableMap
    putAll capability)."""

    refs: tuple
    tx_id: SecureHash
    caller: Party
    request_id: bytes  # correlates the client's reply
    # Coordinator wall-clock stamp (epoch seconds), carried IN the command so
    # every replica evaluates reservation expiry against the same value — the
    # state machine never reads a local clock (replicas would diverge). A
    # reservation with expires_at=E blocks a different-tx command iff its
    # issued_at < E; issued_at >= E is a deterministic steal. Re-stamped on
    # every resubmission (same request_id), so a command parked behind a
    # crashed coordinator's reservation gets through once the TTL passes.
    issued_at: float = 0.0


@register
@dataclass(frozen=True)
class ReserveCommand:
    """Phase 1 of the cross-shard two-phase commit (services/sharding.py):
    claim a REVOCABLE hold on `refs` for tx_id. Applies atomically — every
    ref free (or held/committed by the same tx) or none. Outcomes: ok
    (reserved), conflict (some ref committed by another tx — final), or BUSY
    (some ref reserved by another unexpired tx — retryable bounce). The hold
    expires at issued_at + ttl_s, so a coordinator that dies between phases
    never wedges inputs: expiry is decided from command-carried stamps, not
    replica clocks (see PutAllCommand.issued_at)."""

    refs: tuple
    tx_id: SecureHash
    caller: Party
    request_id: bytes
    issued_at: float
    ttl_s: float


@register
@dataclass(frozen=True)
class CommitReservedCommand:
    """Phase 2 commit: promote tx_id's reservations on `refs` to durable
    committed_states rows. Idempotent (already-committed-by-this-tx is ok);
    conflicts only if another tx committed a ref first — a reservation lost
    to TTL expiry does NOT block the commit, which is what guarantees phase
    2 terminates (the steal window is documented in ARCHITECTURE.md)."""

    refs: tuple
    tx_id: SecureHash
    caller: Party
    request_id: bytes


@register
@dataclass(frozen=True)
class AbortReservedCommand:
    """Phase 2 abort: release tx_id's own reservations on `refs`. Always
    succeeds (releasing nothing is fine) — abort must never add a failure
    mode to a 2PC already unwinding."""

    refs: tuple
    tx_id: SecureHash
    request_id: bytes


@register
@dataclass(frozen=True)
class ShardFenceCommand:
    """Elastic-reshard fence (services/sharding.py): a replicated marker
    that moves THIS group's shard-ownership state machine through the
    split/merge handoff. ``mode="seal"`` freezes the moving keyspace — from
    this log position on, any command touching a ref that epoch `epoch`
    assigns elsewhere bounces with the retryable WRONG_EPOCH outcome, while
    refs the group keeps commit normally (no outage for the unmoved
    keyspace). The seal's log position IS the linearization point of the
    handoff snapshot: everything applied before it is in the streamed
    ranges, everything after it bounces. ``mode="activate"`` installs the
    new epoch as current (count = to_count); a group whose index falls
    outside to_count becomes "retired" and bounces everything forever.
    Idempotent and never-downgrading within an epoch, so coordinator
    retries and full log replays converge. Deterministic: ownership is
    decided from the command's own fields + the ref hash — never a clock."""

    group: int  # this group's index in the shard map
    from_count: int  # group count of the epoch being left
    to_count: int  # group count of the epoch being entered
    epoch: int  # the shard-map epoch this fence installs
    mode: str  # "seal" | "activate"
    request_id: bytes
    issued_at: float = 0.0


@register
@dataclass(frozen=True)
class InstallShardStateCommand:
    """Elastic-reshard state handoff frame: one chunk of the source group's
    sealed `committed_states` / `reserved_states` ranges, replicated into
    the TARGET group's log. Rows are the exact source blobs (the same
    (state_ref, consuming) / (state_ref, tx_id, expires_at) shapes
    InstallSnapshot already ships), applied INSERT OR IGNORE so coordinator
    retries and log replays are idempotent. The first frame fences the
    target as "importing" (all traffic bounces WRONG_EPOCH until the
    coordinator activates it) — a new-epoch client that races ahead of the
    cutover retries instead of committing against a half-installed ledger.
    Reservation rows carry their original coordinator-stamped expires_at,
    so a 2PC hold orphaned by a crashed handoff coordinator still releases
    by TTL on the new owner (replicas never read clocks)."""

    committed_rows: tuple  # ((state_ref_blob, consuming_blob), ...)
    reserved_rows: tuple  # ((state_ref_blob, tx_id_bytes, expires_at), ...)
    group: int  # the TARGET group's index at to_count
    from_count: int
    to_count: int
    epoch: int
    request_id: bytes
    issued_at: float = 0.0


@register
@dataclass(frozen=True)
class PutAllBatch:
    """Group commit: every PutAllCommand a leader's scheduling round
    coalesced, replicated as ONE log entry — one log append/fsync, one
    AppendEntries slot, one apply pass for the burst. Conflict isolation is
    per inner command: apply runs each PutAllCommand through the same
    first-committer-wins check independently, so one double-spend yields
    its own ClientReply(ok=False, conflict=...) without poisoning batch
    siblings."""

    commands: tuple  # (PutAllCommand, ...)


@register
@dataclass(frozen=True)
class RequestVote:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@register
@dataclass(frozen=True)
class VoteReply:
    term: int
    granted: bool
    voter: str


@register
@dataclass(frozen=True)
class PreVote:
    """Pre-vote canvass (partition plane, round 20; Raft §9.6 / Ongaro's
    thesis §9.6): a would-be candidate asks "would you vote for me at
    ``term``?" WITHOUT incrementing or persisting anything on either side.
    ``term`` is the term the canvasser WOULD campaign at (current + 1).
    A rejoining minority member therefore cannot inflate the cluster term
    and depose a healthy leader just by having sat behind a cut: it first
    has to win a canvass, which a quorum with a live leader refuses. Only
    sent when ``[raft] prevote = true`` — a cluster with the flag off
    never puts this frame on the wire."""

    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@register
@dataclass(frozen=True)
class PreVoteReply:
    """Canvass answer. ``term`` is the REPLIER's current term (so a
    canvasser behind on terms catches up without a disruptive election);
    ``granted`` means "your log is current AND I have not heard from a
    live leader within the minimum election window". Never persisted."""

    term: int
    granted: bool
    voter: str


@register
@dataclass(frozen=True)
class AppendEntries:
    term: int
    leader: str
    prev_index: int
    prev_term: int
    # ((term, blob), ...): blob is the PRE-ENCODED command (the exact bytes
    # stored in raft_log). The leader serializes each entry once ever — at
    # append — and every peer × every rebroadcast reuses the cached blob;
    # the follower inserts the blob verbatim and deserializes lazily at
    # apply time. (Pre-pipeline, entries carried live dataclasses that were
    # re-serialized per peer per broadcast — O(tail) codec work per tick.)
    entries: tuple
    leader_commit: int


@register
@dataclass(frozen=True)
class AppendReply:
    term: int
    success: bool
    match_index: int
    follower: str
    # On failure: the follower's last log/snapshot index (-1 = no hint), so
    # the leader can jump next_index instead of decrementing one entry per
    # round trip (and instead of livelocking against a follower whose
    # snapshot is AHEAD of the leader's own compaction point). 0 is a REAL
    # hint: an empty-log follower wants next_index = 1 immediately.
    hint_index: int = -1


@register
@dataclass(frozen=True)
class ClientCommit:
    """Follower->leader forwarding of a client commit."""

    command: PutAllCommand
    reply_to: str


@register
@dataclass(frozen=True)
class ClientCommitBatch:
    """Follower->leader forwarding, coalesced: every commit a follower's
    round buffered rides one frame (one outbox insert/ACK) instead of one
    ClientCommit frame per command."""

    commands: tuple  # (PutAllCommand, ...)
    reply_to: str


@register
@dataclass(frozen=True)
class ClientCommitBatchQos:
    """Follower->leader forwarding with QoS context riding along: one
    wire-encoded QosContext per command (b"" = unlabelled), positionally
    parallel to `commands`, so the leader's deadline-aware batch seal can
    see forwarded interactive deadlines too. Sent only when the QoS plane
    is armed AND at least one buffered command carries a context — a
    qos-disabled deployment never sees this type on the wire, keeping the
    classic frame set byte-identical."""

    commands: tuple  # (PutAllCommand, ...)
    reply_to: str
    qos: tuple  # (bytes, ...) parallel to commands; b"" = no context


@register
@dataclass(frozen=True)
class ClientReply:
    request_id: bytes
    ok: bool
    conflict: UniquenessConflict | None
    leader_hint: str | None
    # True when the command bounced off a shard-reshard fence (WRONG_EPOCH
    # outcome): the ref now belongs to another group/epoch, so resubmitting
    # HERE can never succeed — the submitter must re-derive the shard
    # directory first. Wire-only (ClientReply is never persisted) and every
    # process in a deployment runs the same code, so extending the frame is
    # safe; pre-reshard traffic always sends the default False.
    wrong_epoch: bool = False


@register
@dataclass(frozen=True)
class ClientReplyBatch:
    """Leader->member decisions, coalesced: one multi-outcome frame per
    destination per apply pass. Redelivery-safe — recording a decision is
    idempotent and each waiting request polls its id at most once."""

    replies: tuple  # (ClientReply, ...)


@register
@dataclass(frozen=True)
class InstallSnapshot:
    """Leader -> lagging follower: the state-machine content replaces the
    follower's, when the leader's log was compacted past the follower's
    position (DistributedImmutableMap.kt snapshot/install capability).
    CHUNKED: large maps ship as an ordered series of frames (each well under
    the transport's frame cap); `offset` is the entry index of the first
    entry in this chunk, `done` marks the last chunk. Live reservations
    (cross-shard 2PC holds) ride the final chunk only — the table is small
    (in-flight 2PCs, not history), and a follower restored without them
    could commit a PutAll straight through a hold the rest of the group is
    honouring."""

    term: int
    leader: str
    last_included_index: int
    last_included_term: int
    entries: tuple  # ((state_ref_blob, consuming_blob), ...)
    offset: int = 0
    done: bool = True
    reservations: tuple = ()  # ((state_ref_blob, tx_id_bytes, expires_at),)
    # CRC32C over this chunk's entry blobs (durability plane): a follower
    # discards a damaged chunk instead of installing it; 0 = unverified
    # (frames from pre-durability senders decode with the default).
    crc: int = 0


@register
@dataclass(frozen=True)
class InstallSnapshotReply:
    term: int
    follower: str
    last_included_index: int


def _snapshot_chunk_crc(entries) -> int:
    """Running CRC32C over an InstallSnapshot chunk's entry blobs, in
    order — binds both content and sequence of the (ref, consuming) pairs."""
    c = 0
    for ref, consuming in entries:
        c = _integrity.crc32c(bytes(consuming), _integrity.crc32c(bytes(ref), c))
    return c


class _Busy:
    """Third apply outcome beside None (ok) and UniquenessConflict (final):
    the command lost to another transaction's UNEXPIRED reservation. Mapped
    by _apply_committed to the retryable bounce reply form (ok=False,
    conflict=None) that commit pollers already answer by resubmitting — the
    resubmission carries a fresh issued_at, so it wins deterministically
    once the hold expires, or resolves against the holder's commit/abort."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "BUSY"


BUSY = _Busy()


class _WrongEpoch:
    """Fourth apply outcome: the command touches refs this group no longer
    (or does not yet) own under the shard-map epoch its fence installed.
    Unlike BUSY, resubmitting to the SAME group can never succeed — the
    submitter must re-derive the shard directory (flows/notary.py watches
    the network map) and route to the new owner. Mapped by _apply_committed
    to ClientReply(ok=False, conflict=None, wrong_epoch=True)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "WRONG_EPOCH"


WRONG_EPOCH = _WrongEpoch()


class RaftMember:
    """One member of the notary cluster's consensus group."""

    ELECTION_TIMEOUT = (0.15, 0.30)  # seconds, randomized per election
    HEARTBEAT = 0.05

    def __init__(
        self,
        name: str,
        peers: dict[str, Any],  # name -> transport address (excluding self)
        messaging: MessagingService,
        db,  # NodeDatabase
        apply_command: Callable[[PutAllCommand], UniquenessConflict | None],
        clock: Callable[[], float] = _time.monotonic,
        rng: random.Random | None = None,
        timeout_scale: float = 1.0,
        config=None,  # RaftConfig; None = defaults (group commit ON)
    ):
        from ..config import RaftConfig

        self.config = config or RaftConfig()
        self.name = name
        self.peers = dict(peers)
        # Cross-group reply routing (sharded notary): a 2PC coordinator in
        # ANOTHER Raft group sends ClientCommit frames here with a reply_to
        # that is not one of this group's peers. The node injects a netmap-
        # backed name->address resolver so decisions find their way back;
        # None keeps the single-group behaviour exactly (peers-only).
        self.resolve_addr: Callable[[str], Any] | None = None
        self.messaging = messaging
        self.db = db
        self.apply_command = apply_command
        self.clock = clock
        self.rng = rng or random.Random(hash(name) & 0xFFFF)
        self.scale = timeout_scale

        with db.lock:
            db.conn.executescript(_RAFT_SCHEMA)
            # Legacy databases created before the durability plane get the
            # nullable crc column added in place (IF NOT EXISTS above only
            # covers fresh files).
            _integrity.ensure_integrity_schema(db.conn)
            row = db.conn.execute(
                "SELECT term, voted_for FROM raft_meta WHERE singleton=1"
            ).fetchone()
            if row is None:
                db.conn.execute(
                    "INSERT INTO raft_meta (singleton, term, voted_for) "
                    "VALUES (1, 0, NULL)")
                db.conn.commit()
                self.term, self.voted_for = 0, None
            else:
                self.term, self.voted_for = row[0], row[1]
        self.role = "follower"
        self.leader_name: str | None = None
        self.commit_index = int(db.get_setting("raft_commit_index") or 0)
        self.last_applied = int(db.get_setting("raft_last_applied") or 0)
        # Log compaction marker: entries <= snapshot_index live only in the
        # applied state machine (committed_states), not the log.
        self.snapshot_index = int(db.get_setting("raft_snapshot_index") or 0)
        self.snapshot_term = int(db.get_setting("raft_snapshot_term") or 0)
        self._votes: set[str] = set()
        self._election_attempts = 0  # consecutive failed elections (backoff)
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._last_heartbeat = self.clock()
        self._snapshot_sent_at: dict[str, float] = {}
        self._election_deadline = self._next_election_deadline()
        # Partition hardening (round 20, [raft] prevote): pre-vote canvass
        # state (who granted the current canvass; advisory only — a real
        # election still collects real votes), last contact from a live
        # leader (follower side: the §9.6 leader-stickiness check), last
        # reply from each peer (leader side: check-quorum). The contact
        # stamps are written unconditionally — plain attribute writes with
        # no observable effect — but every BEHAVIOR (canvassing, granting
        # semantics, step-down) is gated on config.prevote so the flag-off
        # path is bit-identical to pre-round-20.
        self._prevote_votes: set[str] = set()
        self._prevoting = False
        self._last_leader_contact = self.clock()
        self._peer_contact: dict[str, float] = {}
        # Candidacy start (self.clock() timeline) for the `election` marker
        # span recorded at the win; spans canvass start when prevote is on.
        self._candidacy_t0: float | None = None
        # request_id -> ClientReply for commits decided at this member.
        # Bounded: late/duplicate replies for abandoned requests must not
        # accumulate on a long-running cluster.
        self.decided: dict[bytes, ClientReply] = {}
        self._decided_cap = 4096
        # Leader-side dedupe: request_ids appended to the log but not yet
        # applied — a client's periodic resubmission (liveness across leader
        # changes) must not append duplicate log entries on a slow quorum.
        self._appending: set[bytes] = set()
        # In-memory mirror of recent log entries (idx -> (term, command)):
        # replication re-reads the same entries once per broadcast per peer,
        # and re-deserializing sqlite blobs each time made a 256-commit
        # burst O(n^2) in codec work. Evicted on truncate/compaction.
        self._entry_cache: dict[int, tuple[int, Any]] = {}
        # Coalesced replication: submit() marks the log dirty and
        # flush_appends()/tick() broadcasts ONCE per scheduling round — a
        # burst of submissions previously triggered one full broadcast EACH.
        self._append_dirty = False
        # Group commit (config.group_commit): leader-side buffer of commands
        # submitted this round, sealed into ONE PutAllBatch log entry by
        # flush_appends(). Drained with bounce replies if deposed mid-round.
        self._pending_batch: list[PutAllCommand] = []
        # Follower-side forwarding buffer: commands bound for the leader,
        # coalesced into one ClientCommitBatch frame per round.
        self._pending_forward: list[PutAllCommand] = []
        # Encoded-entry mirror (idx -> (term, blob)): the serialized form of
        # recent log entries, so replication never re-serializes an entry per
        # peer per broadcast. Evicted with _entry_cache on truncate/compact.
        self._blob_cache: dict[int, tuple[int, bytes]] = {}
        # Pipelined replication: highest index already streamed to each peer
        # on the current leadership (>= next_index-1). Broadcasts send only
        # (sent, sent+chunk] instead of re-sending the whole un-acked tail
        # every tick; heartbeats probe at prev=sent so a lost frame surfaces
        # as a failure reply that rewinds the stream.
        self._sent_index: dict[str, int] = {}
        # Per-peer exponential next_index backoff for hint-less failures
        # (doubles per consecutive failure, resets on success): a diverged
        # follower converges in O(log tail) round trips, not O(tail).
        self._backoff: dict[str, int] = {}
        # Replication RTT: first-broadcast clock per entry index, popped when
        # quorum commit passes it.
        self._bcast_at: dict[int, float] = {}
        # Tracing (obs/trace.py), all leader-local and empty when disarmed:
        # the flow trace ids riding each sealed log entry (idx -> hex list,
        # popped at quorum commit for the replication span) and the members
        # of the entry currently being appended (read by _log_append).
        self._trace_members: dict[int, list] = {}
        self._obs_members: list | None = None
        # Replication stamps (exported via node_metrics / loadtest / bench):
        # entries-per-batch, reply coalescing, RTT — the self-describing
        # numbers the commit-pipeline work is judged on.
        self.metrics = {
            "group_commits": 0,     # batched log entries sealed
            "group_commands": 0,    # commands coalesced into them
            "solo_commits": 0,      # single-command log entries
            "append_frames": 0,     # AppendEntries frames sent (incl. probes)
            "append_entries_sent": 0,  # log entries streamed inside them
            "reply_frames": 0,      # leader->member decision frames
            "reply_commands": 0,    # decisions inside them
            "forward_frames": 0,    # follower->leader commit frames
            "forward_commands": 0,  # commands inside them
            "replication_rtt_s": 0.0,  # broadcast -> quorum commit, summed
            "replication_rtt_n": 0,
            "qos_early_seals": 0,   # rounds sealed early for a deadline
            # Pipelined commit plane (round 18): mid-round seals (round N+1
            # sealed while N replicates), executor batches applied, and NEW
            # submissions shed off a full commit queue.
            "midround_seals": 0,
            "apply_batches": 0,
            "apply_shed": 0,
            # Durability plane (integrity.py): corrupt rows detected on the
            # log read paths, repairs taken, and disk-exhaustion degrades.
            "integrity_errors": 0,  # crc mismatches detected
            "log_truncations": 0,   # corrupt-suffix heals (truncate/compact)
            "leader_stepdowns": 0,  # leaderships ceded to corruption/disk
            "disk_degraded": 0,     # disk-full write failures absorbed
            # Partition plane (round 20): pre-vote canvasses started here,
            # canvass grants withheld here (live leader / stale log), and
            # leaderships ceded because a quorum of peers went silent
            # (check-quorum; these ALSO count in leader_stepdowns). All 0
            # with [raft] prevote off. elections_won counts every
            # leadership this member assumed — with prevote on, term and
            # elections_won stay bounded across a partition/heal cycle;
            # with it off, term inflates once per futile minority timeout.
            "prevotes": 0,
            "prevote_rejections": 0,
            "checkquorum_stepdowns": 0,
            "elections_won": 0,
        }
        # Leader seal-path phase accumulators (seconds), read as per-round
        # deltas by node.run_once to split its raft segment into the
        # round_breakdown's seal / replicate / apply phases. Unconditional
        # and unlocked: three perf_counter reads per flush, single
        # (node-loop) writer.
        self.phase_s = {"seal": 0.0, "replicate": 0.0, "apply": 0.0}
        # Pipelined commit plane (round 18): committed entries hand off to a
        # dedicated apply-executor thread through a bounded queue, so state
        # apply + reply construction overlap the consensus thread's next
        # seal/replicate pass. overlap_s accumulates executor wall time
        # (single writer: the executor thread) — kept OUT of phase_s so the
        # round_breakdown's coverage never double-counts overlapped time.
        self.overlap_s = {"apply": 0.0}
        # Lazily created with the executor thread (None = serial apply).
        self._apply_queue: _queue.Queue | None = None
        self._apply_thread: threading.Thread | None = None
        # Completed (idx, commands, replies, error) items, drained on the
        # consensus thread (deque appends/pops are thread-safe).
        self._apply_results: deque = deque()
        # Enqueue cursor: highest index handed to the executor. last_applied
        # only advances when results drain, so a crash mid-overlap replays
        # the queued suffix idempotently from the durable log.
        self._applied_enqueued = self.last_applied
        # Columnar fast path: make_apply_command exposes the batch variant
        # as an attribute on the apply closure (apply.many).
        self._commit_many = (getattr(apply_command, "many", None)
                             if self.config.commit_many else None)
        messaging.add_message_handler(RAFT_TOPIC, 0, self._on_message)

    # -- persistence -------------------------------------------------------

    def _save_meta(self) -> None:
        with self.db.lock:
            self.db.conn.execute(
                "UPDATE raft_meta SET term=?, voted_for=? WHERE singleton=1",
                (self.term, self.voted_for))
            self.db.commit()

    def _log_last(self) -> tuple[int, int]:
        row = self.db.conn.execute(
            "SELECT idx, term FROM raft_log ORDER BY idx DESC LIMIT 1"
        ).fetchone()
        return (row[0], row[1]) if row else (self.snapshot_index,
                                             self.snapshot_term)

    def _log_term_at(self, idx: int) -> int | None:
        if idx == 0:
            return 0
        if idx == self.snapshot_index:
            return self.snapshot_term
        cached = self._entry_cache.get(idx)
        if cached is not None:
            return cached[0]
        row = self.db.conn.execute(
            "SELECT term FROM raft_log WHERE idx=?", (idx,)).fetchone()
        return None if row is None else row[0]

    def _log_append(self, idx: int, term: int, command) -> None:
        if _faults.ACTIVE is not None:
            _faults.fire_fsync("raft.fsync")
            _faults.fire_disk_full()
        # Traced only on the leader's seal path (_obs_members set): the
        # serialize+insert is the raft_append span, the db.commit (sqlite's
        # fsync point outside batched rounds) is the fsync span.
        traced = _obs.ACTIVE is not None and self._obs_members is not None
        t0 = _obs.now() if traced else 0.0
        blob = serialize(command).bytes
        with self.db.lock:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO raft_log (idx, term, blob, crc) "
                "VALUES (?, ?, ?, ?)",
                (idx, term, blob, _integrity.log_crc(idx, term, blob)))
            t1 = _obs.now() if traced else 0.0
            self.db.commit()
        if traced:
            attrs = {"member_traces": self._obs_members, "idx": idx}
            _obs.record("raft_append", t0, t1, attrs=attrs)
            _obs.record("fsync", t1, _obs.now(), attrs=attrs)
        self._entry_cache[idx] = (term, command)
        self._blob_cache[idx] = (term, blob)

    def _log_append_blob(self, idx: int, term: int, blob: bytes) -> None:
        """Follower-side append of a pre-encoded entry: the wire blob goes
        into raft_log verbatim (no decode on the replication hot path);
        deserialization happens lazily at apply time. The crc rides a
        separate column, so the stored blob stays byte-identical to the
        leader's."""
        if _faults.ACTIVE is not None:
            _faults.fire_fsync("raft.fsync")
            _faults.fire_disk_full()
        blob = bytes(blob)
        with self.db.lock:
            self.db.conn.execute(
                "INSERT OR REPLACE INTO raft_log (idx, term, blob, crc) "
                "VALUES (?, ?, ?, ?)",
                (idx, term, blob, _integrity.log_crc(idx, term, blob)))
            self.db.commit()
        self._entry_cache.pop(idx, None)
        self._blob_cache[idx] = (term, blob)

    def _log_truncate_from(self, idx: int) -> None:
        with self.db.lock:
            self.db.conn.execute("DELETE FROM raft_log WHERE idx >= ?", (idx,))
            self.db.commit()
        for cache in (self._entry_cache, self._blob_cache):
            for i in [i for i in cache if i >= idx]:
                del cache[i]

    def _verified_log_rows(self, idx: int, limit: int):
        """sqlite read path shared by _log_entries_from/_log_blobs_from:
        fetch rows, apply the seeded ``disk.corrupt`` fault (bit-flips on
        READ bytes — stored bytes stay intact, so repair genuinely
        recovers), and verify each row's crc frame. The first corrupt row
        triggers :meth:`_heal_corrupt_entry` and ends the batch — callers
        get the verified prefix, the healed member re-fetches the rest
        through normal replication."""
        rows = self.db.conn.execute(
            "SELECT idx, term, blob, crc FROM raft_log WHERE idx >= ? "
            "ORDER BY idx LIMIT ?", (idx, limit)).fetchall()
        out = []
        for r in rows:
            row_idx, row_term, blob = r[0], r[1], bytes(r[2])
            if _faults.ACTIVE is not None:
                blob = _faults.fire_disk_corrupt(blob)
            if r[3] is not None and \
                    _integrity.log_crc(row_idx, row_term, blob) != int(r[3]):
                self._heal_corrupt_entry(row_idx)
                break
            out.append((row_idx, row_term, blob))
        return out

    def _log_entries_from(self, idx: int, limit: int = 256):
        # Serve from the in-memory mirror when it covers the whole span.
        last_idx, _ = self._log_last()
        if idx > last_idx:
            return []
        span = range(idx, min(last_idx, idx + limit - 1) + 1)
        if all(i in self._entry_cache for i in span):
            return [(i, *self._entry_cache[i]) for i in span]
        out = []
        for row_idx, row_term, blob in self._verified_log_rows(idx, limit):
            entry = (row_idx, row_term, deserialize(blob))
            self._entry_cache[row_idx] = (entry[1], entry[2])
            out.append(entry)
        return out

    def _log_blobs_from(self, idx: int, limit: int = 256):
        """[(idx, term, blob)] — the replication read path. Serves encoded
        entries straight from the blob mirror (or sqlite bytes) with ZERO
        codec work: what the wire carries is exactly what the log stores."""
        last_idx, _ = self._log_last()
        if idx > last_idx or limit <= 0:
            return []
        span = range(idx, min(last_idx, idx + limit - 1) + 1)
        if all(i in self._blob_cache for i in span):
            return [(i, *self._blob_cache[i]) for i in span]
        out = []
        for entry in self._verified_log_rows(idx, limit):
            self._blob_cache[entry[0]] = (entry[1], entry[2])
            out.append(entry)
        return out

    def _heal_corrupt_entry(self, idx: int) -> None:
        """Self-healing for a corrupt log row detected at *idx*: corruption
        becomes a LAGGING member, never a diverged one.

        * ``idx > last_applied`` — the damaged entry's effects are not yet
          in the state machine: truncate the log from idx (the last
          verified prefix survives), clamp commit_index to what remains,
          and let next_index backoff / InstallSnapshot re-replicate.
        * ``idx <= last_applied`` — the effects are durable in
          committed_states: compact the applied prefix behind a snapshot
          marker (same ONE-transaction invariant as maybe_compact), which
          drops the damaged row legitimately.

        A leader additionally steps down: its log can no longer vouch for
        the range it was replicating (the corrupt-unreplicated-suffix
        case), and a healthy majority elects around it."""
        self.metrics["integrity_errors"] += 1
        self.metrics["log_truncations"] += 1
        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        was_leader = self.role == "leader"
        with self.db.lock:
            try:
                if idx <= self.last_applied:
                    upto = self.last_applied
                    term = self._log_term_at(upto)
                    if term is None:
                        term = self.snapshot_term
                    self.db.conn.execute(
                        "DELETE FROM raft_log WHERE idx <= ?", (upto,))
                    for key, value in (("raft_snapshot_index", str(upto)),
                                       ("raft_snapshot_term", str(term))):
                        self.db.conn.execute(
                            "INSERT OR REPLACE INTO settings (key, value) "
                            "VALUES (?, ?)", (key, value))
                    self.db.commit()
                    self.snapshot_index, self.snapshot_term = upto, int(term)
                    evict = lambda i: i <= upto  # noqa: E731
                else:
                    self.db.conn.execute(
                        "DELETE FROM raft_log WHERE idx >= ?", (idx,))
                    self.commit_index = min(self.commit_index, idx - 1)
                    self.db.conn.execute(
                        "INSERT OR REPLACE INTO settings (key, value) "
                        "VALUES (?, ?)",
                        ("raft_commit_index", str(self.commit_index)))
                    self.db.commit()
                    evict = lambda i: i >= idx  # noqa: E731
            except BaseException:
                if not self.db.in_batch:
                    self.db.conn.rollback()
                raise
        for cache in (self._entry_cache, self._blob_cache):
            for i in [i for i in cache if evict(i)]:
                del cache[i]
        if _obs.ACTIVE is not None:
            _obs.record("repair", t0, _obs.now(),
                        attrs={"kind": "raft_log", "idx": idx,
                               "node": self.name})
        if was_leader:
            self.metrics["leader_stepdowns"] += 1
            self._become_follower(self.term)

    # -- timers (driven from the node's run loop) --------------------------

    def _next_election_deadline(self) -> float:
        lo, hi = self.ELECTION_TIMEOUT
        # Randomized-timeout backoff: under a coarse scheduler (nodes pumped
        # round-robin, each round gated on fsync) the base window quantizes
        # to pump-cycle granularity and two candidates can split votes
        # REPEATEDLY. Each consecutive failed election widens the window, so
        # collisions decay geometrically instead of recurring for seconds.
        spread = 1.0 + 0.5 * min(self._election_attempts, 6)
        return self.clock() + self.rng.uniform(lo, hi * spread) * self.scale

    def tick(self) -> None:
        now = self.clock()
        if self.config.pipeline and self.config.apply_queue_depth > 0:
            # Pipelined plane: drain finished executor results (decision
            # bookkeeping + reply frames run on this thread) and top the
            # bounded queue back up from the committed-but-unapplied tail.
            # The enqueue check runs even with no live queue: after an
            # executor crash-reset the backlog must re-enqueue through a
            # FRESH executor without waiting for new commit traffic.
            if self._apply_queue is not None:
                self._drain_apply_results()
            if self._applied_enqueued < self.commit_index:
                self._enqueue_committed()
        if self.role == "leader":
            if self.config.prevote and not self._quorum_alive(now):
                # Check-quorum: a leader that cannot hear a quorum (e.g. it
                # landed on the minority side of a cut) steps down instead
                # of silently accepting submissions it can never commit —
                # clients get bounced to re-route promptly rather than
                # timing out against a zombie leader.
                self._checkquorum_stepdown()
            elif (self._append_dirty
                    or now - self._last_heartbeat
                    >= self.HEARTBEAT * self.scale):
                self.flush_appends()
        else:
            self._flush_forwards()
            if now >= self._election_deadline:
                if self.config.prevote:
                    self._start_prevote()
                else:
                    self._start_election()

    def flush_appends(self) -> None:
        """The commit pipeline's per-round flush: seal the round's buffered
        submissions into one group-commit log entry, replicate (single
        pipelined AppendEntries per peer per round, however many submissions
        the round coalesced) and advance local commit bookkeeping. On a
        follower, flushes the coalesced leader-forwarding buffer instead."""
        if self.role != "leader":
            self._flush_forwards()
            return
        t = _time.perf_counter
        t0 = t()
        self._seal_batch()
        self._append_dirty = False
        t1 = t()
        self._broadcast_append()
        t2 = t()
        self._advance_commit()
        ph = self.phase_s
        ph["seal"] += t1 - t0
        ph["replicate"] += t2 - t1
        ph["apply"] += t() - t2

    def _seal_batch(self) -> None:
        """Merge the round's buffered commands into ONE log entry (one
        sqlite insert, one fsync outside batched rounds, one AppendEntries
        slot). A single command appends bare — the wire/apply path for
        un-batched traffic is byte-identical to the pre-group-commit one."""
        if not self._pending_batch:
            return
        cmds = tuple(self._pending_batch)
        self._pending_batch.clear()
        last_idx, _ = self._log_last()
        if _obs.ACTIVE is not None:
            # The flow traces riding this entry (link map filled by
            # commit_async on THIS process — the hot path, where the flow
            # node is the leader; forwarded commands have no link and are
            # an honest attribution gap).
            members = []
            for cmd in cmds:
                link = _obs.ACTIVE.peek_link(cmd.request_id)
                if link is not None:
                    members.append(link[0].hex())
            self._obs_members = members or None
            if members:
                self._trace_members[last_idx + 1] = members
        try:
            if len(cmds) == 1:
                self.metrics["solo_commits"] += 1
                self._log_append(last_idx + 1, self.term, cmds[0])
            else:
                self.metrics["group_commits"] += 1
                self.metrics["group_commands"] += len(cmds)
                self._log_append(last_idx + 1, self.term, PutAllBatch(cmds))
            if _tm.ACTIVE is not None:
                _tm.inc("raft_seals_total")
                _tm.inc("raft_seal_entries_total", len(cmds))
                _tm.observe("raft_seal_entries", len(cmds))
        except sqlite3.OperationalError as e:
            if not _integrity.is_disk_full(e):
                raise
            # Graceful disk exhaustion: a leader that cannot extend its log
            # must stop leading, not crash the process. The round's commands
            # were never sealed — restore them so _depose bounces each with
            # a retryable reply, and cede leadership to a member that can
            # still write.
            self.metrics["disk_degraded"] += 1
            self._trace_members.pop(last_idx + 1, None)
            self._pending_batch = list(cmds)
            self._become_follower(self.term)
        finally:
            self._obs_members = None

    def _flush_forwards(self) -> None:
        """Coalesced follower->leader forwarding: the round's buffered
        commands ride one ClientCommitBatch frame. No known leader by flush
        time: bounce each so the waiting flows re-route/resubmit."""
        if not self._pending_forward:
            return
        cmds, self._pending_forward = tuple(self._pending_forward), []
        if self.role == "leader":
            for cmd in cmds:  # elected between buffer and flush
                self.submit(cmd)
            return
        addr = (self.peers.get(self.leader_name)
                if self.leader_name is not None else None)
        if addr is None:
            for cmd in cmds:
                self._record_decision(cmd.request_id, ClientReply(
                    cmd.request_id, False, None, self.leader_name))
            return
        self.metrics["forward_frames"] += 1
        self.metrics["forward_commands"] += len(cmds)
        qos_wire = None
        plane = _qos.ACTIVE
        if plane is not None:
            encoded = tuple(
                ctx.to_wire() if ctx is not None else b""
                for ctx in (plane.peek_link(cmd.request_id) for cmd in cmds))
            if any(encoded):
                qos_wire = encoded
        if qos_wire is not None:
            self._send(addr, ClientCommitBatchQos(cmds, self.name, qos_wire))
        elif len(cmds) == 1:
            self._send(addr, ClientCommit(cmds[0], self.name))
        else:
            self._send(addr, ClientCommitBatch(cmds, self.name))

    # -- roles -------------------------------------------------------------

    def _become_follower(self, term: int, leader: str | None = None) -> None:
        if term > self.term:
            self.term, self.voted_for = term, None
            self._save_meta()
        was_leader = self.role == "leader"
        self.role = "follower"
        # Any follower transition invalidates an in-flight canvass (a live
        # leader or higher term appeared) and the candidacy span anchor;
        # harmless no-ops when prevote off.
        self._prevoting = False
        self._candidacy_t0 = None
        if leader is not None:
            self.leader_name = leader
            self._election_attempts = 0  # a live leader resets the backoff
        self._election_deadline = self._next_election_deadline()
        if was_leader:
            self._depose()

    def _depose(self) -> None:
        """Leader change mid-batch: commands buffered but never sealed into
        the log bounce back (ok=False + leader hint) so their clients
        re-route to the new leader — order is preserved by the resubmit
        protocol, and apply idempotency absorbs any entry that DID make the
        old log and survives. Leader-only bookkeeping resets with them:
        stale _appending ids must not swallow a resubmission if this member
        is re-elected later (the log they referenced may have been
        truncated), and the pipeline/RTT state is meaningless without
        leadership."""
        pending, self._pending_batch = list(self._pending_batch), []
        for cmd in pending:
            fwd = getattr(self, "_forward_replies", {}).pop(
                cmd.request_id, None)
            reply = ClientReply(cmd.request_id, False, None, self.leader_name)
            addr = self._peer_addr(fwd)
            if addr is not None:
                self._send(addr, reply)
            else:
                self._record_decision(cmd.request_id, reply)
        self._appending.clear()
        self._sent_index.clear()
        self._backoff.clear()
        self._bcast_at.clear()
        self._trace_members.clear()

    def _start_election(self) -> None:
        if self.role == "candidate":
            self._election_attempts += 1  # previous election went nowhere
        if self._candidacy_t0 is None:
            # Canvass-initiated elections already stamped candidacy start;
            # a direct (prevote-off) election starts its span here.
            self._candidacy_t0 = self.clock()
        self.term += 1
        self.voted_for = self.name
        self._save_meta()
        self.role = "candidate"
        self.leader_name = None
        self._votes = {self.name}
        self._election_deadline = self._next_election_deadline()
        last_idx, last_term = self._log_last()
        msg = RequestVote(self.term, self.name, last_idx, last_term)
        for peer in self.peers.values():
            self._send(peer, msg)
        self._maybe_win()

    def _maybe_win(self) -> None:
        if self.role != "candidate":
            return
        if len(self._votes) * 2 > len(self.peers) + 1:
            self.role = "leader"
            self.leader_name = self.name
            self._election_attempts = 0
            self.metrics["elections_won"] += 1
            now = self.clock()
            if self.config.prevote:
                # Check-quorum baseline: every peer counts as heard-from at
                # the moment of the win, so a fresh leadership gets a full
                # window to establish contact before step-down can trigger.
                self._peer_contact = {p: now for p in self.peers}
            if _obs.ACTIVE is not None and self._candidacy_t0 is not None:
                # Re-anchor the candidacy (monotonic clock) onto the epoch
                # timeline ending now — same convention as the replication
                # span in _advance_commit.
                epoch = _obs.now()
                _obs.record(
                    "election",
                    epoch - (now - self._candidacy_t0), epoch,
                    attrs={"term": self.term,
                           "prevote": bool(self.config.prevote)})
            self._candidacy_t0 = None
            last_idx, _ = self._log_last()
            self._next_index = {p: last_idx + 1 for p in self.peers}
            self._match_index = {p: 0 for p in self.peers}
            # Pipeline state is per-leadership: nothing streamed yet.
            self._sent_index = {p: last_idx for p in self.peers}
            self._backoff.clear()
            self._bcast_at.clear()
            self._broadcast_append()  # assert leadership immediately

    # -- client interface --------------------------------------------------

    def submit(self, command: PutAllCommand) -> None:
        """Start replication of a command; the outcome appears in
        self.decided[request_id] once committed (possibly ok=False with a
        leader hint if this member cannot get it committed)."""
        if self.role == "leader":
            if command.request_id in self._appending:
                return  # already replicating; resubmission is a no-op
            if self.apply_overloaded():
                # Bounded-queue backpressure: the apply executor is full, so
                # NEW submissions shed with a retryable bounce instead of
                # growing an unbounded committed-but-unapplied backlog.
                # In-flight commands (already in _appending) are never shed
                # — committed work always drains.
                self.metrics["apply_shed"] += 1
                if _tm.ACTIVE is not None:
                    _tm.inc("raft_apply_shed_total")
                fwd = getattr(self, "_forward_replies", {}).pop(
                    command.request_id, None)
                reply = ClientReply(command.request_id, False, None,
                                    self.leader_name)
                addr = self._peer_addr(fwd)
                if addr is not None:
                    self._send(addr, reply)
                else:
                    self._record_decision(command.request_id, reply)
                return
            self._appending.add(command.request_id)
            if self.config.group_commit:
                # Group commit: buffer; flush_appends() seals the round's
                # burst into ONE PutAllBatch log entry (one insert/fsync/
                # AppendEntries slot for every command in the burst).
                self._pending_batch.append(command)
            else:
                last_idx, _ = self._log_last()
                self._log_append(last_idx + 1, self.term, command)
            # Coalesced: flush_appends()/tick() broadcasts once per round,
            # covering every command submitted in the burst.
            self._append_dirty = True
            if _qos.ACTIVE is not None and self._qos_should_seal():
                # Deadline-aware group commit (queueing point 3 of the QoS
                # plane): an interactive entry in the round's buffer is
                # about to breach its SLO deadline — seal and replicate NOW
                # instead of waiting for the scheduling round to close.
                self.metrics["qos_early_seals"] += 1
                if _obs.ACTIVE is not None:
                    mark = _obs.now()
                    _obs.record("qos_flush", mark, mark,
                                attrs={"point": "raft_seal"})
                self.flush_appends()
            if (self.config.pipeline
                    and len(self._pending_batch) >= self.config.append_chunk
                    and (self._log_last()[0] - self.commit_index
                         < self.config.pipeline_window)):
                # Pipelined rounds: a full append_chunk of buffered commands
                # seals and broadcasts MID-ROUND (round N+1 starts
                # replicating while round N's entries are still in flight in
                # the per-peer pipeline window), instead of waiting for the
                # scheduling round to close. The window bound keeps a stalled
                # quorum from piling unacked entries without limit.
                self.metrics["midround_seals"] += 1
                self.flush_appends()
        elif self.leader_name is not None and self.leader_name in self.peers:
            # Buffered: tick()/flush_appends() forwards the round's commands
            # in one ClientCommitBatch frame.
            self._pending_forward.append(command)
        else:
            self.decided[command.request_id] = ClientReply(
                command.request_id, False, None, self.leader_name)

    def _qos_should_seal(self) -> bool:
        """True when some buffered command's QoS context (link map filled
        by commit_async locally or by ClientCommitBatchQos for forwarded
        commands) is an interactive entry near its deadline. The deadline
        evaluation — the only clock read — lives in the QoS plane, never
        here: consensus code stays wall-clock-free (the no-wallclock-in-
        apply invariant)."""
        plane = _qos.ACTIVE
        if plane is None or not self._pending_batch:
            return False
        for cmd in self._pending_batch:
            qctx = plane.peek_link(cmd.request_id)
            if qctx is not None and plane.near_deadline(qctx):
                return True
        return False

    # -- message handling --------------------------------------------------

    def _peer_addr(self, name: str | None):
        """Transport address for a member name: this group's peers first,
        then the injected netmap resolver (cross-group 2PC reply routing)."""
        if name is None:
            return None
        addr = self.peers.get(name)
        if addr is None and self.resolve_addr is not None:
            addr = self.resolve_addr(name)
        return addr

    def _send(self, to, payload) -> None:
        if _faults.ACTIVE is not None and isinstance(
                payload, (AppendEntries, AppendReply)):
            # raft.append: only the replication stream — votes stay intact
            # so an armed plan cannot make leader election itself impossible.
            act = _faults.ACTIVE.fire("raft.append")
            if act is not None:
                action, delay_s = act
                if action == "drop":
                    return
                if action in ("delay", "reorder") and delay_s > 0:
                    _time.sleep(delay_s)
                elif action == "duplicate":
                    self.messaging.send(TopicSession(RAFT_TOPIC, 0),
                                        serialize(payload).bytes, to)
        self.messaging.send(TopicSession(RAFT_TOPIC, 0),
                            serialize(payload).bytes, to)

    def _on_message(self, message) -> None:
        try:
            payload = deserialize(message.data)
        except Exception:
            return
        if isinstance(payload, RequestVote):
            self._on_request_vote(payload, message.sender)
        elif isinstance(payload, VoteReply):
            self._on_vote_reply(payload)
        elif isinstance(payload, PreVote):
            self._on_prevote(payload, message.sender)
        elif isinstance(payload, PreVoteReply):
            self._on_prevote_reply(payload)
        elif isinstance(payload, AppendEntries):
            self._on_append(payload, message.sender)
        elif isinstance(payload, AppendReply):
            self._on_append_reply(payload)
        elif isinstance(payload, ClientCommit):
            self._on_client_commit(payload)
        elif isinstance(payload, ClientCommitBatch):
            for cmd in payload.commands:
                self._on_client_commit(ClientCommit(cmd, payload.reply_to))
        elif isinstance(payload, ClientCommitBatchQos):
            plane = _qos.ACTIVE
            for cmd, qw in zip(payload.commands, payload.qos):
                if plane is not None and qw:
                    qctx = _qos.QosContext.from_wire(qw)
                    if qctx is not None:
                        plane.register_link(cmd.request_id, qctx)
                self._on_client_commit(ClientCommit(cmd, payload.reply_to))
        elif isinstance(payload, ClientReply):
            self._record_decision(payload.request_id, payload)
        elif isinstance(payload, ClientReplyBatch):
            # Idempotent per reply: a redelivered batch re-records decisions
            # already recorded (each waiting request polls its id at most
            # once, so duplicates are absorbed, never re-applied).
            for reply in payload.replies:
                self._record_decision(reply.request_id, reply)
        elif isinstance(payload, InstallSnapshot):
            self._on_install_snapshot(payload, message.sender)
        elif isinstance(payload, InstallSnapshotReply):
            if payload.term > self.term:
                self._become_follower(payload.term)
            elif self.role == "leader":
                self._peer_contact[payload.follower] = self.clock()
                match = max(self._match_index.get(payload.follower, 0),
                            payload.last_included_index)
                self._match_index[payload.follower] = match
                # Never move next_index BACKWARDS past what the follower
                # already matched (a stale snapshot reply must not restart
                # replication behind a fresher position).
                self._next_index[payload.follower] = max(
                    self._next_index.get(payload.follower, 1), match + 1)

    def _on_request_vote(self, rv: RequestVote, sender) -> None:
        if rv.term > self.term:
            self._become_follower(rv.term)
        granted = False
        if rv.term == self.term and self.voted_for in (None, rv.candidate):
            last_idx, last_term = self._log_last()
            up_to_date = (rv.last_log_term, rv.last_log_index) >= (
                last_term, last_idx)
            if up_to_date:
                granted = True
                self.voted_for = rv.candidate
                self._save_meta()
                self._election_deadline = self._next_election_deadline()
        if (not granted and self.role == "candidate"
                and rv.term == self.term):
            # Symmetric-candidacy livelock breaker (observed under a coarse
            # round-robin scheduler whose pump cycle exceeded the election
            # timeout: both members' timers expired EVERY cycle, each voted
            # for itself each term, forever). Safety-neutral tiebreak — the
            # vote stays rejected (no double voting); the LOWER-priority
            # candidate merely stops racing: it steps down and sits out a
            # full election window, so the rival runs the next term alone.
            last_idx, last_term = self._log_last()
            rival_priority = ((rv.last_log_term, rv.last_log_index,
                               rv.candidate)
                              >= (last_term, last_idx, self.name))
            if rival_priority:
                self.role = "follower"
                # Long enough for the rival's next election AND its
                # RequestVote to traverse a slow pump cycle before our
                # timer can fire again.
                lo, hi = self.ELECTION_TIMEOUT
                self._election_deadline = self.clock() + 4 * hi * self.scale
        self._send(sender, VoteReply(self.term, granted, self.name))

    def _on_vote_reply(self, vr: VoteReply) -> None:
        if vr.term > self.term:
            self._become_follower(vr.term)
            return
        if self.role == "candidate" and vr.term == self.term and vr.granted:
            self._votes.add(vr.voter)
            self._maybe_win()

    # -- pre-vote / check-quorum (partition plane, round 20) ---------------

    def _start_prevote(self) -> None:
        """Canvass at term+1 WITHOUT touching persisted state: role stays
        follower, term/voted_for untouched, nothing fsynced. Only a
        majority of would-grant replies converts into a real election —
        so a member that spent the cut on the minority side times out
        forever without inflating the cluster term, and rejoins at heal
        as a follower instead of deposing the healthy leader."""
        self._prevoting = True
        self._prevote_votes = {self.name}
        self._candidacy_t0 = self.clock()
        self.metrics["prevotes"] += 1
        if _tm.ACTIVE is not None:
            _tm.inc("raft_prevotes_total")
        self._election_deadline = self._next_election_deadline()
        last_idx, last_term = self._log_last()
        msg = PreVote(self.term + 1, self.name, last_idx, last_term)
        for peer in self.peers.values():
            self._send(peer, msg)
        self._maybe_canvass_win()

    def _maybe_canvass_win(self) -> None:
        if not self._prevoting:
            return
        if len(self._prevote_votes) * 2 > len(self.peers) + 1:
            self._prevoting = False
            self._start_election()

    def _on_prevote(self, pv: PreVote, sender) -> None:
        """Answer a canvass. NEVER mutates term/voted_for/role — granting
        here is a promise-free opinion ("I would vote for you"), so
        concurrent canvassers are harmless. Withheld when this member is
        the leader or heard from one within the MINIMUM election window
        (§9.6 leader stickiness: a live leader's cluster refuses to be
        disrupted), or when the canvasser's log is behind."""
        granted = False
        if pv.term >= self.term:
            last_idx, last_term = self._log_last()
            up_to_date = (pv.last_log_term, pv.last_log_index) >= (
                last_term, last_idx)
            lo, _hi = self.ELECTION_TIMEOUT
            leader_live = (
                self.role == "leader"
                or (self.leader_name is not None
                    and self.clock() - self._last_leader_contact
                    < lo * self.scale))
            granted = up_to_date and not leader_live
        if not granted:
            self.metrics["prevote_rejections"] += 1
            if _tm.ACTIVE is not None:
                _tm.inc("raft_prevote_rejections_total")
        self._send(sender, PreVoteReply(self.term, granted, self.name))

    def _on_prevote_reply(self, pvr: PreVoteReply) -> None:
        if pvr.term > self.term:
            # A peer is ahead: adopt its term quietly (no election) — the
            # exact rejoin path the canvass exists for.
            self._become_follower(pvr.term)
            return
        if self._prevoting and pvr.granted:
            self._prevote_votes.add(pvr.voter)
            self._maybe_canvass_win()

    def _quorum_alive(self, now: float) -> bool:
        """Leader-side check-quorum: does a majority (self included) have
        a reply newer than the check window? The window is twice the max
        election timeout — wide enough that one slow pump cycle cannot
        fake a partition, narrow enough that a minority-side leader cedes
        within a couple of election windows of the cut."""
        _lo, hi = self.ELECTION_TIMEOUT
        window = 2 * hi * self.scale
        alive = 1 + sum(
            1 for p in self.peers
            if now - self._peer_contact.get(p, 0.0) <= window)
        return alive * 2 > len(self.peers) + 1

    def _checkquorum_stepdown(self) -> None:
        self.metrics["leader_stepdowns"] += 1
        self.metrics["checkquorum_stepdowns"] += 1
        if _tm.ACTIVE is not None:
            _tm.inc("raft_checkquorum_stepdowns_total")
        # No known successor: clients bounce with leader hint None and
        # re-derive the leader after the (majority-side) election.
        self.leader_name = None
        self._become_follower(self.term)

    COMPACT_THRESHOLD = 256  # log entries kept before compacting applied ones
    SNAPSHOT_CHUNK = 10_000  # map entries per InstallSnapshot frame

    def _broadcast_append(self) -> None:
        if self.role != "leader":
            # A disk-full degrade or corruption heal inside this round's
            # seal/read path stepped us down: nothing to broadcast.
            return
        self._last_heartbeat = now = self.clock()
        for peer_name, addr in self.peers.items():
            nxt = self._next_index.get(peer_name, 1)
            if nxt <= self.snapshot_index:
                # The entries this peer needs were compacted away: ship the
                # applied state instead (DistributedImmutableMap
                # snapshot/install capability). Throttled — a snapshot is
                # O(map) to read+serialize, so don't re-send every heartbeat
                # while one is in flight — and CHUNKED so a large map never
                # exceeds the transport frame cap.
                sent_at = self._snapshot_sent_at.get(peer_name, 0.0)
                backlog_fn = getattr(self.messaging, "outbox_backlog", None)
                backlog = backlog_fn(addr) if backlog_fn is not None else 0
                if backlog > 64:
                    # Peer unreachable: even keepalives must stop piling into
                    # its durable outbox (they redeliver on reconnect anyway).
                    continue
                if (now - sent_at >= 10 * self.HEARTBEAT * self.scale
                        and backlog <= 8):
                    # Backlog gate: a live peer ACKs frames and stays near
                    # zero; an unreachable one accumulates them, and its
                    # durable outbox must NOT gain a superseded snapshot
                    # series every throttle window.
                    self._snapshot_sent_at[peer_name] = now
                    content = self._state_machine_content()
                    reservations = self._reservation_content()
                    chunks = []
                    for off in range(0, max(len(content), 1),
                                     self.SNAPSHOT_CHUNK):
                        chunk = content[off:off + self.SNAPSHOT_CHUNK]
                        done = off + self.SNAPSHOT_CHUNK >= len(content)
                        chunks.append(serialize(InstallSnapshot(
                            self.term, self.name, self.snapshot_index,
                            self.snapshot_term, chunk, off, done,
                            reservations if done else (),
                            crc=_snapshot_chunk_crc(chunk))).bytes)
                    # The whole ordered series hits the durable outbox as
                    # one burst (one executemany/fsync, one bridge wakeup).
                    self._send_burst(addr, chunks)
                # Keep the follower's election timer fed between snapshot
                # rounds with a prev=0 keepalive: index 0 exists on every
                # member, so this ALWAYS succeeds (reply match=0, absorbed by
                # the monotone success path) and never generates the failure
                # churn an un-appendable heartbeat would.
                self._send(addr, AppendEntries(
                    self.term, self.name, 0, 0, (), self.commit_index))
                self.metrics["append_frames"] += 1
                continue
            # Pipelined streaming: send only entries this peer has not been
            # sent on this leadership (a long tail goes out ONCE in bounded
            # chunks, not re-sent wholesale every tick), capped so at most
            # pipeline_window entries ride un-acked beyond next_index.
            sent = max(self._sent_index.get(peer_name, nxt - 1), nxt - 1)
            room = min(self.config.append_chunk,
                       self.config.pipeline_window - (sent - (nxt - 1)))
            blobs = self._log_blobs_from(sent + 1, limit=room)
            if self.role != "leader":
                return  # a corrupt row in the read span healed + stepped down
            if blobs:
                prev_idx = sent
                entries = tuple((term, blob) for _i, term, blob in blobs)
                sent = blobs[-1][0]
            else:
                # Caught up (or window full): probe at prev=sent — success
                # advances match past everything streamed; failure rewinds
                # the stream to wherever the follower actually diverged.
                prev_idx, entries = sent, ()
            prev_term = self._log_term_at(prev_idx) or 0
            self._send(addr, AppendEntries(
                self.term, self.name, prev_idx, prev_term, entries,
                self.commit_index))
            self.metrics["append_frames"] += 1
            self.metrics["append_entries_sent"] += len(entries)
            for i, _t, _b in blobs:
                self._bcast_at.setdefault(i, now)  # replication RTT start
            self._sent_index[peer_name] = sent

    def _send_burst(self, to, payloads) -> None:
        """Multi-frame burst to one peer: one outbox executemany + one
        bridge wakeup when the transport supports it (TcpMessaging
        send_many); falls back to per-frame sends on fakes."""
        send_many = getattr(self.messaging, "send_many", None)
        if send_many is not None:
            send_many(TopicSession(RAFT_TOPIC, 0), payloads, to)
        else:
            for payload in payloads:
                self.messaging.send(TopicSession(RAFT_TOPIC, 0), payload, to)

    def _state_machine_content(self) -> tuple:
        rows = self.db.conn.execute(
            "SELECT state_ref, consuming FROM committed_states").fetchall()
        return tuple((bytes(r[0]), bytes(r[1])) for r in rows)

    def _reservation_content(self) -> tuple:
        """Live 2PC holds — part of the replicated state (a snapshot-
        installed follower without them would let a PutAll through a hold
        the rest of the group honours). Small by construction: in-flight
        reservations, not history."""
        rows = self.db.conn.execute(
            "SELECT state_ref, tx_id, expires_at FROM reserved_states"
        ).fetchall()
        return tuple((bytes(r[0]), bytes(r[1]), float(r[2])) for r in rows)

    def maybe_compact(self) -> None:
        """Drop applied log entries once the log outgrows the threshold —
        their effects live durably in committed_states; lagging peers get an
        InstallSnapshot instead of replay."""
        (log_len,) = self.db.conn.execute(
            "SELECT COUNT(*) FROM raft_log").fetchone()
        if log_len <= self.COMPACT_THRESHOLD:
            return
        # Retain a tail so slightly-behind followers get AppendEntries, and
        # respect follower match positions — but only down to a FLOOR: a
        # dead peer must not pin the log forever (it will get a snapshot).
        upto = self.last_applied - self.COMPACT_THRESHOLD // 2
        if self.role == "leader" and self._match_index:
            floor = self.last_applied - 4 * self.COMPACT_THRESHOLD
            upto = min(upto, max(min(self._match_index.values()), floor))
        if upto <= self.snapshot_index:
            return
        term = self._log_term_at(upto)
        if term is None:
            return
        with self.db.lock:
            # Log prefix deletion and the snapshot marker must be ONE
            # transaction: a crash between them would leave a log whose
            # indices silently rebase to 1 — replicated-log corruption.
            try:
                self.db.conn.execute(
                    "DELETE FROM raft_log WHERE idx <= ?", (upto,))
                for key, value in (("raft_snapshot_index", str(upto)),
                                   ("raft_snapshot_term", str(term))):
                    self.db.conn.execute(
                        "INSERT OR REPLACE INTO settings (key, value) "
                        "VALUES (?, ?)", (key, value))
                self.db.commit()
            except BaseException:
                # A failure between the DELETE and the marker write must not
                # leave the half-compacted prefix in the open transaction —
                # a later unrelated commit would persist it WITHOUT the
                # marker, silently rebasing log indices.
                if not self.db.in_batch:
                    self.db.conn.rollback()
                raise
        for cache in (self._entry_cache, self._blob_cache):
            for i in [i for i in cache if i <= upto]:
                del cache[i]
        self.snapshot_index, self.snapshot_term = upto, term

    def _on_install_snapshot(self, snap: InstallSnapshot, sender) -> None:
        if snap.term < self.term:
            # Reply with our term so a deposed leader steps down instead of
            # re-sending the snapshot every heartbeat forever.
            self._send(sender, InstallSnapshotReply(self.term, self.name, 0))
            return
        self._become_follower(snap.term, leader=snap.leader)
        if snap.crc and _snapshot_chunk_crc(snap.entries) != snap.crc:
            # Damaged chunk: drop the whole staged series rather than
            # install bad ledger rows — the leader re-sends on its throttle.
            self.metrics["integrity_errors"] += 1
            self._snapshot_staging = None
            return
        # Chunk assembly: chunks of one snapshot series arrive in order on
        # the same bridge; offset 0 restarts staging, mismatched continuation
        # discards (the leader re-sends the series on its throttle).
        series_key = (snap.term, snap.last_included_index)
        if snap.offset == 0:
            self._snapshot_staging = (series_key, list(snap.entries))
        else:
            staged = getattr(self, "_snapshot_staging", None)
            if staged is None or staged[0] != series_key \
                    or len(staged[1]) != snap.offset:
                return  # out-of-sequence chunk: wait for a fresh series
            staged[1].extend(snap.entries)
        if not snap.done:
            return
        entries = tuple(self._snapshot_staging[1])
        self._snapshot_staging = None
        if snap.last_included_index > self.last_applied:
            new_commit = max(self.commit_index, snap.last_included_index)
            with self.db.lock:
                # State replacement + markers in ONE transaction (crash
                # between them would desync applied state from the log view).
                self.db.conn.execute("DELETE FROM committed_states")
                self.db.conn.executemany(
                    "INSERT OR REPLACE INTO committed_states "
                    "(state_ref, consuming, crc) VALUES (?, ?, ?)",
                    [(ref, con, _integrity.committed_crc(
                        bytes(ref), bytes(con)))
                     for ref, con in entries])
                self.db.conn.execute("DELETE FROM reserved_states")
                self.db.conn.executemany(
                    "INSERT OR REPLACE INTO reserved_states "
                    "(state_ref, tx_id, expires_at, crc) "
                    "VALUES (?, ?, ?, ?)",
                    [(bytes(ref), bytes(tx), float(exp),
                      _integrity.reserved_crc(
                          bytes(ref), bytes(tx), float(exp)))
                     for ref, tx, exp in snap.reservations])
                self._entry_cache.clear()
                self._blob_cache.clear()
                self.db.conn.execute("DELETE FROM raft_log")
                for key, value in (
                        ("raft_snapshot_index",
                         str(snap.last_included_index)),
                        ("raft_snapshot_term",
                         str(snap.last_included_term)),
                        ("raft_commit_index", str(new_commit)),
                        ("raft_last_applied",
                         str(snap.last_included_index))):
                    self.db.conn.execute(
                        "INSERT OR REPLACE INTO settings (key, value) "
                        "VALUES (?, ?)", (key, value))
                self.db.commit()
            self.last_applied = snap.last_included_index
            self.commit_index = new_commit
            self.snapshot_index = snap.last_included_index
            self.snapshot_term = snap.last_included_term
            # Pipelined plane: the enqueue cursor must never trail a
            # snapshot-installed last_applied (the log prefix it pointed
            # into was just replaced). Stale queued items drain harmlessly:
            # their rows are part of the installed snapshot state and the
            # drain never moves last_applied backwards.
            self._applied_enqueued = max(self._applied_enqueued,
                                         self.last_applied)
        self._send(sender, InstallSnapshotReply(
            self.term, self.name, snap.last_included_index))

    def _on_append(self, ae: AppendEntries, sender) -> None:
        if ae.term < self.term:
            self._send(sender, AppendReply(self.term, False, 0, self.name))
            return
        self._become_follower(ae.term, leader=ae.leader)
        # Leader-stickiness stamp (round 20): any valid append — heartbeat
        # or entries — counts as live-leader contact for _on_prevote.
        self._last_leader_contact = self.clock()
        local_prev = self._log_term_at(ae.prev_index)
        if local_prev is None or local_prev != ae.prev_term:
            self._send(sender, AppendReply(
                self.term, False, 0, self.name,
                hint_index=self._log_last()[0]))
            return
        idx = ae.prev_index
        try:
            for term, blob in ae.entries:
                idx += 1
                existing = self._log_term_at(idx)
                if existing is not None and existing != term:
                    self._log_truncate_from(idx)
                    existing = None
                if existing is None:
                    # The wire carries the leader's encoded blob: insert it
                    # verbatim (no decode on the replication hot path).
                    self._log_append_blob(idx, term, blob)
        except sqlite3.OperationalError as e:
            if not _integrity.is_disk_full(e):
                raise
            # Graceful disk exhaustion on the follower append path: the
            # entries landed up to a verified prefix; reply failure with an
            # honest hint so the leader rewinds and retries later, instead
            # of crashing the member out of the quorum.
            self.metrics["disk_degraded"] += 1
            self._send(sender, AppendReply(
                self.term, False, 0, self.name,
                hint_index=self._log_last()[0]))
            return
        if ae.leader_commit > self.commit_index:
            # Raft §5.3: commit only up to the VERIFIED prefix — the index of
            # the last entry THIS append confirmed (prev + entries) — never
            # the whole local log, which may hold stale divergent entries a
            # prev=0 keepalive did not vouch for.
            self.commit_index = max(self.commit_index,
                                    min(ae.leader_commit, idx))
            self._apply_committed()
        self._send(sender, AppendReply(self.term, True, idx, self.name))

    def _on_append_reply(self, ar: AppendReply) -> None:
        if ar.term > self.term:
            self._become_follower(ar.term)
            return
        if self.role != "leader":
            return
        # Check-quorum stamp (round 20): ANY append reply — success or
        # divergence backoff — proves the peer is reachable.
        self._peer_contact[ar.follower] = self.clock()
        if ar.success:
            # Monotone: a success for an EARLIER position (e.g. the prev=0
            # keepalive heartbeat used during snapshot transfer) must not
            # move match/next backwards.
            match = max(self._match_index.get(ar.follower, 0), ar.match_index)
            self._match_index[ar.follower] = match
            self._next_index[ar.follower] = max(
                self._next_index.get(ar.follower, 1), match + 1)
            # The pipeline stream stays ahead of (or at) the acked position.
            self._sent_index[ar.follower] = max(
                self._sent_index.get(ar.follower, 0), match)
            self._backoff.pop(ar.follower, None)
            self._advance_commit()
        else:
            nxt = self._next_index.get(ar.follower, 1)
            if ar.hint_index >= 0 and ar.hint_index < nxt - 1:
                # Jump straight past what the follower actually has (covers
                # an empty-log follower — hint 0 — one freshly snapshot-
                # installed beyond our compaction point, AND one that lost
                # its disk: no clamping against match_index here, because a
                # wiped follower's truth supersedes our stale bookkeeping).
                nxt = ar.hint_index + 1
                self._backoff.pop(ar.follower, None)
            else:
                # Hint-less (or useless-hint) divergence: back off by a
                # per-peer window that DOUBLES each consecutive failure —
                # O(log tail) round trips to converge instead of the old
                # decrement-by-one's O(tail).
                step = self._backoff.get(ar.follower, 1)
                self._backoff[ar.follower] = min(
                    step * 2, self.config.append_chunk)
                nxt = max(1, nxt - step)
            self._next_index[ar.follower] = nxt
            # Rewind the stream: everything past the new next_index must be
            # re-sent once the divergence point is found.
            self._sent_index[ar.follower] = nxt - 1

    _forward_replies: dict

    def _on_client_commit(self, cc: ClientCommit) -> None:
        if self.role == "leader":
            if not hasattr(self, "_forward_replies"):
                self._forward_replies = {}
            # Remember where to send the decision, then replicate.
            self._forward_replies[cc.command.request_id] = cc.reply_to
            self.submit(cc.command)
        else:
            # Not the leader anymore: bounce with a hint so the origin
            # re-routes after its next ticks. The origin may live in ANOTHER
            # Raft group (a cross-shard 2PC coordinator) — resolve beyond
            # this group's peers.
            addr = self._peer_addr(cc.reply_to)
            if addr is not None:
                self._send(addr, ClientReply(
                    cc.command.request_id, False, None, self.leader_name))

    def _advance_commit(self) -> None:
        if self.role != "leader":
            return
        prev_commit = self.commit_index
        last_idx, _ = self._log_last()
        for n in range(self.commit_index + 1, last_idx + 1):
            votes = 1 + sum(
                1 for m in self._match_index.values() if m >= n)
            if votes * 2 > len(self.peers) + 1 and \
                    self._log_term_at(n) == self.term:
                self.commit_index = n
        if self.commit_index > prev_commit:
            # Replication RTT: first broadcast of an entry -> quorum commit.
            now = self.clock()
            for n in range(prev_commit + 1, self.commit_index + 1):
                t0 = self._bcast_at.pop(n, None)
                if t0 is not None:
                    self.metrics["replication_rtt_s"] += now - t0
                    self.metrics["replication_rtt_n"] += 1
                    if _obs.ACTIVE is not None:
                        members = self._trace_members.pop(n, None)
                        if members:
                            # The RTT clock is monotonic; re-anchor the span
                            # onto the epoch timeline ending now.
                            epoch = _obs.now()
                            _obs.record(
                                "replication", epoch - (now - t0), epoch,
                                attrs={"member_traces": members, "idx": n})
                    else:
                        self._trace_members.pop(n, None)
        self._apply_committed()

    def _record_decision(self, request_id: bytes, reply: ClientReply) -> None:
        self.decided[request_id] = reply
        while len(self.decided) > self._decided_cap:
            self.decided.pop(next(iter(self.decided)))

    def _build_reply(self, cmd, outcome) -> ClientReply:
        """Map an apply outcome to the client's decision frame."""
        if outcome is BUSY:
            # Reserved by another unexpired 2PC: the retryable bounce
            # form (ok=False, conflict=None) — the submitting poller
            # resubmits with a fresh issued_at until the hold
            # resolves or expires.
            return ClientReply(cmd.request_id, False, None,
                               self.leader_name)
        if outcome is WRONG_EPOCH:
            # Reshard fence: this group no longer/not yet owns the
            # refs. Retryable, but ONLY after the submitter
            # re-derives the shard directory — the flag tells its
            # poller to stop resubmitting here.
            return ClientReply(cmd.request_id, False, None,
                               self.leader_name, wrong_epoch=True)
        return ClientReply(cmd.request_id, outcome is None,
                           outcome, self.leader_name)

    def _entry_commands(self, idx: int):
        """The next committed entry's command tuple, or None if the entry
        at *idx* is unavailable (raced compaction / corruption heal)."""
        entries = self._log_entries_from(idx, limit=1)
        if not entries or entries[0][0] != idx:
            return None
        entry = entries[0][2]
        return (entry.commands if isinstance(entry, PutAllBatch)
                else (entry,) if entry is not None else ())

    def _apply_committed(self) -> None:
        if self.config.pipeline and self.config.apply_queue_depth > 0:
            # Pipelined commit plane: hand the committed tail to the apply
            # executor and fold in whatever it has already finished. The
            # consensus thread returns to sealing/replicating the next
            # round while per-tx sqlite work runs on the executor.
            self._enqueue_committed()
            self._drain_apply_results()
            return
        applied_any = False
        # Replies for commands whose origin is another member coalesce into
        # ONE multi-outcome frame per destination for the whole apply pass.
        outbound: dict[str, list[ClientReply]] = {}
        while self.last_applied < self.commit_index:
            # Read FIRST, advance after: if the next entry is missing (raced
            # compaction) or corrupt (heal truncated it out from under us),
            # last_applied must still name the last entry whose effects are
            # durably in committed_states — the heal path's "idx <=
            # last_applied" compact-vs-truncate decision depends on it.
            commands = self._entry_commands(self.last_applied + 1)
            if commands is None:
                break
            self.last_applied += 1
            self._applied_enqueued = max(self._applied_enqueued,
                                         self.last_applied)
            applied_any = True
            for cmd in commands:
                # Per-request conflict isolation: each command in a group-
                # commit batch runs the first-committer-wins check on its
                # own — one double-spend rejects alone, its batch siblings
                # commit normally.
                reply = self._build_reply(cmd, self.apply_command(cmd))
                self._settle_decision(cmd, reply, outbound)
        self._flush_outbound_replies(outbound)
        if applied_any:  # no idle-heartbeat sqlite churn
            with self.db.lock:  # foreign-thread writers share one conn
                self.db.set_setting("raft_commit_index",
                                    str(self.commit_index))
                self.db.set_setting("raft_last_applied",
                                    str(self.last_applied))
            self.maybe_compact()

    def _settle_decision(self, cmd, reply: ClientReply,
                         outbound: dict) -> None:
        """Consensus-thread decision bookkeeping for one applied command:
        record, un-dedupe, unlink QoS, route a forwarded origin's reply
        into the per-destination coalescing buffer."""
        self._record_decision(cmd.request_id, reply)
        self._appending.discard(cmd.request_id)
        if _qos.ACTIVE is not None:
            _qos.ACTIVE.pop_link(cmd.request_id)
        fwd = getattr(self, "_forward_replies", {}).pop(
            cmd.request_id, None)
        if fwd is not None and self._peer_addr(fwd) is not None:
            outbound.setdefault(fwd, []).append(reply)

    def _flush_outbound_replies(self, outbound: dict) -> None:
        for fwd, replies in outbound.items():
            self.metrics["reply_frames"] += 1
            self.metrics["reply_commands"] += len(replies)
            if len(replies) == 1:
                self._send(self._peer_addr(fwd), replies[0])
            else:
                self._send(self._peer_addr(fwd),
                           ClientReplyBatch(tuple(replies)))

    # -- pipelined apply executor (round 18) -------------------------------

    def _ensure_executor(self) -> _queue.Queue:
        if self._apply_thread is None or not self._apply_thread.is_alive():
            self._apply_queue = _queue.Queue(
                maxsize=self.config.apply_queue_depth)
            self._apply_thread = threading.Thread(
                target=self._executor_loop, args=(self._apply_queue,),
                name=f"raft-apply-{self.name}", daemon=True)
            self._apply_thread.start()
        return self._apply_queue

    def _executor_loop(self, q: _queue.Queue) -> None:
        """Apply-executor thread body: state apply (sqlite work under
        db.lock — the I/O serialization lock, by design) and client-reply
        construction, off the consensus thread. Items complete strictly in
        queue order; an apply exception parks the error for the consensus
        thread and exits (the entry re-applies idempotently after the
        executor is rebuilt). perf_counter here is telemetry only (the
        overlap accumulator) — apply determinism never reads a clock."""
        while True:
            item = q.get()
            if item is None:  # shutdown sentinel (tests)
                q.task_done()
                return
            idx, commands = item
            t0 = _time.perf_counter()
            replies, err = None, None
            try:
                if len(commands) > 1 and self._commit_many is not None:
                    outcomes = self._commit_many(commands)
                else:
                    outcomes = [self.apply_command(c) for c in commands]
                replies = tuple(self._build_reply(c, o)
                                for c, o in zip(commands, outcomes))
            except BaseException as e:  # surfaces on the consensus thread
                err = e
            self.overlap_s["apply"] += _time.perf_counter() - t0
            self.metrics["apply_batches"] += 1
            if _tm.ACTIVE is not None:
                _tm.inc("raft_apply_batches_total")
                _tm.observe("raft_apply_batch_commands", len(commands))
            self._apply_results.append((idx, commands, replies, err))
            q.task_done()
            if err is not None:
                return  # stop in order; successors re-enqueue after reset

    def _enqueue_committed(self) -> None:
        """Feed the bounded commit queue from the committed-but-unapplied
        log tail. A full queue just stops the feed — committed entries are
        durable in the log and the next tick resumes where this left off."""
        if self._applied_enqueued >= self.commit_index:
            return
        q = self._ensure_executor()
        while self._applied_enqueued < self.commit_index:
            if q.full():
                break
            commands = self._entry_commands(self._applied_enqueued + 1)
            if commands is None:
                break
            self._applied_enqueued += 1
            q.put((self._applied_enqueued, tuple(commands)))

    def _drain_apply_results(self) -> None:
        """Fold finished executor items back into consensus state, in
        order: advance last_applied, record decisions, coalesce forwarded
        replies — all single-threaded bookkeeping stays on this thread."""
        results = self._apply_results
        if not results:
            return
        applied_any = False
        err = None
        outbound: dict[str, list[ClientReply]] = {}
        while results:
            idx, commands, replies, item_err = results.popleft()
            if item_err is not None:
                err = item_err
                break
            # Never regress past a snapshot install that superseded queued
            # items (their rows are part of the installed state).
            if idx > self.last_applied:
                self.last_applied = idx
                applied_any = True
            for cmd, reply in zip(commands, replies):
                self._settle_decision(cmd, reply, outbound)
        self._flush_outbound_replies(outbound)
        if applied_any:
            # The executor thread may be mid-transaction applying the NEXT
            # entry on the same sqlite connection — settings writes must
            # serialize through db.lock like every other foreign-thread
            # write, or the two implicit BEGINs collide.
            with self.db.lock:
                self.db.set_setting("raft_commit_index",
                                    str(self.commit_index))
                self.db.set_setting("raft_last_applied",
                                    str(self.last_applied))
            self.maybe_compact()
        if err is not None:
            # The failed entry (and any queued successors) re-apply
            # idempotently from the durable log through a fresh executor;
            # the error itself surfaces exactly like the serial path's.
            self._apply_thread = None
            self._apply_queue = None
            self._apply_results.clear()
            self._applied_enqueued = self.last_applied
            raise err

    def apply_backlog(self) -> int:
        """Committed-but-unapplied entries (durable in the log; drains as
        the executor catches up)."""
        return max(0, self.commit_index - self.last_applied)

    def apply_overloaded(self) -> bool:
        """True when the bounded commit queue is full — the admission
        signal that sheds NEW submissions with a retryable overload bounce
        (in-flight and committed work is never shed)."""
        q = self._apply_queue
        return q is not None and q.full()

    def quiesce_apply(self, timeout: float = 5.0) -> None:
        """Drain the pipelined plane to a fixpoint: every enqueued entry
        applied AND its results folded back on the calling (consensus)
        thread. Tests and deterministic harnesses call this where the
        serial path was synchronous by construction."""
        if self._apply_queue is None:
            return
        deadline = _time.monotonic() + timeout
        while True:
            self._drain_apply_results()
            if self.last_applied >= self._applied_enqueued:
                return
            if _time.monotonic() >= deadline:
                raise TimeoutError(
                    f"apply executor stalled: enqueued="
                    f"{self._applied_enqueued} applied={self.last_applied}")
            _time.sleep(0.0005)

    def stamp(self) -> dict:
        """Self-describing replication stamp (plain JSON types only):
        exported via node_metrics -> loadtest node_stamps -> the bench raft
        open-loop section, so every trend line records how the commit
        pipeline actually behaved (round-4 verdict: un-stamped numbers made
        cross-round comparison a trap)."""
        m = self.metrics
        sealed = m["group_commits"] + m["solo_commits"]
        commands = m["group_commands"] + m["solo_commits"]
        frames = m["reply_frames"]
        rtt_n = m["replication_rtt_n"]
        (reserved,) = self.db.conn.execute(
            "SELECT COUNT(*) FROM reserved_states").fetchone()
        (committed,) = self.db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        return {
            "role": self.role,
            "term": self.term,
            "commit_index": self.commit_index,
            # Durable spent-input rows on THIS member — the ledger side of
            # the cross-process exactly-once audit (each consumed ref is
            # one row; loadtest sums max-over-members per shard group).
            "committed_states": committed,
            # Live 2PC holds — a drained workload must show 0 here (leaked
            # reservations would mean wedged inputs; TTL abort is the
            # backstop, this stamp is how audits see it worked).
            "reserved_states": reserved,
            "group_commit": self.config.group_commit,
            "group_commits": m["group_commits"],
            "group_commands": m["group_commands"],
            # Commands committed per sealed log entry (solo entries count 1)
            # — > 1 means group commit actually amortized the burst.
            "entries_per_batch": (round(commands / sealed, 3)
                                  if sealed else None),
            "append_frames": m["append_frames"],
            "append_entries_sent": m["append_entries_sent"],
            "reply_frames": frames,
            "reply_commands": m["reply_commands"],
            "reply_coalesce_ratio": (round(m["reply_commands"] / frames, 3)
                                     if frames else None),
            "forward_frames": m["forward_frames"],
            "forward_commands": m["forward_commands"],
            # QoS plane: scheduling rounds sealed early because a buffered
            # interactive entry neared its SLO deadline (0 when disarmed).
            "qos_early_seals": m["qos_early_seals"],
            # Durability plane: corruption detections, the self-healing
            # actions they triggered, and disk-full degrades — all 0 on a
            # healthy store; the bitrot chaos audit asserts the first is > 0.
            "integrity_errors": m["integrity_errors"],
            "log_truncations": m["log_truncations"],
            "leader_stepdowns": m["leader_stepdowns"],
            "disk_degraded": m["disk_degraded"],
            # Partition plane (round 20): prevote canvass traffic and
            # check-quorum cessions (0 with the flag off); elections_won +
            # term are the A/B observables the partition_chaos bench reads
            # for term inflation across a cut/heal cycle.
            "prevote": bool(self.config.prevote),
            "prevotes": m["prevotes"],
            "prevote_rejections": m["prevote_rejections"],
            "checkquorum_stepdowns": m["checkquorum_stepdowns"],
            "elections_won": m["elections_won"],
            "replication_rtt_ms_avg": (
                round(1e3 * m["replication_rtt_s"] / rtt_n, 3)
                if rtt_n else None),
            # Leader seal-path wall time by phase (the round profiler's
            # seal/replicate/apply split, summed over every flush).
            "phase_s": {k: round(v, 6) for k, v in self.phase_s.items()},
            # Pipelined commit plane (round 18): whether rounds overlap and
            # how the detached apply executor behaved — the doctor's rule
            # table branches on `pipeline` so a "rounds" verdict suggests
            # executor-side experiments instead of re-suggesting round-loop
            # amortization.
            "pipeline": bool(self.config.pipeline),
            "apply_queue_depth": self.config.apply_queue_depth,
            "commit_many": self._commit_many is not None,
            "midround_seals": m["midround_seals"],
            "apply_batches": m["apply_batches"],
            "apply_shed": m["apply_shed"],
            "apply_backlog": self.apply_backlog(),
            # Executor wall time overlapped under the consensus thread's
            # seal/replicate (NOT part of phase_s — coverage stays honest).
            "overlap_s": {k: round(v, 6) for k, v in self.overlap_s.items()},
        }


from ...utils.excheckpoint import register_flow_exception


@register_flow_exception
class CommitTimeoutException(UniquenessUnavailableException):
    """The cluster could not commit within the deadline (no quorum/leader).
    Distinct from UniquenessException: a timeout is retriable, a conflict is
    final — surfacing one as the other would tell a client its transaction
    double-spent when the cluster was merely degraded. Whitelisted for typed
    checkpoint replay so flows can branch on it live and post-restore."""


@register_flow_exception
class CommitQueueFullException(UniquenessUnavailableException):
    """The leader's bounded commit queue (the pipelined apply executor's
    admission point, [raft] apply_queue_depth) is full: NEW submissions
    shed instead of growing an unbounded committed-but-unapplied backlog.
    Retryable after a short backoff — says nothing about the transaction
    itself. The notary flow surfaces it as OverloadedError("commit") so
    clients reuse the QoS plane's shed-retry handling."""

    RETRY_AFTER_MS = 50.0


@register_flow_exception
class WrongShardEpochException(UniquenessUnavailableException):
    """The group bounced the command off a reshard fence: under the shard
    map the group currently enforces, it does not own (some of) the touched
    StateRefs. Retryable — but unlike a leaderless bounce, resubmitting to
    the SAME group can never succeed. The caller must re-derive the shard
    directory (network map) and route to the owning group at the new epoch.
    Subclasses UniquenessUnavailableException so catch sites that predate
    resharding still treat it as a retriable non-conflict."""


class RaftUniquenessProvider(UniquenessProvider):
    """UniquenessProvider facade over a RaftMember (reference:
    RaftUniquenessProvider.kt:44-115 — commit() submits PutAll and waits for
    the replicated state machine's verdict).

    The flow-facing path is commit_async(): it returns a poll callable the
    node's run loop drives (ServiceRequest suspension), so a notary flow
    never blocks the message pump that consensus itself rides on. The
    synchronous commit() exists for direct/production use where the caller
    may block while a pump callable runs the node."""

    RESUBMIT_EVERY = 0.5  # sec; re-offer after leader changes (idempotent)

    def __init__(self, member: RaftMember, pump: Callable[[], None],
                 timeout: float = 25.0):
        # 25 s, not 10: the commit poll RESUBMITS through leader changes
        # (idempotent request ids), so the window only bounds how long a
        # caller waits out cluster unavailability. Measured leaderless
        # blips under a coarse scheduler (an election churn episode plus
        # redelivery backoff) recover in 10-20 s — a 10 s window turned
        # exactly those transients into spurious tx rejections.
        self.member = member
        self._pump = pump  # drives messaging + raft ticks while waiting
        self.timeout = timeout

    def commit_async(self, states: Sequence, tx_id: SecureHash,
                     caller_identity: Party) -> Callable[[], bool | None]:
        # Hot path: `os` is imported at module top (an import inside here
        # paid a sys.modules lookup per notarisation). The refs tuple is
        # built ONCE; each RESUBMIT_EVERY re-offer re-stamps issued_at on
        # the same request_id (idempotent across leader changes) — a frozen
        # stamp would stay parked behind an expired reservation forever,
        # because expiry is judged against the command's own stamp, never a
        # replica clock (see PutAllCommand.issued_at).
        request_id = os.urandom(16)
        refs = tuple(states)
        state = {"deadline": _time.monotonic() + self.timeout,
                 "submitted_at": 0.0}
        ctx = _obs.get_context() if _obs.ACTIVE is not None else None
        if ctx is not None:
            # Link map: lets the leader's batch seal attribute this entry
            # back to the submitting flow's trace without widening the
            # consensus API. t0 anchors the per-tx raft_commit span.
            _obs.register_link(request_id, ctx[0], ctx[1])
            state["trace_t0"] = _obs.now()
        qctx = _qos.get_context() if _qos.ACTIVE is not None else None
        if qctx is not None:
            # QoS link map, same shape as the trace link: lets the leader's
            # deadline-aware seal (and a forwarding follower) see this
            # request's lane/deadline without widening the consensus API.
            _qos.ACTIVE.register_link(request_id, qctx)

        def poll():
            now = _time.monotonic()
            reply = self.member.decided.pop(request_id, None)
            if reply is not None:
                decided = (reply.ok or reply.conflict is not None
                           or reply.wrong_epoch)
                if decided and ctx is not None and _obs.ACTIVE is not None:
                    # submit -> decision, stitched under the notary flow.
                    # (A leaderless bounce is not a decision: the command
                    # resubmits below and the span stays open.)
                    _obs.record(
                        "raft_commit", state.get("trace_t0", _obs.now()),
                        _obs.now(), trace_id=ctx[0], parent=ctx[1],
                        attrs={"ok": bool(reply.ok)})
                    _obs.pop_link(request_id)
                if decided and _qos.ACTIVE is not None:
                    _qos.ACTIVE.pop_link(request_id)
                if reply.ok:
                    return True
                if reply.conflict is not None:
                    raise UniquenessException(reply.conflict)
                if reply.wrong_epoch:
                    # Reshard fence bounce: this group no longer (or does
                    # not yet) own the refs. Resubmitting here is futile —
                    # surface so the client re-derives the directory.
                    raise WrongShardEpochException(
                        f"group fenced off {tx_id} (reshard in progress; "
                        f"re-derive the shard directory)")
                state["submitted_at"] = 0.0  # no leader yet: resubmit below
            if now >= state["deadline"]:
                raise CommitTimeoutException(
                    f"raft commit of {tx_id} not decided within "
                    f"{self.timeout}s (leader: {self.member.leader_name})")
            if (state["submitted_at"] == 0.0
                    or now - state["submitted_at"] >= self.RESUBMIT_EVERY):
                if (state["submitted_at"] == 0.0
                        and self.member.apply_overloaded()):
                    # Admission-point backpressure: only a NOT-in-flight
                    # (re)submission sheds — a command already replicating
                    # keeps polling for its decision.
                    raise CommitQueueFullException(
                        f"commit queue full shedding {tx_id} "
                        f"(leader: {self.member.leader_name})")
                self.member.submit(PutAllCommand(
                    refs, tx_id, caller_identity, request_id,
                    # lint: allow(no-wallclock-in-apply) coordinator stamping site: resubmission re-stamps on the submitting node; replicas only ever see the carried value
                    issued_at=_time.time()))
                state["submitted_at"] = now
            return None

        return poll

    def commit(self, states: Sequence, tx_id: SecureHash,
               caller_identity: Party) -> None:
        poll = self.commit_async(states, tx_id, caller_identity)
        while True:
            outcome = poll()
            if outcome is not None:
                return
            self._pump()

    @property
    def committed_count(self) -> int:
        (n,) = self.member.db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        return n

    def leader_hint(self) -> str | None:
        """Legal name of the member this replica believes leads the cluster
        (None during elections) — attached to NotaryUnavailable replies so
        retrying clients can skip a redirect round trip."""
        return self.member.leader_name


def make_apply_command(db) -> Callable[[Any], Any]:
    """The replicated state machine's apply step: first-committer-wins over
    the same committed_states table as the single-node provider, extended
    with the cross-shard 2PC commands (Reserve / CommitReserved /
    AbortReserved — services/sharding.py). Idempotent for re-applied entries
    (same tx claims same refs -> no conflict).

    Outcomes: None (ok), UniquenessConflict (final), BUSY (reserved by
    another unexpired tx — retryable). DETERMINISM INVARIANT: every branch
    below depends only on the command's own fields and replicated table
    state — never on a local clock — so replicas applying the same log
    prefix always agree (reservation expiry compares the command's
    issued_at stamp against the stored expires_at)."""
    # Lazy import: sharding imports raft at module level (commands,
    # RaftMember), so the shard hash comes in at closure-build time instead
    # of creating an import cycle. One definition, two layers.
    from .sharding import shard_of

    with db.lock:
        # The member normally creates this table, but apply closures are
        # built before RaftMember.__init__ runs its schema script.
        db.conn.executescript(_RAFT_SCHEMA)
        _integrity.ensure_integrity_schema(db.conn)
        db.conn.commit()
        raw = db.get_setting("shard_fence")
    # Reshard fence, cached across applies and persisted in settings so a
    # restarted member rebuilds it BEFORE replaying the log (replay then
    # re-installs the same fences idempotently — never-downgrade below).
    fence: dict[str, Any] = {"state": json.loads(raw) if raw else None}
    # Fence modes outrank each other within an epoch (a retried "seal" must
    # not regress an already-activated cutover); a higher epoch always wins.
    _RANK = {"sealed": 1, "importing": 1, "active": 2, "retired": 2}

    def _set_fence(state: dict) -> None:
        fence["state"] = state
        db.set_setting("shard_fence", json.dumps(state))

    def _fence_bounce(refs):
        """WRONG_EPOCH iff the installed fence says some ref is not (or is
        no longer) this group's to serve; None = proceed. Pure function of
        the fence record + ref hashes — no clocks, no local state."""
        f = fence["state"]
        if not f:
            return None
        mode = f["mode"]
        if mode == "sealed":
            # Handoff in progress: the keyspace MOVING to another group is
            # frozen at the seal's log position; refs this group keeps
            # under the new epoch commit straight through (no outage for
            # the unmoved majority).
            cnt, g = f["to_count"], f["group"]
            if g >= cnt:  # retiring group (merge): everything is moving
                return WRONG_EPOCH
            for ref in refs:
                if shard_of(ref, cnt) != g:
                    return WRONG_EPOCH
            return None
        if mode in ("importing", "retired"):
            # importing: half-installed ledger — a racing new-epoch client
            # must retry until the coordinator activates us. retired: a
            # merged-away group never serves again.
            return WRONG_EPOCH
        # mode == "active": epoch installed. Bounce refs we don't own so a
        # stale-directory client re-derives instead of committing against
        # the wrong group's ledger (the split sibling has its history).
        cnt, g = f["count"], f["group"]
        for ref in refs:
            if shard_of(ref, cnt) != g:
                return WRONG_EPOCH
        return None

    def _committed_conflicts(conn, refs, tx_id) -> dict:
        conflicts = {}
        for ref in refs:
            row = conn.execute(
                "SELECT consuming FROM committed_states WHERE state_ref = ?",
                (serialize(ref).bytes,)).fetchone()
            if row is not None:
                consuming = deserialize(bytes(row[0]))
                if consuming.id != tx_id:
                    conflicts[ref] = consuming
        return conflicts

    def _blocked_by_reservation(conn, refs, tx_id, issued_at) -> bool:
        """True iff some ref is held by a DIFFERENT tx whose hold has not
        expired relative to this command's stamp (issued_at < expires_at;
        issued_at >= expires_at is the deterministic steal)."""
        for ref in refs:
            row = conn.execute(
                "SELECT tx_id, expires_at FROM reserved_states "
                "WHERE state_ref = ?", (serialize(ref).bytes,)).fetchone()
            if row is not None and bytes(row[0]) != tx_id.bytes \
                    and issued_at < float(row[1]):
                return True
        return False

    def _apply_put_all(cmd: PutAllCommand):
        with db.lock:
            conn = db.conn
            bounced = _fence_bounce(cmd.refs)
            if bounced is not None:
                return bounced
            conflicts = _committed_conflicts(conn, cmd.refs, cmd.tx_id)
            if conflicts:
                return UniquenessConflict(conflicts)
            if _blocked_by_reservation(conn, cmd.refs, cmd.tx_id,
                                       cmd.issued_at):
                return BUSY
            for i, ref in enumerate(cmd.refs):
                blob = serialize(ref).bytes
                consuming = serialize(
                    ConsumingTx(cmd.tx_id, i, cmd.caller)).bytes
                conn.execute(
                    "INSERT OR IGNORE INTO committed_states "
                    "(state_ref, consuming, crc) VALUES (?, ?, ?)",
                    (blob, consuming,
                     _integrity.committed_crc(blob, consuming)))
                # Clear any hold the commit supersedes (our own retried
                # reserve, or an expired one we just stole past).
                conn.execute(
                    "DELETE FROM reserved_states WHERE state_ref = ?",
                    (blob,))
            db.commit()
            return None

    def _apply_reserve(cmd: ReserveCommand):
        with db.lock:
            conn = db.conn
            bounced = _fence_bounce(cmd.refs)
            if bounced is not None:
                return bounced
            conflicts = _committed_conflicts(conn, cmd.refs, cmd.tx_id)
            if conflicts:
                return UniquenessConflict(conflicts)
            if _blocked_by_reservation(conn, cmd.refs, cmd.tx_id,
                                       cmd.issued_at):
                return BUSY
            expires = cmd.issued_at + cmd.ttl_s
            for ref in cmd.refs:
                # REPLACE: refreshes our own hold on a retried reserve and
                # deterministically steals an expired foreign one.
                blob = serialize(ref).bytes
                conn.execute(
                    "INSERT OR REPLACE INTO reserved_states "
                    "(state_ref, tx_id, expires_at, crc) VALUES (?, ?, ?, ?)",
                    (blob, cmd.tx_id.bytes, expires,
                     _integrity.reserved_crc(blob, cmd.tx_id.bytes, expires)))
            db.commit()
            return None

    def _apply_commit_reserved(cmd: CommitReservedCommand):
        with db.lock:
            conn = db.conn
            bounced = _fence_bounce(cmd.refs)
            if bounced is not None:
                return bounced
            conflicts = _committed_conflicts(conn, cmd.refs, cmd.tx_id)
            if conflicts:
                return UniquenessConflict(conflicts)
            for i, ref in enumerate(cmd.refs):
                blob = serialize(ref).bytes
                consuming = serialize(
                    ConsumingTx(cmd.tx_id, i, cmd.caller)).bytes
                conn.execute(
                    "INSERT OR IGNORE INTO committed_states "
                    "(state_ref, consuming, crc) VALUES (?, ?, ?)",
                    (blob, consuming,
                     _integrity.committed_crc(blob, consuming)))
                conn.execute(
                    "DELETE FROM reserved_states WHERE state_ref = ?",
                    (blob,))
            db.commit()
            return None

    def _apply_abort(cmd: AbortReservedCommand):
        with db.lock:
            for ref in cmd.refs:
                db.conn.execute(
                    "DELETE FROM reserved_states "
                    "WHERE state_ref = ? AND tx_id = ?",
                    (serialize(ref).bytes, cmd.tx_id.bytes))
            db.commit()
            return None

    def _apply_fence(cmd: ShardFenceCommand):
        new_mode = ("sealed" if cmd.mode == "seal"
                    else "retired" if cmd.group >= cmd.to_count
                    else "active")
        with db.lock:
            f = fence["state"]
            if f and ((f["epoch"], _RANK.get(f["mode"], 0))
                      >= (cmd.epoch, _RANK[new_mode])):
                return None  # coordinator retry / replay: never downgrade
            _set_fence({"epoch": cmd.epoch, "group": cmd.group,
                        "from_count": cmd.from_count,
                        "to_count": cmd.to_count, "count": cmd.to_count,
                        "mode": new_mode})
            # Activation purges rows the group no longer owns. Safe: the
            # coordinator activates the TARGET before the source, so by the
            # time a source applies "active"/"retired" the moved rows are
            # durable on the target's quorum. Keeping them instead would
            # double-count the ledger audit (sum of per-group rows).
            if new_mode == "retired":
                db.conn.execute("DELETE FROM committed_states")
                db.conn.execute("DELETE FROM reserved_states")
            elif new_mode == "active":
                for table in ("committed_states", "reserved_states"):
                    gone = [
                        (bytes(row[0]),)
                        for row in db.conn.execute(
                            f"SELECT state_ref FROM {table}").fetchall()
                        if shard_of(deserialize(bytes(row[0])),
                                    cmd.to_count) != cmd.group]
                    if gone:
                        db.conn.executemany(
                            f"DELETE FROM {table} WHERE state_ref = ?",
                            gone)
            db.commit()
            return None

    def _apply_install(cmd: InstallShardStateCommand):
        with db.lock:
            conn = db.conn
            f = fence["state"]
            if not f or ((f["epoch"], _RANK.get(f["mode"], 0))
                         < (cmd.epoch, 1)):
                # First handoff frame fences the target as importing —
                # WRONG_EPOCH to everyone until the coordinator activates.
                _set_fence({"epoch": cmd.epoch, "group": cmd.group,
                            "from_count": cmd.from_count,
                            "to_count": cmd.to_count, "count": cmd.to_count,
                            "mode": "importing"})
            for blob, consuming in cmd.committed_rows:
                conn.execute(
                    "INSERT OR IGNORE INTO committed_states "
                    "(state_ref, consuming, crc) VALUES (?, ?, ?)",
                    (bytes(blob), bytes(consuming),
                     _integrity.committed_crc(bytes(blob), bytes(consuming))))
            for blob, tx_id, expires in cmd.reserved_rows:
                # OR IGNORE: a retried frame never clobbers, and the hold
                # keeps its original coordinator-stamped expires_at so the
                # TTL backstop carries across the handoff unchanged.
                conn.execute(
                    "INSERT OR IGNORE INTO reserved_states "
                    "(state_ref, tx_id, expires_at, crc) "
                    "VALUES (?, ?, ?, ?)",
                    (bytes(blob), bytes(tx_id), float(expires),
                     _integrity.reserved_crc(
                         bytes(blob), bytes(tx_id), float(expires))))
            db.commit()
            return None

    def _select_map(conn, table: str, cols: str, blobs):
        """state_ref -> row tuple over a set of refs, chunked under
        sqlite's bound-parameter limit. One (or a few) set-wide SELECTs
        replace the serial path's per-ref probe."""
        out = {}
        blobs = list(blobs)
        for i in range(0, len(blobs), 500):
            chunk = blobs[i:i + 500]
            marks = ",".join("?" * len(chunk))
            for row in conn.execute(
                    f"SELECT state_ref, {cols} FROM {table} "
                    f"WHERE state_ref IN ({marks})", chunk):
                out[bytes(row[0])] = row[1:]
        return out

    def _put_all_many(cmds):
        """Columnar PutAll batch: outcomes and ledger rows byte-identical
        to applying each command in order, with the per-tx fixed costs
        amortized — serialization + CRC32C precomputed OUTSIDE db.lock
        (native _ccommit releases the GIL across the CRC batch), conflict/
        reservation probes collapsed to set-wide SELECT ... IN, and the
        inserts/deletes flushed through executemany. In-batch claims are
        tracked in the lookup maps so first-committer-wins ordering within
        the batch matches the serial replay exactly."""
        pre = []
        crc_pairs = []
        for cmd in cmds:
            ref_blobs = tuple(serialize(ref).bytes for ref in cmd.refs)
            cons_blobs = tuple(
                serialize(ConsumingTx(cmd.tx_id, i, cmd.caller)).bytes
                for i in range(len(cmd.refs)))
            pre.append((cmd, ref_blobs, cons_blobs))
            crc_pairs.extend(zip(ref_blobs, cons_blobs))
        crcs = _integrity.committed_crc_many(crc_pairs)
        crc_at = 0
        outcomes = []
        with db.lock:
            conn = db.conn
            all_refs = {rb for _c, rbs, _cb in pre for rb in rbs}
            committed = _select_map(
                conn, "committed_states", "consuming", all_refs)
            reserved = _select_map(
                conn, "reserved_states", "tx_id, expires_at", all_refs)
            ins_rows, del_rows = [], []
            for cmd, ref_blobs, cons_blobs in pre:
                cmd_crcs = crcs[crc_at:crc_at + len(ref_blobs)]
                crc_at += len(ref_blobs)
                bounced = _fence_bounce(cmd.refs)
                if bounced is not None:
                    outcomes.append(bounced)
                    continue
                conflicts = {}
                for ref, rb in zip(cmd.refs, ref_blobs):
                    got = committed.get(rb)
                    if got is None:
                        continue
                    if not isinstance(got, ConsumingTx):
                        got = deserialize(bytes(got[0]))
                        committed[rb] = got  # decode once per ref
                    if got.id != cmd.tx_id:
                        conflicts[ref] = got
                if conflicts:
                    outcomes.append(UniquenessConflict(conflicts))
                    continue
                busy = False
                for rb in ref_blobs:
                    held = reserved.get(rb)
                    if held is not None \
                            and bytes(held[0]) != cmd.tx_id.bytes \
                            and cmd.issued_at < float(held[1]):
                        busy = True
                        break
                if busy:
                    outcomes.append(BUSY)
                    continue
                for i, (rb, cb, crc) in enumerate(
                        zip(ref_blobs, cons_blobs, cmd_crcs)):
                    ins_rows.append((rb, cb, crc))
                    del_rows.append((rb,))
                    committed[rb] = ConsumingTx(cmd.tx_id, i, cmd.caller)
                    reserved.pop(rb, None)
                outcomes.append(None)
            if ins_rows:
                conn.executemany(
                    "INSERT OR IGNORE INTO committed_states "
                    "(state_ref, consuming, crc) VALUES (?, ?, ?)", ins_rows)
                conn.executemany(
                    "DELETE FROM reserved_states WHERE state_ref = ?",
                    del_rows)
            db.commit()
        return outcomes

    def apply(cmd):
        if isinstance(cmd, ReserveCommand):
            return _apply_reserve(cmd)
        if isinstance(cmd, CommitReservedCommand):
            return _apply_commit_reserved(cmd)
        if isinstance(cmd, AbortReservedCommand):
            return _apply_abort(cmd)
        if isinstance(cmd, ShardFenceCommand):
            return _apply_fence(cmd)
        if isinstance(cmd, InstallShardStateCommand):
            return _apply_install(cmd)
        return _apply_put_all(cmd)

    def apply_many(cmds):
        """Batch dispatcher (RaftMember._commit_many): consecutive runs of
        plain PutAllCommands take the columnar fast path; anything else
        (2PC / fence / install commands) flushes the run and applies
        one-at-a-time, preserving exact serial order."""
        outcomes = []
        run = []

        def _flush():
            if len(run) > 1:
                outcomes.extend(_put_all_many(tuple(run)))
            elif run:
                outcomes.append(_apply_put_all(run[0]))
            run.clear()

        for cmd in cmds:
            if type(cmd) is PutAllCommand:
                run.append(cmd)
            else:
                _flush()
                outcomes.append(apply(cmd))
        _flush()
        return outcomes

    apply.many = apply_many
    return apply
