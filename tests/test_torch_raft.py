"""The port's Raft commit log, elections and Raft notary cluster.

Ports of the JAX package's ``tests/test_raft_group_commit.py`` (the commit
pipeline over an in-process router: group commit, pipelined replication,
coalesced replies, the apply executor), ``tests/test_raft_prevote.py``
(pre-vote and check-quorum), ``tests/test_raft.py`` (a 3-member Raft
notary cluster of port ``Node``s over TCP and sqlite: commit, conflict,
leader kill, compaction and snapshot install) and the raft cases of
``tests/test_durability.py`` (the self-healing log, snapshot chunk CRCs,
disk exhaustion, the compaction crash window, the bitrot plan), each run
against ``corda_tpu_torch`` with verifier "cpu". The unit tiers inject the
clock and the message router, so no test leans on election timing under
load; the cluster tier waits for a leader with a bounded timeout.
"""

import json
import os
import sqlite3
import sys
import time
import types

import pytest

from corda_tpu_torch.contracts.structures import StateRef
from corda_tpu_torch.crypto.hashes import SecureHash
from corda_tpu_torch.crypto.keys import KeyPair
from corda_tpu_torch.crypto.party import Party
from corda_tpu_torch.crypto.provider import CpuVerifier
from corda_tpu_torch.flows.notary import NotaryClientFlow, NotaryException
from corda_tpu_torch.node.config import NodeConfig, RaftConfig
from corda_tpu_torch.node.messaging.tcp import _Outbox
from corda_tpu_torch.node.node import Node
from corda_tpu_torch.node.services import integrity as _integrity
from corda_tpu_torch.node.services.persistence import NodeDatabase
from corda_tpu_torch.node.services.raft import (
    AppendEntries,
    AppendReply,
    ClientReply,
    ClientReplyBatch,
    InstallSnapshot,
    PreVote,
    PutAllBatch,
    PutAllCommand,
    RaftMember,
    _snapshot_chunk_crc,
    make_apply_command,
)
from corda_tpu_torch.serialization.codec import deserialize, serialize
from corda_tpu_torch.testing import faults

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_tcp_node import (  # noqa: E402
    _package,
    issue_and_move,
    pump_until,
)

PARTY = Party("Client", KeyPair.generate(b"\x01" * 32).public.composite)


def cmd(ref_seed: bytes, tx_seed: bytes, rid: bytes) -> PutAllCommand:
    ref = StateRef(SecureHash.sha256(ref_seed), 0)
    return PutAllCommand((ref,), SecureHash.sha256(tx_seed), PARTY, rid)


class Net:
    """Synchronous in-process router: member name IS its address."""

    def __init__(self):
        self.handlers = {}
        self.queue = []

    def deliver_all(self):
        while self.queue:
            to, data, sender = self.queue.pop(0)
            handler = self.handlers.get(to)
            if handler is not None:
                handler(types.SimpleNamespace(data=data, sender=sender))


class FakeMessaging:
    def __init__(self, net: Net, addr: str):
        self.net, self.addr = net, addr
        self.sent = []  # (to, frame_bytes) — for wire-shape assertions

    def add_message_handler(self, topic, session_id, callback):
        self.net.handlers[self.addr] = callback

    def send(self, topic_session, data, to):
        self.sent.append((to, data))
        self.net.queue.append((to, data, self.addr))


def make_member(tmp_path, net, name, peers, clock, config=None):
    db = NodeDatabase(tmp_path / f"{name}.db")
    return RaftMember(name, peers, FakeMessaging(net, name), db,
                      make_apply_command(db), clock=clock, config=config)


def make_trio(tmp_path, net, clock, config=None):
    names = ("A", "B", "C")
    return {n: make_member(tmp_path, net, n,
                           {p: p for p in names if p != n}, clock, config)
            for n in names}


def elect(net, member, t):
    t[0] += 100.0  # past any election deadline; only `member` is ticked
    member.tick()
    net.deliver_all()  # votes out, replies back, victory broadcast handled
    assert member.role == "leader"


def settle(net, members, rounds=6):
    """Drive every member's round loop to quiescence. With the pipelined
    commit plane (round 18) state-apply runs on each member's executor
    thread, so each round must also quiesce the apply queues — and then
    deliver again, because draining results is what emits the coalesced
    ClientReply frames."""
    for _ in range(rounds):
        for m in members:
            m.flush_appends()
        net.deliver_all()
        for m in members:
            m.quiesce_apply()
        net.deliver_all()


def test_group_commit_seals_one_entry_with_conflict_isolation(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)

    # Two commands race for the same state ref; a third is independent.
    shared = StateRef(SecureHash.sha256(b"shared"), 0)
    c1 = PutAllCommand((shared,), SecureHash.sha256(b"tx1"), PARTY, b"r1")
    c2 = PutAllCommand((shared,), SecureHash.sha256(b"tx2"), PARTY, b"r2")
    c3 = cmd(b"free", b"tx3", b"r3")
    for c in (c1, c2, c3):
        leader.submit(c)
    (log_before,) = leader.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log").fetchone()
    leader.flush_appends()
    (log_after,) = leader.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log").fetchone()
    assert log_after == log_before + 1  # the whole round is ONE log entry
    (blob,) = leader.db.conn.execute(
        "SELECT blob FROM raft_log ORDER BY idx DESC LIMIT 1").fetchone()
    entry = deserialize(bytes(blob))
    assert isinstance(entry, PutAllBatch)
    assert [c.request_id for c in entry.commands] == [b"r1", b"r2", b"r3"]

    settle(net, members.values())
    # Per-request conflict isolation: the loser rejects ALONE.
    assert leader.decided[b"r1"].ok is True
    assert leader.decided[b"r2"].ok is False
    assert leader.decided[b"r2"].conflict is not None
    assert leader.decided[b"r3"].ok is True
    # Batched apply replicated identically on every member.
    for m in members.values():
        assert m.last_applied == leader.last_applied
        (n,) = m.db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        assert n == 2  # shared (first committer) + free

    stamp = leader.stamp()
    assert stamp["group_commits"] == 1
    assert stamp["group_commands"] == 3
    assert stamp["entries_per_batch"] == 3.0
    assert stamp["replication_rtt_ms_avg"] is not None
    json.dumps(stamp)  # the node_metrics contract: plain JSON types only


def test_leader_change_mid_batch_bounces_then_recommits(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    old = members["A"]
    elect(net, old, t)

    c1, c2 = cmd(b"s1", b"t1", b"r1"), cmd(b"s2", b"t2", b"r2")
    old.submit(c1)
    old.submit(c2)
    assert len(old._pending_batch) == 2

    # A higher term arrives before the round flushes: the buffered commands
    # were never sealed, so they must bounce (ok=False), not linger.
    old._become_follower(old.term + 1, leader="B")
    assert old._pending_batch == [] and not old._appending
    for rid in (b"r1", b"r2"):
        assert old.decided[rid].ok is False
        assert old.decided[rid].conflict is None  # retryable, not a conflict
    (log_len,) = old.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log").fetchone()
    assert log_len == 0  # nothing half-sealed survived the change

    # The client resubmits through the deposed member; the round's commands
    # forward to the new leader as ONE ClientCommitBatch and commit in the
    # submission order.
    new = members["B"]
    elect(net, new, t)
    old.decided.clear()
    old.submit(c1)
    old.submit(c2)
    old.flush_appends()
    settle(net, members.values())
    assert old.decided[b"r1"].ok is True
    assert old.decided[b"r2"].ok is True
    assert old.metrics["forward_frames"] == 1
    assert old.metrics["forward_commands"] == 2
    # The decisions came back coalesced: one multi-outcome frame.
    assert new.metrics["reply_frames"] == 1
    assert new.metrics["reply_commands"] == 2
    batches = [deserialize(f) for _to, f in new.messaging.sent
               if isinstance(deserialize(f), ClientReplyBatch)]
    assert len(batches) == 1
    assert {r.request_id for r in batches[0].replies} == {b"r1", b"r2"}
    # Order across the leader change: batch order == resubmission order.
    (blob,) = new.db.conn.execute(
        "SELECT blob FROM raft_log ORDER BY idx DESC LIMIT 1").fetchone()
    entry = deserialize(bytes(blob))
    assert [c.request_id for c in entry.commands] == [b"r1", b"r2"]


def test_reply_batch_redelivery_is_idempotent(tmp_path):
    net = Net()
    member = make_member(tmp_path, net, "A", {}, lambda: 0.0)
    batch = serialize(ClientReplyBatch((
        ClientReply(b"r1", True, None, "A"),
        ClientReply(b"r2", False, None, "A")))).bytes
    deliver = lambda: member._on_message(  # noqa: E731
        types.SimpleNamespace(data=batch, sender="X"))

    deliver()
    first = dict(member.decided)
    assert first[b"r1"].ok is True and first[b"r2"].ok is False
    # The transport is at-least-once: the SAME frame arrives again — both
    # before and after a waiting request consumed its decision.
    deliver()
    assert dict(member.decided) == first
    member.decided.pop(b"r1")  # a poll consumed its id (pops at most once)
    deliver()
    assert member.decided[b"r1"].ok is True  # re-recorded, nothing applied


def test_pipelined_broadcast_streams_tail_once_in_chunks(tmp_path):
    net, t = Net(), [0.0]
    member = make_member(
        tmp_path, net, "A", {"B": "B"}, lambda: t[0],
        config=RaftConfig(append_chunk=4, pipeline_window=8))
    # Leadership without an election dance: B never answers, so the stream
    # position is driven purely by _broadcast_append's own bookkeeping.
    member.role, member.leader_name, member.term = "leader", "A", 1
    for i in range(1, 11):
        member._log_append(i, 1, cmd(b"s%d" % i, b"t%d" % i, b"r%d" % i))
    member._next_index = {"B": 1}
    member._match_index = {"B": 0}
    member._sent_index = {"B": 0}

    def appends():
        out = []
        for _to, frame in member.messaging.sent:
            payload = deserialize(frame)
            if isinstance(payload, AppendEntries):
                out.append(payload)
        return out

    member._broadcast_append()
    member._broadcast_append()
    member._broadcast_append()
    first, second, third = appends()
    # Chunked streaming: 4 + 4, then the window (8 un-acked) is full and
    # the third frame is a pure probe at the stream head — the tail is
    # NEVER re-sent wholesale per tick.
    assert (first.prev_index, len(first.entries)) == (0, 4)
    assert (second.prev_index, len(second.entries)) == (4, 4)
    assert (third.prev_index, third.entries) == (8, ())
    assert member.metrics["append_entries_sent"] == 8

    # An ack opens the window: only the UNSENT remainder streams out.
    member._on_append_reply(AppendReply(1, True, 8, "B"))
    member._broadcast_append()
    fourth = appends()[-1]
    assert (fourth.prev_index, len(fourth.entries)) == (8, 2)
    # Wire entries are the log's own encoded blobs (zero codec work): a
    # follower could insert them verbatim.
    idx9 = deserialize(fourth.entries[0][1])
    assert idx9.request_id == b"r9"


def test_hintless_append_failure_backs_off_exponentially(tmp_path):
    net = Net()
    member = make_member(tmp_path, net, "A", {"B": "B"}, lambda: 0.0)
    member.role, member.leader_name, member.term = "leader", "A", 1
    member._next_index = {"B": 100}
    member._match_index = {"B": 0}
    member._sent_index = {"B": 120}

    positions = []
    for _ in range(5):
        member._on_append_reply(AppendReply(1, False, 0, "B", hint_index=-1))
        positions.append(member._next_index["B"])
        assert member._sent_index["B"] == member._next_index["B"] - 1
    # Doubling window: O(log tail) convergence instead of decrement-by-one.
    assert positions == [99, 97, 93, 85, 69]
    assert member._backoff["B"] == 32
    # Success resets the backoff (and the stream floor follows the match).
    member._on_append_reply(AppendReply(1, True, 98, "B"))
    assert "B" not in member._backoff
    assert member._next_index["B"] == 99
    # The cap: however long the divergence, a single step never exceeds
    # the append chunk.
    member._next_index["B"] = 10_000
    member._sent_index["B"] = 9_999
    for _ in range(20):
        member._on_append_reply(AppendReply(1, False, 0, "B", hint_index=-1))
    assert member._backoff["B"] == member.config.append_chunk == 256


def test_group_commit_off_keeps_per_command_sync_path(tmp_path):
    net, t = Net(), [0.0]
    member = make_member(tmp_path, net, "A", {}, lambda: t[0],
                         config=RaftConfig(group_commit=False))
    elect(net, member, t)
    for i in range(3):
        member.submit(cmd(b"s%d" % i, b"t%d" % i, b"r%d" % i))
    # Sync path: every submission appended its OWN log entry immediately.
    rows = member.db.conn.execute(
        "SELECT blob FROM raft_log ORDER BY idx").fetchall()
    assert len(rows) == 3
    assert all(isinstance(deserialize(bytes(b)), PutAllCommand)
               for (b,) in rows)
    member.flush_appends()
    member.quiesce_apply()
    for i in range(3):
        assert member.decided[b"r%d" % i].ok is True
    stamp = member.stamp()
    assert stamp["group_commit"] is False
    assert stamp["group_commits"] == 0


def test_single_member_group_commit_and_stamp(tmp_path):
    # peers={} is a quorum of one: the full submit -> seal -> commit ->
    # apply pipeline runs in-process (the shape the bench guard test and
    # any smoke harness lean on).
    net, t = Net(), [0.0]
    member = make_member(tmp_path, net, "A", {}, lambda: t[0])
    elect(net, member, t)
    for i in range(4):
        member.submit(cmd(b"s%d" % i, b"t%d" % i, b"r%d" % i))
    member.flush_appends()
    member.quiesce_apply()
    assert all(member.decided[b"r%d" % i].ok for i in range(4))
    stamp = member.stamp()
    assert stamp["entries_per_batch"] == 4.0
    assert stamp["role"] == "leader"
    assert stamp["solo_commits"] == 0
    json.dumps(stamp)
    # A round that seals one command makes a single-command entry.
    member.submit(cmd(b"s4", b"t4", b"r4"))
    member.flush_appends()
    member.quiesce_apply()
    stamp = member.stamp()
    assert (stamp["group_commits"], stamp["solo_commits"]) == (1, 1)
    assert stamp["entries_per_batch"] == 2.5


@pytest.mark.xfail(strict=True, raises=AssertionError, reason=(
    "ROADMAP.md queue 3: a raft member counts its quorum over the peers it "
    "has learned from the network map, not over its configured cluster "
    "(node/services/raft.py _maybe_win / _advance_commit, the same in both "
    "packages)"))
@pytest.mark.parametrize("package", ["corda_tpu", "corda_tpu_torch"])
def test_a_member_that_knows_none_of_its_peers_is_not_elected(tmp_path,
                                                              package):
    """The first member of a three-member cluster up, alone in the network
    map: it must not win an election, since one vote is not a majority of
    three. Both packages count the majority over the peers learned so far
    (none here), so the member elects itself and would commit alone, the
    other two later electing their own leader over the same inputs."""
    pkg = _package(package)
    node = pkg.Node(pkg.NodeConfig(
        name="RaftA", base_dir=tmp_path / "RaftA", port=0,
        notary="raft-simple", raft_cluster=("RaftA", "RaftB", "RaftC"),
        network_map=tmp_path / "netmap.json", verifier="cpu")).start()
    try:
        deadline = time.monotonic() + 1.5  # several election timeouts
        while time.monotonic() < deadline:
            node.run_once(timeout=0.01)
            assert node.raft_member.role != "leader", (
                "elected with 1 vote of a configured 3")
        assert not node.raft_member.peers
    finally:
        node.stop()


def test_node_metrics_carries_raft_and_transport_stamps(tmp_path):
    # End-to-end rpc wiring: a REAL raft node (cluster of one, TCP
    # transport) exports both commit-pipeline stamp dicts via node_metrics
    # — the exact path loadtest's _member_stamp reads over RPC.
    import time

    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.rpc import NodeRpcOps

    node = Node(NodeConfig(name="Solo", verifier="cpu",
                           base_dir=tmp_path / "Solo",
                           notary="raft-simple", raft_cluster=("Solo",),
                           network_map=tmp_path / "netmap.json")).start()
    try:
        deadline = time.monotonic() + 10.0
        while node.raft_member.role != "leader":
            node.run_once(timeout=0.005)
            assert time.monotonic() < deadline, "no leader"
        metrics = NodeRpcOps(node).node_metrics()
        assert metrics["raft"]["role"] == "leader"
        assert metrics["raft"]["group_commit"] is True
        assert "entries_per_batch" in metrics["raft"]
        assert "outbox_burst_avg" in metrics["transport"]
        json.dumps(metrics["raft"])
        json.dumps(metrics["transport"])
    finally:
        node.stop()


# ---------------------------------------------------------------------------
# Pipelined commit plane (round 18): overlapped rounds, detached apply
# executor, bounded-queue backpressure, serial-path bit-parity.
# ---------------------------------------------------------------------------


def _ledger_rows(member):
    return [(bytes(r[0]), bytes(r[1]), r[2]) for r in member.db.conn.execute(
        "SELECT state_ref, consuming, crc FROM committed_states "
        "ORDER BY state_ref").fetchall()]


def test_pipeline_off_serial_path_bit_identical(tmp_path):
    """[raft] pipeline=false preserves the serial apply path, and the
    pipelined plane (executor + columnar commit_many) produces the SAME
    bytes: identical decided outcomes per request AND identical
    committed_states rows — state_ref, consuming blob and CRC32C all
    bit-for-bit, conflicts included."""
    outcomes, ledgers = {}, {}
    for label, config in (("serial", RaftConfig(pipeline=False)),
                          ("pipelined", RaftConfig())):
        net, t = Net(), [0.0]
        member = make_member(tmp_path, net, f"A{label}", {}, lambda: t[0],
                             config=config)
        elect(net, member, t)
        shared = StateRef(SecureHash.sha256(b"dup"), 0)
        batch = [
            PutAllCommand((shared,), SecureHash.sha256(b"w1"), PARTY, b"p1"),
            PutAllCommand((shared,), SecureHash.sha256(b"w2"), PARTY, b"p2"),
            cmd(b"f1", b"w3", b"p3"),
            cmd(b"f2", b"w4", b"p4"),
        ]
        for c in batch:
            member.submit(c)
        member.flush_appends()
        member.quiesce_apply()
        outcomes[label] = {
            rid: (member.decided[rid].ok,
                  member.decided[rid].conflict is not None)
            for rid in (b"p1", b"p2", b"p3", b"p4")}
        ledgers[label] = _ledger_rows(member)
        stamp = member.stamp()
        assert stamp["pipeline"] is (label == "pipelined")
        if label == "pipelined":
            assert stamp["apply_batches"] >= 1
            assert stamp["apply_backlog"] == 0
        json.dumps(stamp)
    assert outcomes["serial"] == outcomes["pipelined"]
    assert outcomes["serial"][b"p1"] == (True, False)
    assert outcomes["serial"][b"p2"] == (False, True)  # conflict isolated
    assert ledgers["serial"] == ledgers["pipelined"]


def test_midround_seal_overlaps_replicating_round(tmp_path):
    """Pipelined rounds: a full append_chunk of buffered commands seals
    and broadcasts MID-ROUND — round N+1's entry enters the log (and the
    per-peer stream) while round N's entries are still un-acked."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0],
                        config=RaftConfig(append_chunk=2, pipeline_window=64))
    leader = members["A"]
    elect(net, leader, t)
    for i in range(5):
        leader.submit(cmd(b"s%d" % i, b"t%d" % i, b"r%d" % i))
    # append_chunk=2: submissions 2 and 4 sealed their rounds mid-flight;
    # nothing has been delivered, so BOTH sealed entries are ahead of the
    # commit index — the overlap the serial loop never had.
    assert leader.metrics["midround_seals"] == 2
    (log_len,) = leader.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log").fetchone()
    assert log_len == 2 and leader.commit_index == 0
    leader.flush_appends()  # the round closes: the tail (r4) seals too
    settle(net, members.values())
    for i in range(5):
        assert leader.decided[b"r%d" % i].ok is True
    for m in members.values():
        assert m.last_applied == leader.last_applied
        (n,) = m.db.conn.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
        assert n == 5
    assert leader.stamp()["midround_seals"] == 2


def test_leader_kill_mid_overlap_commits_exactly_once(tmp_path):
    """Leader dies with round N replicated-but-unacked and round N+1
    sealed right behind it. The survivors elect a new leader holding both
    entries; the clients' resubmissions ride the new leader as DUPLICATE
    log entries — and the apply plane's request/tx idempotence (same-tx
    re-commit is success, INSERT OR IGNORE) keeps the ledger exactly-once:
    one consuming row per state ref."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    old = members["A"]
    elect(net, old, t)
    c1, c2 = cmd(b"s1", b"t1", b"r1"), cmd(b"s2", b"t2", b"r2")
    old.submit(c1)
    old.flush_appends()   # round N sealed + broadcast, acks in flight
    old.submit(c2)
    old.flush_appends()   # round N+1 sealed mid-overlap
    del net.handlers["A"]  # the kill: A never processes another frame
    net.deliver_all()      # followers persist both entries, acks go dark
    new = members["B"]
    elect(net, new, t)     # B leads, holding both un-committed entries
    survivors = [members["B"], members["C"]]
    # The clients' retry path resubmits through the new leader.
    new.submit(c1)
    new.submit(c2)
    new.flush_appends()
    settle(net, survivors)
    assert new.decided[b"r1"].ok is True
    assert new.decided[b"r2"].ok is True
    for m in survivors:
        rows = _ledger_rows(m)
        assert len(rows) == 2  # one consuming row per ref: exactly once
        assert len({r[0] for r in rows}) == 2
    assert _ledger_rows(survivors[0]) == _ledger_rows(survivors[1])


def test_apply_queue_backpressure_sheds_new_submissions(tmp_path):
    """Bounded commit queue at depth 1 with the executor parked inside an
    apply: NEW submissions shed with the retryable bounce (ok=False,
    conflict=None) and the provider's admission point raises
    CommitQueueFullException — while in-flight commands are never shed and
    drain to success once the executor resumes."""
    import threading

    from corda_tpu_torch.node.services.raft import (
        CommitQueueFullException,
        RaftUniquenessProvider,
    )

    net, t = Net(), [0.0]
    member = make_member(tmp_path, net, "A", {}, lambda: t[0],
                         config=RaftConfig(apply_queue_depth=1))
    elect(net, member, t)
    started, gate = threading.Event(), threading.Event()
    orig = member.apply_command
    member._commit_many = None  # route every command through `slow`

    def slow(c):
        started.set()
        assert gate.wait(5.0)
        return orig(c)

    member.apply_command = slow
    member.submit(cmd(b"s1", b"t1", b"r1"))
    member.flush_appends()       # entry 1 enqueued; executor picks it up
    assert started.wait(5.0)     # executor parked inside the apply
    member.submit(cmd(b"s2", b"t2", b"r2"))
    member.flush_appends()       # entry 2 fills the depth-1 queue
    assert member.apply_overloaded()
    assert member.apply_backlog() == 2
    member.submit(cmd(b"s3", b"t3", b"r3"))  # shed: retryable bounce
    assert member.decided[b"r3"].ok is False
    assert member.decided[b"r3"].conflict is None
    assert member.metrics["apply_shed"] == 1
    # The provider's poll sheds NOT-in-flight (re)submissions loudly.
    provider = RaftUniquenessProvider(member, pump=lambda: None)
    poll = provider.commit_async(
        (StateRef(SecureHash.sha256(b"s4"), 0),),
        SecureHash.sha256(b"t4"), PARTY)
    try:
        poll()
        raise AssertionError("expected CommitQueueFullException")
    except CommitQueueFullException:
        pass
    gate.set()                   # executor resumes: committed work drains
    member.quiesce_apply()
    assert member.decided[b"r1"].ok is True
    assert member.decided[b"r2"].ok is True
    stamp = member.stamp()
    assert stamp["apply_shed"] == 1
    assert stamp["apply_queue_depth"] == 1
    json.dumps(stamp)


def test_commit_queue_full_maps_to_retryable_overload_error(tmp_path):
    """The notary flow surfaces CommitQueueFullException as the SAME
    retryable OverloadedError the QoS admission plane uses (lane
    "commit"), so notarise_with_retry's shed-backoff handling covers the
    pipelined apply executor's admission point too."""
    from corda_tpu_torch.flows.notary import (
        NotaryException,
        NotaryServiceFlow,
        OverloadedError,
    )
    from corda_tpu_torch.node.services.raft import CommitQueueFullException

    class FullProvider:  # sync provider shape: no commit_async attr
        def commit(self, states, tx_id, caller):
            raise CommitQueueFullException("commit queue full")

    flow = NotaryServiceFlow.__new__(NotaryServiceFlow)
    flow.service = types.SimpleNamespace(uniqueness_provider=FullProvider())
    wtx = types.SimpleNamespace(inputs=(), id=SecureHash.sha256(b"tx"))
    try:
        list(flow._commit_input_states(wtx, PARTY))
        raise AssertionError("expected NotaryException")
    except NotaryException as e:
        assert isinstance(e.error, OverloadedError)
        assert e.error.lane == "commit"
        assert e.error.retry_after_ms == CommitQueueFullException.RETRY_AFTER_MS


def test_executor_crash_resets_and_reapplies_idempotently(tmp_path):
    """An apply exception on the executor surfaces on the consensus
    thread exactly like the serial path's, the executor resets, and the
    failed entry re-applies idempotently from the durable log through a
    fresh executor — no decision lost, no double-commit."""
    net, t = Net(), [0.0]
    member = make_member(tmp_path, net, "A", {}, lambda: t[0])
    elect(net, member, t)
    orig = member.apply_command
    member._commit_many = None
    boom = {"armed": True}

    def flaky(c):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("disk hiccup")
        return orig(c)

    member.apply_command = flaky
    member.submit(cmd(b"s1", b"t1", b"r1"))
    member.flush_appends()
    try:
        member.quiesce_apply()
        raise AssertionError("expected the executor's error to surface")
    except RuntimeError:
        pass
    assert member._apply_queue is None  # reset: fresh executor next tick
    assert member.last_applied == 0
    member.tick()  # re-enqueues the committed entry
    member.quiesce_apply()
    assert member.decided[b"r1"].ok is True
    assert member.last_applied == 1
    assert len(_ledger_rows(member)) == 1


def test_sustained_pipelined_load_serializes_settings_writes(tmp_path):
    """Sustained load with the executor genuinely concurrent: the
    consensus thread folds results (raft_commit_index/raft_last_applied
    settings writes) while the executor is mid-transaction applying the
    NEXT entry on the SAME sqlite connection. Before those writes went
    under db.lock this raced into `cannot start a transaction within a
    transaction` within a few rounds — and throughput is the acceptance
    number: the pipelined plane must clear 2k committed tx/s per group."""
    import time as _wall

    net, t = Net(), [0.0]
    member = make_member(tmp_path, net, "A", {}, lambda: t[0])
    elect(net, member, t)
    n = 4096
    t0 = _wall.perf_counter()
    for i in range(n):
        member.submit(cmd(b"s%05d" % i, b"t%05d" % i, b"r%05d" % i))
        if i % 128 == 127:
            member.flush_appends()
    member.flush_appends()
    member.quiesce_apply()
    dt = _wall.perf_counter() - t0
    assert member.last_applied == member.commit_index
    assert len(_ledger_rows(member)) == n  # every command exactly once
    assert member.metrics["apply_batches"] >= 1
    # Durable watermarks match memory after the fold.
    assert member.db.get_setting("raft_last_applied") == str(
        member.last_applied)
    # ~9k tx/s on the CI container; 2000 leaves slack for slow runners
    # while still failing hard if the plane ever re-serializes.
    assert n / dt > 2000, f"pipelined commit plane at {n / dt:.0f} tx/s"


def test_append_many_crash_consistency_full_replay(tmp_path):
    frames = [(b"id%d" % i, b"frame%d" % i) for i in range(5)]

    # Crash between the executemany and the commit durability point: the
    # rows are in the connection's open transaction but never durable.
    db = NodeDatabase(tmp_path / "n.db")
    outbox = _Outbox(db)
    real_commit = db.commit
    db.commit = lambda: (_ for _ in ()).throw(RuntimeError("power cut"))
    try:
        outbox.append_many("peer", frames)
    except RuntimeError:
        pass
    db.commit = real_commit
    db.conn.rollback()  # what process death does to an open transaction
    db.close()

    reopened = NodeDatabase(tmp_path / "n.db")
    (n,) = reopened.conn.execute(
        "SELECT COUNT(*) FROM outbox").fetchone()
    assert n == 0  # never a prefix: the whole burst rolled back

    # The caller's at-least-once resend replays the burst IN FULL.
    outbox2 = _Outbox(reopened)
    outbox2.append_many("peer", frames)
    pending = outbox2.pending("peer")
    assert [u for _s, u, _f in pending] == [u for u, _f in frames]
    assert outbox2.stats["bursts"] == 1
    assert outbox2.stats["burst_frames"] == 5
    assert outbox2.stats["max_burst"] == 5
    reopened.close()


# ---------------------------------------------------------------------------
# Pre-vote and check-quorum
# ---------------------------------------------------------------------------


PREVOTE = RaftConfig(prevote=True)


def _keep_leader_fresh(net, leader, t, steps=4, dt=0.06):
    """Advance time in sub-election steps, ticking only the leader: every
    follower's leader-contact stamp and the leader's peer-contact stamps
    stay fresh (heartbeats out, replies back)."""
    for _ in range(steps):
        t[0] += dt
        leader.tick()
        net.deliver_all()


def test_prevote_canvass_persists_nothing_and_cannot_depose(tmp_path):
    """A follower that hits its election deadline while the leader is
    LIVE (the rejoined-minority shape): its canvass is rejected by every
    peer, its term never moves, and the leader keeps its seat."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0], config=PREVOTE)
    a, b, c = members["A"], members["B"], members["C"]
    elect(net, a, t)
    _keep_leader_fresh(net, a, t)

    term_before = c.term
    c._election_deadline = t[0]  # the disturbance: deadline fires NOW
    c.tick()
    net.deliver_all()

    assert c.metrics["prevotes"] == 1  # it canvassed...
    assert c.role == "follower"        # ...but never became candidate
    assert c.term == term_before       # and persisted no new term
    assert a.role == "leader" and a.term == term_before
    # Both the live leader and the fresh-contact follower rejected it.
    assert a.metrics["prevote_rejections"] == 1
    assert b.metrics["prevote_rejections"] == 1


def test_prevote_canvass_wins_when_leader_is_gone(tmp_path):
    """Stale leader contact everywhere -> the canvass is granted, and
    only THEN does a real (term-persisting) election run and win."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0], config=PREVOTE)
    a, b = members["A"], members["B"]
    elect(net, a, t)
    _keep_leader_fresh(net, a, t)

    # The leader falls silent: contact stamps age past the stickiness
    # window with nobody heartbeating.
    t[0] += 1.0
    term_before = b.term
    b._election_deadline = t[0]
    b.tick()
    net.deliver_all()

    assert b.role == "leader"
    assert b.metrics["prevotes"] == 1
    assert b.metrics["elections_won"] == 1
    # One canvass (term untouched) + one real election (term + 1).
    assert b.term == term_before + 1


def test_checkquorum_leader_without_majority_steps_down(tmp_path):
    """A leader whose peer-contact stamps all age out cedes leadership
    instead of serving a minority partition."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0], config=PREVOTE)
    a = members["A"]
    elect(net, a, t)
    _keep_leader_fresh(net, a, t)

    t[0] += 100.0  # every peer reply is now ancient: quorum lost
    a.tick()

    assert a.role == "follower"
    assert a.leader_name is None  # stops advertising itself via hints
    assert a.metrics["checkquorum_stepdowns"] == 1
    assert a.metrics["leader_stepdowns"] == 1


def test_prevote_grant_requires_up_to_date_log(tmp_path):
    """A canvasser whose log is BEHIND is rejected even with no live
    leader — same up-to-date rule as a real vote (§5.4.1)."""

    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0], config=PREVOTE)
    a, b = members["A"], members["B"]
    elect(net, a, t)
    a.submit(cmd(b"ref", b"tx", b"r1"))  # B's log gains a real entry
    settle(net, members.values())
    t[0] += 1.0  # leader contact stale: liveness cannot be the reason

    behind = PreVote(b.term + 1, "C", last_log_index=0, last_log_term=0)
    rejections = b.metrics["prevote_rejections"]
    b._on_prevote(behind, "C")
    assert b.metrics["prevote_rejections"] == rejections + 1


def test_prevote_off_keeps_the_old_election_path(tmp_path):
    """Default config: a fired deadline starts a REAL election at once
    (term persists immediately), no PreVote frame ever hits the wire,
    and a quorumless leader never self-demotes."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])  # prevote=False
    a, c = members["A"], members["C"]
    elect(net, a, t)

    term_before = c.term
    c._election_deadline = t[0]
    c.tick()  # don't deliver: inspect the raw outbound frames
    assert c.role == "candidate"  # straight to candidacy...
    assert c.term == term_before + 1  # ...with the term persisted
    assert c.metrics["prevotes"] == 0
    from corda_tpu_torch.serialization.codec import deserialize

    for _to, data in c.messaging.sent:
        assert not isinstance(getattr(deserialize(data), "payload",
                                      deserialize(data)), PreVote)
    net.deliver_all()

    t[0] += 100.0  # ancient peer contact — but check-quorum is off
    a.tick()
    assert a.metrics["checkquorum_stepdowns"] == 0


def test_single_member_group_never_steps_down(tmp_path):
    """A solo group is always its own quorum: check-quorum must not
    depose the only member."""

    net, t = Net(), [0.0]
    solo = make_member(tmp_path, net, "S", {}, lambda: t[0],
                       config=PREVOTE)
    t[0] += 100.0
    solo.tick()
    net.deliver_all()
    assert solo.role == "leader"
    t[0] += 100.0
    solo.tick()
    assert solo.role == "leader"
    assert solo.metrics["checkquorum_stepdowns"] == 0


def test_stamp_carries_partition_plane_counters(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0], config=PREVOTE)
    a = members["A"]
    elect(net, a, t)
    stamp = a.stamp()
    assert stamp["prevote"] is True
    assert stamp["elections_won"] == 1
    for key in ("prevotes", "prevote_rejections",
                "checkquorum_stepdowns"):
        assert isinstance(stamp[key], int)


# ---------------------------------------------------------------------------
# The Raft notary cluster over TCP and sqlite
# ---------------------------------------------------------------------------


CLUSTER = ("RaftA", "RaftB", "RaftC")


def make_cluster(tmp_path):
    nodes = []
    for name in CLUSTER:
        nodes.append(Node(NodeConfig(
            verifier="cpu",
            name=name,
            base_dir=tmp_path / name,
            notary="raft-simple",
            raft_cluster=CLUSTER,
            network_map=tmp_path / "netmap.json",
        )).start())
    for n in nodes:
        n.refresh_netmap()
    return nodes


def wait_for_leader(members, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for node in members:
            node.run_once(timeout=0.005)
        leaders = [n for n in members if n.raft_member.role == "leader"]
        if leaders:
            return leaders[0]
    raise AssertionError("no leader elected")


def test_cluster_elects_leader_and_commits(tmp_path):
    nodes = make_cluster(tmp_path)
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "netmap.json",
                            verifier="cpu")).start()
    everyone = nodes + [alice]
    try:
        leader = wait_for_leader(nodes)
        for n in everyone:
            n.refresh_netmap()

        # Notarise against the LEADER member (client picks one member).
        stx = issue_and_move(alice, leader.identity, magic=1)
        h = alice.start_flow(NotaryClientFlow(stx))
        pump_until(everyone, lambda: h.result.done)
        sig = h.result.result()
        sig.verify(stx.id.bytes)
        # The commit is REPLICATED: every member's state machine applied it.
        pump_until(everyone,
                   lambda: all(n.uniqueness_provider.committed_count == 1
                               for n in nodes))
    finally:
        for n in everyone:
            n.stop()


def test_double_spend_conflict_detected_by_cluster(tmp_path):
    nodes = make_cluster(tmp_path)
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "netmap.json",
                            verifier="cpu")).start()
    everyone = nodes + [alice]
    try:
        leader = wait_for_leader(nodes)
        for n in everyone:
            n.refresh_netmap()

        from corda_tpu_torch.testing.dummies import DummyContract

        builder = DummyContract.generate_initial(
            alice.identity.ref(b"\x01"), 2, leader.identity)
        builder.sign_with(alice.key)
        issue_stx = builder.to_signed_transaction()
        alice.services.record_transactions([issue_stx])
        prior = issue_stx.tx.out_ref(0)

        m1 = DummyContract.move(prior, alice.identity.owning_key)
        m1.sign_with(alice.key)
        stx1 = m1.to_signed_transaction(check_sufficient_signatures=False)
        m2 = DummyContract.move(prior, leader.identity.owning_key)
        m2.sign_with(alice.key)
        stx2 = m2.to_signed_transaction(check_sufficient_signatures=False)

        h1 = alice.start_flow(NotaryClientFlow(stx1))
        pump_until(everyone, lambda: h1.result.done)
        h1.result.result()

        h2 = alice.start_flow(NotaryClientFlow(stx2))
        pump_until(everyone, lambda: h2.result.done)
        with pytest.raises(NotaryException):
            h2.result.result()
    finally:
        for n in everyone:
            n.stop()


def test_leader_kill_cluster_regroups_and_commits(tmp_path):
    """Kill the elected leader; the survivors elect a new one and keep
    committing — with the dead member's committed state intact when it is
    reborn from disk."""
    nodes = make_cluster(tmp_path)
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "netmap.json",
                            verifier="cpu")).start()
    survivors = [alice]
    try:
        leader = wait_for_leader(nodes)
        for n in nodes + [alice]:
            n.refresh_netmap()

        followers = [n for n in nodes if n is not leader]
        target = followers[0]  # notarise against a member that will survive

        stx = issue_and_move(alice, target.identity, magic=3)
        h = alice.start_flow(NotaryClientFlow(stx))
        pump_until(nodes + [alice], lambda: h.result.done)
        h.result.result()

        # -- kill the leader ------------------------------------------------
        leader.stop()
        dead_name = leader.config.name
        nodes.remove(leader)
        del leader
        survivors.extend(nodes)

        new_leader = wait_for_leader(nodes)
        assert new_leader.config.name != dead_name

        # A second notarisation still commits (quorum of 2 of 3).
        stx2 = issue_and_move(alice, target.identity, magic=4)
        h2 = alice.start_flow(NotaryClientFlow(stx2))
        pump_until(nodes + [alice], lambda: h2.result.done, timeout=20.0)
        h2.result.result()
        # Follower application trails the leader by a heartbeat; settle.
        pump_until(nodes + [alice],
                   lambda: all(n.uniqueness_provider.committed_count == 2
                               for n in nodes))
    finally:
        for n in survivors:
            n.stop()


def test_log_compaction_and_snapshot_install(tmp_path, monkeypatch):
    """DistributedImmutableMap snapshot/install capability: after the log is
    compacted, a member that LOST ITS DISK rejoins via a state snapshot from
    the leader — not log replay — and converges to the same committed map."""
    from corda_tpu_torch.node.services.raft import RaftMember

    monkeypatch.setattr(RaftMember, "COMPACT_THRESHOLD", 8)
    nodes = make_cluster(tmp_path)
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "netmap.json",
                            verifier="cpu")).start()
    everyone = nodes + [alice]
    try:
        leader = wait_for_leader(nodes)
        for n in everyone:
            n.refresh_netmap()

        # Enough commits to trip compaction on every member.
        for i in range(20):
            stx = issue_and_move(alice, leader.identity, magic=100 + i)
            h = alice.start_flow(NotaryClientFlow(stx))
            pump_until(everyone, lambda: h.result.done)
            h.result.result()
        pump_until(everyone, lambda: all(
            n.uniqueness_provider.committed_count == 20 for n in nodes))
        pump_until(everyone, lambda: all(
            n.raft_member.snapshot_index > 0 for n in nodes), timeout=20.0)
        for n in nodes:
            (log_len,) = n.db.conn.execute(
                "SELECT COUNT(*) FROM raft_log").fetchone()
            assert log_len <= 8 + 2  # compacted

        # Disaster: one FOLLOWER loses its entire disk.
        leader = wait_for_leader(nodes)
        victim = next(n for n in nodes if n.raft_member.role != "leader")
        name = victim.config.name
        victim.stop()
        nodes.remove(victim)
        everyone.remove(victim)
        import shutil

        shutil.rmtree(tmp_path / name)  # nothing left to replay from

        reborn = Node(NodeConfig(
            verifier="cpu",
            name=name, base_dir=tmp_path / name, notary="raft-simple",
            raft_cluster=CLUSTER,
            network_map=tmp_path / "netmap.json")).start()
        nodes.append(reborn)
        everyone.append(reborn)
        for n in everyone:
            n.refresh_netmap()
        # The leader's log no longer reaches index 1: only an InstallSnapshot
        # can catch the blank member up.
        pump_until(everyone, lambda:
                   reborn.uniqueness_provider.committed_count == 20,
                   timeout=25.0)
        assert reborn.raft_member.snapshot_index >= \
            min(n.raft_member.snapshot_index for n in nodes if n is not reborn)

        # And the cluster still commits new transactions afterwards.
        stx = issue_and_move(alice, leader.identity, magic=999)
        h = alice.start_flow(NotaryClientFlow(stx))
        pump_until(everyone, lambda: h.result.done, timeout=20.0)
        h.result.result()
    finally:
        for n in everyone:
            n.stop()


def test_chunked_snapshot_and_dead_peer_compaction(tmp_path, monkeypatch):
    """Bounded-log + chunked-install regressions: compaction proceeds even
    with a member DOWN (a dead peer cannot pin the log), and the snapshot
    arrives as multiple ordered chunks when the map exceeds the chunk size."""
    from corda_tpu_torch.node.services.raft import RaftMember

    monkeypatch.setattr(RaftMember, "COMPACT_THRESHOLD", 4)
    monkeypatch.setattr(RaftMember, "SNAPSHOT_CHUNK", 3)  # force chunking
    nodes = make_cluster(tmp_path)
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "netmap.json",
                            verifier="cpu")).start()
    everyone = nodes + [alice]
    try:
        leader = wait_for_leader(nodes)
        for n in everyone:
            n.refresh_netmap()

        # Take a member down; the survivors keep committing AND compacting.
        victim = next(n for n in nodes if n.raft_member.role != "leader")
        name = victim.config.name
        victim.stop()
        nodes.remove(victim)
        everyone.remove(victim)

        for i in range(24):
            stx = issue_and_move(alice, leader.identity, magic=300 + i)
            h = alice.start_flow(NotaryClientFlow(stx))
            # 60 s, not 20: with the aggressive compaction parameters above
            # and the sequential test scheduler, the 2-member cluster can
            # drop into an election-churn episode that takes up to ~25 s to
            # self-heal (commit window + redelivery backoff). The assertions
            # under test are about COMPACTION correctness; the wide window
            # keeps them from doubling as a tight liveness-latency test.
            pump_until(everyone, lambda: h.result.done, timeout=60.0)
            h.result.result()
        live = [n for n in nodes]
        pump_until(everyone, lambda: all(
            n.raft_member.snapshot_index > 0 for n in live), timeout=20.0)
        for n in live:
            (log_len,) = n.db.conn.execute(
                "SELECT COUNT(*) FROM raft_log").fetchone()
            # Dead-peer floor: retention is bounded by ~4x threshold + tail.
            assert log_len <= 4 * 4 + 4 + 2

        # The dead member returns (old disk intact but far behind): it can
        # only catch up through a chunked snapshot (24 entries > chunk 3).
        reborn = Node(NodeConfig(
            verifier="cpu",
            name=name, base_dir=tmp_path / name, notary="raft-simple",
            raft_cluster=CLUSTER,
            network_map=tmp_path / "netmap.json")).start()
        nodes.append(reborn)
        everyone.append(reborn)
        for n in everyone:
            n.refresh_netmap()
        pump_until(everyone, lambda:
                   reborn.uniqueness_provider.committed_count == 24,
                   timeout=25.0)
    finally:
        for n in everyone:
            n.stop()


def test_commit_timeout_reports_retryable_unavailable():
    # A consensus window elapsing says nothing about the transaction: the
    # client must receive the RETRYABLE NotaryUnavailable error, never
    # NotaryTransactionInvalid (which would tell it to abandon a good tx).
    from corda_tpu_torch.flows.notary import (
        NotaryClientFlow,
        NotaryException,
        NotaryUnavailable,
    )
    from corda_tpu_torch.node.services.raft import CommitTimeoutException
    from corda_tpu_torch.testing.mock_network import MockNetwork
    from corda_tpu_torch.testing.dummies import DummyContract

    import pytest

    net = MockNetwork(verifier=CpuVerifier())
    try:
        notary = net.create_notary_node("Notary", validating=False)
        alice = net.create_node("Alice")

        class TimingOutProvider:
            def commit(self, states, tx_id, caller):
                raise CommitTimeoutException(
                    "raft commit not decided within 25.0s (leader: None)")

        notary.notary_service.uniqueness_provider = TimingOutProvider()

        builder = DummyContract.generate_initial(
            alice.identity.ref(b"\x01"), 1, notary.identity)
        builder.sign_with(alice.key)
        issue = builder.to_signed_transaction()
        alice.record_transaction(issue)
        move = DummyContract.move(issue.tx.out_ref(0),
                                  alice.identity.owning_key)
        move.sign_with(alice.key)
        stx = move.to_signed_transaction(check_sufficient_signatures=False)

        h = alice.start_flow(NotaryClientFlow(stx))
        net.run_network()
        with pytest.raises(NotaryException) as exc:
            h.result.result()
        assert isinstance(exc.value.error, NotaryUnavailable)
        assert "not decided" in exc.value.error.reason
    finally:
        net.stop_nodes()


def test_finality_retries_through_transient_unavailability():
    # NotaryUnavailable is RETRYABLE and FinalityFlow acts on it: a notary
    # whose commit window lapses twice (degraded cluster) then recovers
    # still finalises the transaction without caller involvement.
    from corda_tpu_torch.flows.finality import FinalityFlow
    from corda_tpu_torch.node.services.raft import CommitTimeoutException
    from corda_tpu_torch.testing.mock_network import MockNetwork
    from corda_tpu_torch.testing.dummies import DummyContract

    net = MockNetwork(verifier=CpuVerifier())
    try:
        notary = net.create_notary_node("Notary", validating=False)
        alice = net.create_node("Alice")

        real_provider = notary.notary_service.uniqueness_provider
        calls = {"n": 0}

        class FlakyProvider:
            def commit(self, states, tx_id, caller):
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise CommitTimeoutException("no quorum")
                return real_provider.commit(states, tx_id, caller)

        notary.notary_service.uniqueness_provider = FlakyProvider()

        builder = DummyContract.generate_initial(
            alice.identity.ref(b"\x01"), 1, notary.identity)
        builder.sign_with(alice.key)
        issue = builder.to_signed_transaction()
        alice.record_transaction(issue)
        move = DummyContract.move(issue.tx.out_ref(0),
                                  alice.identity.owning_key)
        move.sign_with(alice.key)
        stx = move.to_signed_transaction(check_sufficient_signatures=False)

        h = alice.start_flow(FinalityFlow(stx, (alice.identity,)))
        net.run_network()
        final = h.result.result()  # two failures + one success = finalised
        assert calls["n"] == 3
        assert any(s.by in notary.identity.owning_key.keys
                   for s in final.sigs)
    finally:
        net.stop_nodes()


# ---------------------------------------------------------------------------
# Durability: the self-healing log, disk exhaustion, the bitrot plan
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


def commit_rounds(net, members, leader, n, tag=b"x"):
    """Commit n commands as n separate log entries (one flush per cmd)."""
    for i in range(n):
        seed = tag + b"-%d" % i
        leader.submit(cmd(seed, b"tx" + seed, b"r" + seed))
        leader.flush_appends()
        net.deliver_all()
    settle(net, members.values())


def committed_refs(member):
    return sorted(
        bytes(r[0]).hex() for r in member.db.conn.execute(
            "SELECT state_ref FROM committed_states").fetchall())


def assert_converged(members, expect_rows):
    """Every member holds the SAME committed set, each ref exactly once."""
    baseline = None
    for m in members.values():
        refs = committed_refs(m)
        assert len(refs) == len(set(refs)) == expect_rows, m.name
        if baseline is None:
            baseline = refs
        assert refs == baseline, m.name


def corrupt_log_row(member, idx, blob=b"bitrot!"):
    member.db.conn.execute(
        "UPDATE raft_log SET blob = ? WHERE idx = ?", (blob, idx))
    member.db.conn.commit()
    # Detection is the sqlite READ path; drop the in-memory mirrors the
    # way a restart would.
    member._entry_cache.clear()
    member._blob_cache.clear()


def test_follower_corrupt_applied_row_compacts_and_converges(tmp_path):
    """THE acceptance scenario: a follower with a corrupted log suffix
    detects, heals, and converges — exactly once, integrity_errors > 0."""
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)
    commit_rounds(net, members, leader, 3, tag=b"pre")

    follower = members["B"]
    assert follower.last_applied == 3
    corrupt_log_row(follower, 2)
    # First read through the store detects the mismatch and heals: the
    # row's effects are already applied, so the prefix compacts behind a
    # snapshot marker (corruption becomes a LAGGING member, not a
    # diverged one).
    follower._log_entries_from(1)
    assert follower.metrics["integrity_errors"] == 1
    assert follower.metrics["log_truncations"] == 1
    assert follower.snapshot_index == 3
    (n,) = follower.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log WHERE idx <= 3").fetchone()
    assert n == 0

    # Normal replication resumes on top of the healed store.
    commit_rounds(net, members, leader, 3, tag=b"post")
    assert_converged(members, expect_rows=6)
    stamp = follower.stamp()
    assert stamp["integrity_errors"] > 0  # the acceptance counter
    json.dumps(stamp)


def test_follower_corrupt_unapplied_suffix_truncates(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)
    commit_rounds(net, members, leader, 2, tag=b"pre")

    follower = members["B"]
    assert follower.last_applied == 2
    # An unapplied suffix row whose frame doesn't verify (torn write).
    follower.db.conn.execute(
        "INSERT INTO raft_log (idx, term, blob, crc) VALUES (?, ?, ?, ?)",
        (3, follower.term, b"torn-write", 1))
    follower.db.conn.commit()
    follower._entry_cache.clear()
    follower._blob_cache.clear()

    follower._verified_log_rows(3, 4)
    assert follower.metrics["integrity_errors"] == 1
    assert (follower.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log WHERE idx >= 3").fetchone())[0] == 0
    assert follower.commit_index == 2  # clamped to the verified prefix

    commit_rounds(net, members, leader, 2, tag=b"post")
    assert_converged(members, expect_rows=4)


def test_leader_corrupt_row_steps_down(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)
    commit_rounds(net, members, leader, 2, tag=b"pre")

    corrupt_log_row(leader, 1)
    leader._log_entries_from(1)
    # Its log can no longer vouch for the range it was replicating: cede.
    assert leader.role == "follower"
    assert leader.metrics["leader_stepdowns"] == 1
    assert leader.metrics["integrity_errors"] == 1

    new = members["B"]
    elect(net, new, t)
    commit_rounds(net, members, new, 2, tag=b"post")
    assert_converged(members, expect_rows=4)


def test_install_snapshot_bad_chunk_crc_discarded(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    follower = members["B"]
    entries = ((b"\x31" * 33, b"\x00" * 32), (b"\x32" * 33, b"\x01" * 32))

    bad = InstallSnapshot(term=1, leader="A", last_included_index=5,
                          last_included_term=1, entries=entries,
                          crc=_snapshot_chunk_crc(entries) ^ 1)
    follower._on_install_snapshot(bad, "A")
    assert follower.metrics["integrity_errors"] == 1
    assert follower.last_applied == 0  # nothing installed

    good = InstallSnapshot(term=1, leader="A", last_included_index=5,
                           last_included_term=1, entries=entries,
                           crc=_snapshot_chunk_crc(entries))
    follower._on_install_snapshot(good, "A")
    assert follower.last_applied == 5
    rows = follower.db.conn.execute(
        "SELECT state_ref, consuming, crc FROM committed_states").fetchall()
    assert len(rows) == 2
    for ref, con, crc in rows:  # installed rows carry fresh frames
        assert crc is not None
        assert int(crc) == _integrity.committed_crc(bytes(ref), bytes(con))


# ---------------------------------------------------------------------------
# Graceful disk exhaustion
# ---------------------------------------------------------------------------


def test_disk_full_leader_sheds_round_and_steps_down(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)

    faults.arm(faults.FaultPlan(7, [
        faults.FaultRule("disk.full", "full", max_fires=1)]))
    leader.submit(cmd(b"s1", b"t1", b"r1"))
    leader.flush_appends()
    faults.disarm()

    # The seal failed before anything durable: shed retryable, cede.
    assert leader.metrics["disk_degraded"] == 1
    assert leader.role == "follower"
    assert leader.decided[b"r1"].ok is False
    assert leader.decided[b"r1"].conflict is None  # retryable, not final
    (n,) = leader.db.conn.execute(
        "SELECT COUNT(*) FROM raft_log").fetchone()
    assert n == 0

    # The disk "recovered": re-elect and the resubmission commits.
    leader.decided.clear()
    elect(net, leader, t)
    commit_rounds(net, members, leader, 1, tag=b"retry")
    assert_converged(members, expect_rows=1)


def test_disk_full_follower_degrades_then_catches_up(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)

    # Event 1 at disk.full is the leader's own seal — skip it; the fire
    # lands on the FIRST follower append.
    faults.arm(faults.FaultPlan(7, [
        faults.FaultRule("disk.full", "full", after=1, max_fires=1)]))
    leader.submit(cmd(b"s1", b"t1", b"r1"))
    leader.flush_appends()
    net.deliver_all()
    faults.disarm()

    degraded = [m for m in members.values()
                if m.metrics["disk_degraded"] == 1]
    assert len(degraded) == 1 and degraded[0] is not leader

    # Replication retries after the failure reply; everyone converges.
    settle(net, members.values())
    assert_converged(members, expect_rows=1)
    assert leader.decided[b"r1"].ok is True


# ---------------------------------------------------------------------------
# maybe_compact crash window (satellite)
# ---------------------------------------------------------------------------


class _CrashingConn:
    """Connection proxy that raises at a chosen statement — the shape of a
    crash between two statements of one logical transaction."""

    def __init__(self, real, trigger):
        self._real = real
        self._trigger = trigger

    def execute(self, sql, *args):
        if self._trigger(sql, args):
            raise RuntimeError("injected crash")
        return self._real.execute(sql, *args)

    def __getattr__(self, name):
        return getattr(self._real, name)


def test_maybe_compact_crash_window_never_rebases_indices(tmp_path):
    net, t = Net(), [0.0]
    members = make_trio(tmp_path, net, lambda: t[0])
    leader = members["A"]
    elect(net, leader, t)
    commit_rounds(net, members, leader, 8, tag=b"c")
    assert leader.last_applied == 8
    leader.COMPACT_THRESHOLD = 4  # instance override: compact upto 6

    real = leader.db._conn
    leader.db._conn = _CrashingConn(
        real, lambda sql, args: sql.startswith(
            "INSERT OR REPLACE INTO settings")
        and args and args[0][0] == "raft_snapshot_index")
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            leader.maybe_compact()
    finally:
        leader.db._conn = real

    # The half-compaction (prefix DELETE without its marker) rolled back
    # as a unit: nothing rebased, nothing half-durable.
    (lo, n) = leader.db.conn.execute(
        "SELECT MIN(idx), COUNT(*) FROM raft_log").fetchone()
    assert (lo, n) == (1, 8)
    assert leader.snapshot_index == 0
    assert leader.db.conn.execute(
        "SELECT value FROM settings WHERE key = 'raft_snapshot_index'"
    ).fetchone() is None
    # An unrelated later commit must not flush the dead prefix-DELETE: a
    # FRESH connection sees the full log and no marker.
    leader.db.set_setting("unrelated", "1")
    probe = sqlite3.connect(leader.db.path)
    assert probe.execute(
        "SELECT MIN(idx), COUNT(*) FROM raft_log").fetchone() == (1, 8)
    assert probe.execute(
        "SELECT value FROM settings WHERE key = 'raft_snapshot_index'"
    ).fetchone() is None
    probe.close()

    # Without the crash the same compaction succeeds — indices preserved
    # (remaining rows keep their original idx above the marker).
    leader.maybe_compact()
    assert leader.snapshot_index == 6
    assert leader.db.conn.execute(
        "SELECT MIN(idx), COUNT(*) FROM raft_log").fetchone() == (7, 2)


def test_bitrot_plan_is_builtin():
    plan = faults.builtin_plan("bitrot")
    points = {r.point for r in plan.rules}
    assert points == {"disk.corrupt", "disk.full"}


# ---------------------------------------------------------------------------
# The Node wiring: raft and sharded notaries boot; the apply executor stops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"notary": "raft-simple", "raft_cluster": ("N",)},
    {"notary": "raft-validating", "raft_cluster": ("N",)},
    {"notary": "raft-simple", "raft_cluster": ("N",),
     "notary_shards": None},
], ids=["raft-simple", "raft-validating", "notary_shards"])
def test_raft_and_sharded_notaries_boot(tmp_path, kw):
    from corda_tpu_torch.node.config import ShardConfig
    from corda_tpu_torch.node.services.raft import RaftUniquenessProvider
    from corda_tpu_torch.node.services.sharding import (
        ShardedUniquenessProvider,
    )

    if "notary_shards" in kw:
        kw = dict(kw, notary_shards=ShardConfig(
            count=2, groups=(("N",), ("M",))))
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu", **kw)).start()
    try:
        assert isinstance(node.raft_member, RaftMember)
        want = (ShardedUniquenessProvider if "notary_shards" in kw
                else RaftUniquenessProvider)
        assert type(node.uniqueness_provider) is want
        deadline = time.monotonic() + 10.0
        while node.raft_member.role != "leader":
            node.run_once(timeout=0.005)
            assert time.monotonic() < deadline, "no leader"
        services = {str(s.type) for s in node.info.advertised_services}
        assert ("corda.notary.shard.0of2" in services) == (
            "notary_shards" in kw)
    finally:
        node.stop()


def test_stop_drains_and_ends_the_apply_executor(tmp_path):
    node = Node(NodeConfig(name="Solo", base_dir=tmp_path / "Solo", port=0,
                           notary="raft-simple", raft_cluster=("Solo",),
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu")).start()
    rm = node.raft_member
    try:
        deadline = time.monotonic() + 10.0
        while rm.role != "leader":
            node.run_once(timeout=0.005)
            assert time.monotonic() < deadline, "no leader"
        for k in range(50):
            rm.submit(cmd(b"stop-%d" % k, b"tx-%d" % k, b"r-%d" % k))
        rm.flush_appends()
        node.run_once(timeout=0.005)
        assert rm._apply_thread is not None
    finally:
        node.stop()
    assert not rm._apply_thread.is_alive()
    assert rm.last_applied == rm.commit_index
    probe = sqlite3.connect(tmp_path / "Solo" / "node.db")
    try:
        (n,) = probe.execute(
            "SELECT COUNT(*) FROM committed_states").fetchone()
    finally:
        probe.close()
    assert n == 50


def test_shard_cluster_placement_picks_each_members_verifier(tmp_path):
    """start_shard_cluster renders one [notary_shards] map for every member
    and places only ``device_member`` on the card (verifier "torch", card
    visible); every other member runs "cpu" with the card hidden."""
    from corda_tpu.testing.driver import shard_groups_toml as jax_toml
    from corda_tpu_torch.testing.driver import (
        Driver,
        LocalHost,
        shard_groups_toml,
    )

    spawned = {}

    class RecordingHost(LocalHost):
        def spawn(self, argv, log_path, cwd, env):
            spawned[os.path.basename(os.path.dirname(log_path))] = (
                argv, env)
            return types.SimpleNamespace(poll=lambda: None, returncode=None)

    d = Driver(tmp_path, host=RecordingHost())
    rows = d.start_shard_cluster(groups=2, members=3,
                                 notary="raft-validating",
                                 device_member=(0, 0), wait=False)
    d.nodes.clear()  # nothing was spawned
    assert [[h.name for h in row] for row in rows] == [
        ["Shard0A", "Shard0B", "Shard0C"], ["Shard1A", "Shard1B", "Shard1C"]]
    names = [[h.name for h in row] for row in rows]
    assert shard_groups_toml(names) == jax_toml(names)
    for row in rows:
        for h in row:
            cfg = NodeConfig.load(str(h.base_dir / "node.toml"))
            assert cfg.notary == "raft-validating"
            assert cfg.notary_shards.count == 2
            assert [list(g) for g in cfg.notary_shards.groups] == names
            _argv, env = spawned[h.name]
            if h.name == "Shard0A":
                assert cfg.verifier == "torch" and h.device == "accelerator"
                assert env.get("CUDA_VISIBLE_DEVICES") != ""
            else:
                assert cfg.verifier == "cpu" and h.device == "cpu"
                assert env["CUDA_VISIBLE_DEVICES"] == ""


@pytest.mark.slow
def test_raft_validating_processes_elect_and_notarise(tmp_path):
    """Three raft-validating members as processes through ``python -m
    corda_tpu_torch.node.node`` and Alice over RPC: the cluster elects, the
    demo flow notarises at a member, and every member's sqlite commit log
    holds the move's input; SIGTERM stops every member with exit 0."""
    import corda_tpu_torch.testing.dummies  # noqa: F401
    from corda_tpu_torch.testing import notary_load as nl
    from corda_tpu_torch.testing.driver import driver

    app = ("corda_tpu_torch.tools.demo_cordapp",)
    with driver(tmp_path) as d:
        members = nl.start_raft_processes(
            d, True, {}, cordapps=app)
        alice = d.start_node("Alice", cordapps=app, rpc=True)
        client = alice.rpc("demo", "s3cret", timeout=60.0)
        try:
            deadline = time.monotonic() + 30
            while not set(nl.RAFT_NAMES) <= {
                    n.legal_identity.name
                    for n in client.call("network_map_snapshot")}:
                assert time.monotonic() < deadline, "Alice never saw them"
                time.sleep(0.2)
            ids = []
            for magic in (1, 2, 3):
                handle = client.start_flow("IssueAndNotariseFlow", magic)
                ids.append(client.wait_for_flow(handle, timeout=60.0))
            assert all(isinstance(x, str) and len(x) == 64 for x in ids)
            deadline = time.monotonic() + 30
            while True:
                rows = [nl.committed_inputs_at(m.base_dir / "node.db")
                        for m in members]
                if all({v.hex() for v in r.values()} == set(ids)
                       for r in rows):
                    break
                assert time.monotonic() < deadline, rows
                time.sleep(0.2)
        finally:
            client.close()
        for m in members:
            m.process.terminate()
            assert m.process.wait(timeout=60) == 0
