"""The port's Raft held to the JAX package's, on the CPU.

* Deterministic: one scripted run (elect, group commit with a conflict
  inside the batch, follower forwarding, a leader change, more commits)
  drives a cluster of three JAX ``RaftMember``s and one of three port
  ``RaftMember``s over the same in-process router, clock and
  ``random.Random(seed)``. Every member's ``raft_log`` rows (blob and crc
  frame), term, vote, commit index, committed states and every frame it
  sent (the ``ClientReplyBatch`` frames among them) must be byte-equal.
* Over TCP: the seeded workload (``testing/notary_load``) through a
  three-member ``raft-validating`` cluster of JAX ``Node``s and one of port
  ``Node``s, every node on ``verifier = "cpu"``: outcomes, notary
  signature bytes and every member's committed inputs must be equal.
* Mixed: two port members and one JAX member in one process elect, commit
  and replicate over TCP (the codec's wire names carry no package prefix,
  so the frames interoperate), with the JAX member leading and then with
  a port member leading.
* ``builtin_plan`` equals the JAX package's for every named plan.
"""

import dataclasses
import random
import types
from types import SimpleNamespace

import pytest

from corda_tpu_torch.testing import notary_load as nl

PLAN_NAMES = ("lossy", "slow-disk", "flaky-device", "reshard", "bitrot",
              "split-brain", "asym", "flap", "partition.split-brain",
              "partition.asym", "partition.flap")


def _pkg(root):
    """The modules one scripted run needs, from package ``root``."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        raft=mod("node.services.raft"),
        persistence=mod("node.services.persistence"),
        config=mod("node.config"),
        structures=mod("contracts.structures"),
        hashes=mod("crypto.hashes"),
        keys=mod("crypto.keys"),
        party=mod("crypto.party"),
        codec=mod("serialization.codec"),
        faults=mod("testing.faults"))


class Net:
    """Synchronous in-process router: a member's name is its address."""

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
    def __init__(self, net, addr):
        self.net, self.addr = net, addr
        self.sent = []  # (to, frame bytes)

    def add_message_handler(self, topic, session_id, callback):
        self.net.handlers[self.addr] = callback

    def send(self, topic_session, data, to):
        self.sent.append((to, bytes(data)))
        self.net.queue.append((to, data, self.addr))


def _settle(net, members, rounds=6):
    for _ in range(rounds):
        for m in members:
            m.flush_appends()
        net.deliver_all()
        for m in members:
            m.quiesce_apply()
        net.deliver_all()


def _elect(net, member, t):
    t[0] += 100.0  # past any election deadline; only `member` is ticked
    member.tick()
    net.deliver_all()
    assert member.role == "leader"


def scripted_run(p, tmp_path, seed=5):
    """Drive three members of package ``p`` through the script; return
    what the comparison reads."""
    net, t = Net(), [0.0]
    names = ("A", "B", "C")
    party = p.party.Party(
        "Client", p.keys.KeyPair.generate(b"\x01" * 32).public.composite)

    def cmd(ref_seed, tx_seed, rid):
        ref = p.structures.StateRef(p.hashes.SecureHash.sha256(ref_seed), 0)
        return p.raft.PutAllCommand(
            (ref,), p.hashes.SecureHash.sha256(tx_seed), party, rid)

    members = {}
    for i, name in enumerate(names):
        db = p.persistence.NodeDatabase(tmp_path / f"{name}.db")
        members[name] = p.raft.RaftMember(
            name, {q: q for q in names if q != name},
            FakeMessaging(net, name), db, p.raft.make_apply_command(db),
            clock=lambda: t[0], rng=random.Random(seed * 10 + i),
            config=p.config.RaftConfig())
    a, b = members["A"], members["B"]
    _elect(net, a, t)
    # One round: five commands, two of them racing for one state.
    for k in range(4):
        a.submit(cmd(b"s%d" % k, b"t%d" % k, b"r%d" % k))
    a.submit(cmd(b"s1", b"thief", b"r-thief"))
    _settle(net, members.values())
    # A follower's submissions forward to the leader in one frame.
    for k in range(3):
        b.submit(cmd(b"f%d" % k, b"ft%d" % k, b"rf%d" % k))
    _settle(net, members.values())
    # Leader change: B wins term 2 and commits on top of A's entries.
    _elect(net, b, t)
    for k in range(4):
        b.submit(cmd(b"n%d" % k, b"nt%d" % k, b"rn%d" % k))
    b.submit(cmd(b"s2", b"late-thief", b"r-late"))
    _settle(net, members.values())
    out = {}
    for name, m in members.items():
        with m.db.lock:
            log = m.db.conn.execute(
                "SELECT idx, term, blob, crc FROM raft_log ORDER BY idx"
            ).fetchall()
            meta = m.db.conn.execute(
                "SELECT term, voted_for FROM raft_meta").fetchall()
            committed = m.db.conn.execute(
                "SELECT state_ref, consuming, crc FROM committed_states "
                "ORDER BY state_ref").fetchall()
        out[name] = {
            "log": [(i, tm, bytes(bl), c) for i, tm, bl, c in log],
            "meta": meta, "term": m.term, "commit_index": m.commit_index,
            "last_applied": m.last_applied, "role": m.role,
            "committed": [(bytes(r), bytes(c), k) for r, c, k in committed],
            "sent": list(m.messaging.sent),
            "decided": {rid: bytes(p.codec.serialize(rep).bytes)
                        for rid, rep in sorted(m.decided.items())},
        }
        if m._apply_thread is not None:
            m._apply_queue.put(None)  # the executor's shutdown mark
            m._apply_thread.join(timeout=5.0)
        m.db.close()
    return out


def test_scripted_raft_run_is_byte_equal_to_the_jax_package(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_run = scripted_run(_pkg("corda_tpu"), tmp_path / "jax")
    port_run = scripted_run(_pkg("corda_tpu_torch"), tmp_path / "port")
    port = _pkg("corda_tpu_torch")
    for name in ("A", "B", "C"):
        ours, theirs = port_run[name], jax_run[name]
        assert ours["log"] and ours["log"] == theirs["log"], name
        for key in ("meta", "term", "commit_index", "last_applied", "role",
                    "committed", "decided"):
            assert ours[key] == theirs[key], (name, key)
        assert ours["sent"] == theirs["sent"], name
    # The run exercised what it claims: two terms, a conflict decided in a
    # batch, coalesced reply frames.
    assert port_run["B"]["term"] == 2 and port_run["B"]["role"] == "leader"
    assert len(port_run["A"]["committed"]) == 11
    frames = [port.codec.deserialize(f) for m in port_run.values()
              for _to, f in m["sent"]]
    assert any(isinstance(f, port.raft.ClientReplyBatch) for f in frames)
    assert any(isinstance(f, port.raft.ClientCommitBatch) for f in frames)
    assert [type(port.codec.deserialize(blob)).__name__
            for _i, _t, blob, _c in port_run["A"]["log"]] == \
        ["PutAllBatch"] * 3
    decided = [port.codec.deserialize(v) for v in
               port_run["A"]["decided"].values()]
    assert sum(r.conflict is not None for r in decided) >= 1


def test_snapshot_chunk_crc_agrees_across_the_packages():
    from corda_tpu.node.services import raft as jraft
    from corda_tpu_torch.node.services import raft

    rng = random.Random(3)
    for n in (0, 1, 7):
        entries = tuple((bytes(rng.getrandbits(8) for _ in range(33)),
                         bytes(rng.getrandbits(8) for _ in range(32)))
                        for _ in range(n))
        crc = raft._snapshot_chunk_crc(entries)
        assert crc == jraft._snapshot_chunk_crc(entries)
        # A chunk made by one package passes the other's check.
        chunk = jraft.InstallSnapshot(
            term=1, leader="A", last_included_index=5, last_included_term=1,
            entries=entries, crc=crc)
        from corda_tpu.serialization.codec import serialize as jser
        from corda_tpu_torch.serialization.codec import deserialize

        ours = deserialize(jser(chunk).bytes)
        assert isinstance(ours, raft.InstallSnapshot)
        assert raft._snapshot_chunk_crc(ours.entries) == ours.crc


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_builtin_plan_equals_the_jax_package(name):
    from corda_tpu.testing import faults as jfaults
    from corda_tpu_torch.testing import faults

    def identity(x):
        return tuple(getattr(x, f.name) for f in dataclasses.fields(x)
                     if f.compare)

    ours, theirs = faults.builtin_plan(name), jfaults.builtin_plan(name)
    assert ours.seed == theirs.seed
    assert [identity(r) for r in ours.rules] == \
        [identity(r) for r in theirs.rules]
    assert [identity(s) for s in ours.partitions] == \
        [identity(s) for s in theirs.partitions]
    # Each rule's seeded stream draws the same schedule.
    assert [[r._rng.random() for _ in range(4)] for r in ours.rules] == \
        [[r._rng.random() for _ in range(4)] for r in theirs.rules]
    with pytest.raises(ValueError):
        faults.builtin_plan("no-such-plan")


# ---------------------------------------------------------------------------
# Over TCP: raft-validating clusters of each package, then a mixed one
# ---------------------------------------------------------------------------


def _jax_api():
    from corda_tpu.flows.notary import NotaryClientFlow
    from corda_tpu.node.config import NodeConfig
    from corda_tpu.node.node import Node
    from corda_tpu.node.services.persistence import NodeDatabase
    from corda_tpu.testing.dummies import DummyContract

    return SimpleNamespace(DummyContract=DummyContract,
                           NotaryClientFlow=NotaryClientFlow, Node=Node,
                           NodeConfig=NodeConfig, NodeDatabase=NodeDatabase)


def _raft_run(api, base):
    members, alice, bob = nl.make_raft_nodes(api, base, "cpu", True)
    try:
        work = nl.build_workload(api, members[0], alice, bob, 24, 2, 2, 11)
        res = nl.run_raft_workload(api, members, alice, bob, work,
                                   timeout_s=120.0)
        res["expected"] = nl.expected_outcomes(work)
        res["keys"] = [bytes(n.key.public.encoded)
                       for n in (*members, alice, bob)]
        return res
    finally:
        for n in (*members, alice, bob):
            n.stop()


def test_raft_validating_cluster_equals_the_jax_package(tmp_path):
    jax_res = _raft_run(_jax_api(), tmp_path / "jax")
    port_res = _raft_run(nl.port_api(), tmp_path / "port")
    assert port_res["keys"] == jax_res["keys"]
    assert port_res["tx_ids"] == jax_res["tx_ids"]
    kinds = [o[:1] if o[0] == "ok" else o for o in port_res["outcomes"]]
    assert kinds == port_res["expected"]
    assert port_res["outcomes"] == jax_res["outcomes"]  # signature bytes too
    notarised = {tx for tx, o in zip(port_res["tx_ids"],
                                     port_res["outcomes"]) if o[0] == "ok"}
    assert port_res["notarised"] == 22
    for name in nl.RAFT_NAMES:
        ours = port_res["members_committed"][name]
        assert ours == jax_res["members_committed"][name], name
        assert ours == port_res["committed"]
        assert set(ours.values()) == notarised
    # RaftA received every request and verified its signatures.
    assert port_res["nodes"]["RaftA"]["verify_sigs"] == \
        jax_res["nodes"]["RaftA"]["verify_sigs"] > 0


def _mixed_cluster(tmp_path, leader_package):
    """RaftA and RaftB from the port, RaftC from the JAX package, Alice from
    the port; ``leader_package`` names whose member is made to lead (the
    others' election timers are pushed out until it has won)."""
    port, jax = nl.port_api(), _jax_api()
    names = nl.RAFT_NAMES
    nodes = []
    for name, api in (("RaftA", port), ("RaftB", port), ("RaftC", jax),
                      ("Alice", port), ("Bob", port)):
        node_dir = tmp_path / name
        node_dir.mkdir(parents=True)
        db = api.NodeDatabase(node_dir / "node.db")
        db.load_or_create_identity(name, nl.node_seed(name))
        db.close()
        raft = name in names
        nodes.append(api.Node(api.NodeConfig(
            name=name, base_dir=node_dir, port=0,
            notary="raft-simple" if raft else "none",
            raft_cluster=names if raft else (),
            network_map=tmp_path / "netmap.json", verifier="cpu")).start())
    for n in nodes:
        n.refresh_netmap()
        n.smm.verifier = nl.TimedVerifier(n.smm.verifier)
        if n.smm.async_verify is not None:
            n.smm.async_verify.verifier = n.smm.verifier
    members = nodes[:3]
    first = members[2] if leader_package == "jax" else members[0]
    for m in members:
        if m is not first:
            m.raft_member._election_deadline = float("inf")
    nl.pump_nodes(nodes, lambda: first.raft_member.role == "leader", 30.0)
    return members, nodes[3], nodes[4], first


@pytest.mark.parametrize("leader_package", ["jax", "port"])
def test_mixed_cluster_elects_commits_and_replicates(tmp_path,
                                                     leader_package):
    members, alice, bob, leader = _mixed_cluster(tmp_path, leader_package)
    everyone = (*members, alice, bob)
    try:
        api = nl.port_api()
        work = nl.build_workload(api, members[0], alice, bob, 12, 1, 1, 5)
        res = nl.run_tcp_workload(api, members[0], alice, bob, work,
                                  timeout_s=120.0, others=members[1:])
        kinds = [o[:1] if o[0] == "ok" else o for o in res["outcomes"]]
        assert kinds == nl.expected_outcomes(work)
        assert nl.leader_of(members) is leader
        nl.pump_nodes(everyone, lambda: all(
            m.uniqueness_provider.committed_count == 11 for m in members),
            60.0)
        rows = [nl.committed_inputs(m) for m in members]
        assert rows[0] == rows[1] == rows[2] and len(rows[0]) == 11
        # Every member's log holds the same blobs, whichever package
        # encoded them.
        logs = []
        for m in members:
            with m.db.lock:
                logs.append(m.db.conn.execute(
                    "SELECT idx, term, blob FROM raft_log ORDER BY idx"
                ).fetchall())
        assert logs[0] == logs[1] == logs[2] and logs[0]
    finally:
        for n in everyone:
            n.stop()
