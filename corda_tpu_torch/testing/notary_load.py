"""A seeded notarisation workload over MockNetwork, with its outcome record.

The raft-notary-demo's workload (samples/raft-notary-demo, NotaryDemo.kt):
DummyContract transactions, each issued on Alice and moved to Bob with
Alice's signature, notarised through ``NotaryClientFlow`` on one notary
node. A seeded share of the moves carries a flipped signature byte (the
client's own signature check must refuse them), and a few second spends of
inputs that an earlier round notarised must meet ``NotaryConflict``.

``run_workload`` starts the flows in one burst or in waves (start a wave,
``run_network``, start the next), then the second spends as a last round,
and returns what a comparison needs: every transaction's outcome (the
notary's signature bytes, or the exception and error type names), each
flow's time from ``start_flow`` to its result, the committed input set,
and per node the state machine's verify counts, its largest batch and the
time spent inside ``verify_batch``.

The same workload runs over real nodes: ``make_tcp_nodes`` boots the
notary, Alice and Bob as ``Node``s over localhost TCP, each on its own
sqlite with an identity seeded from its name (so every run, in either
package, has the same keys), and ``run_tcp_workload`` drives them with a
round-robin ``run_once`` as the scheduler. ``run_open_loop`` starts a flow
through RPC on a fixed schedule, whatever completes, and times each from
its scheduled start to the change feed's report of its end.

The same workload runs against a Raft notary cluster (BASELINE config 1,
samples/raft-notary-demo's three members): ``make_raft_nodes`` boots the
members RaftA, RaftB and RaftC (``raft-simple`` or ``raft-validating``)
beside Alice and Bob and waits for a leader; ``run_raft_workload``
notarises at RaftA, pumps every member, waits until every member has
applied the notarised commits and adds each member's committed inputs,
the leader and its raft stamp. ``start_raft_processes`` spawns the
members as processes through the driver. ``make_shard_nodes`` and
``run_shard_workload`` do the same for the sharded notary: raft groups
under one ``[notary_shards]`` map, each group's committed inputs read
from its members.

Everything here is passed the package it drives (``api``: ``MockNetwork``,
``DummyContract`` and ``NotaryClientFlow``; for nodes also ``Node``,
``NodeConfig`` and ``NodeDatabase``), so the same
workload runs in this package and in any other with the same classes;
``port_api()`` gives this package's own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import shutil
import sqlite3
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

NODE_NAMES = ("Notary", "Alice", "Bob")
RAFT_NAMES = ("RaftA", "RaftB", "RaftC")
# The sharded notary: two raft groups of three, named as the driver's
# start_shard_cluster names them.
SHARD_NAMES = (("Shard0A", "Shard0B", "Shard0C"),
               ("Shard1A", "Shard1B", "Shard1C"))
ELECT_TIMEOUT_S = 60.0  # the in-process clusters' wait for their leaders


def port_api() -> SimpleNamespace:
    """This package's classes and functions that the runners here use:
    the notary workload's (MockNetwork, DummyContract, NotaryClientFlow,
    Node, NodeConfig, ShardConfig, NodeDatabase), the trader demo's and
    the notary change's."""
    from ..contracts.structures import (
        Command,
        Issued,
        StateAndRef,
        StateRef,
        Timestamp,
        TransactionState,
    )
    from ..crypto.hashes import SecureHash
    from ..crypto.keys import KeyPair
    from ..crypto.party import Party
    from ..finance.amount import Amount
    from ..finance.cash import Cash, CashState
    from ..finance.commercial_paper import CommercialPaper, CPState
    from ..finance.trade import BuyerFlow, SellerFlow
    from ..flows.notary import NotaryClientFlow
    from ..flows.state_replacement import (
        NotaryChangeFlow,
        install_notary_change_acceptor,
    )
    from ..node.config import NodeConfig, ShardConfig, VaultConfig
    from ..node.node import Node
    from ..node.services.persistence import NodeDatabase
    from ..node.services.vault import (
        IndexedVaultService,
        VaultQuery,
        seed_states,
    )
    from ..serialization.codec import serialize
    from ..transactions.builder import TransactionBuilder
    from .dummies import DummyContract, DummyCreate, DummyMultiOwnerState
    from .mock_network import MockNetwork

    return SimpleNamespace(
        MockNetwork=MockNetwork, DummyContract=DummyContract,
        NotaryClientFlow=NotaryClientFlow, Node=Node, NodeConfig=NodeConfig,
        ShardConfig=ShardConfig, NodeDatabase=NodeDatabase,
        Command=Command, Issued=Issued, StateAndRef=StateAndRef,
        StateRef=StateRef, Timestamp=Timestamp,
        TransactionState=TransactionState, SecureHash=SecureHash,
        KeyPair=KeyPair, Party=Party, Amount=Amount, Cash=Cash,
        CashState=CashState, CommercialPaper=CommercialPaper, CPState=CPState,
        BuyerFlow=BuyerFlow, SellerFlow=SellerFlow,
        NotaryChangeFlow=NotaryChangeFlow,
        install_notary_change_acceptor=install_notary_change_acceptor,
        VaultConfig=VaultConfig, IndexedVaultService=IndexedVaultService,
        VaultQuery=VaultQuery, seed_states=seed_states, serialize=serialize,
        TransactionBuilder=TransactionBuilder, DummyCreate=DummyCreate,
        DummyMultiOwnerState=DummyMultiOwnerState)


class TimedVerifier:
    """Forwards ``verify_batch`` to ``inner`` and keeps the calls' sizes and
    the seconds spent inside them. Every other attribute reads through."""

    def __init__(self, inner):
        self.inner = inner
        self.sizes: list[int] = []
        self.seconds = 0.0

    def verify_batch(self, jobs):
        t0 = time.perf_counter()
        try:
            return self.inner.verify_batch(jobs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.sizes.append(len(jobs))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def make_network(api, verifier, validating: bool):
    """A MockNetwork with the notary, Alice and Bob, created in that order
    (MockNetwork's keys come from a counter, so every network made here
    has the same identities). Each node's state machine verifies through a
    TimedVerifier over ``verifier``."""
    net = api.MockNetwork(verifier=verifier)
    notary = net.create_notary_node(NODE_NAMES[0], validating=validating)
    alice = net.create_node(NODE_NAMES[1])
    bob = net.create_node(NODE_NAMES[2])
    for node in (notary, alice, bob):
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return net, notary, alice, bob


@dataclasses.dataclass
class Workload:
    issues: list           # recorded on Alice before any flow starts
    moves: list            # notarised in the burst or the waves
    doubles: list          # second spends, notarised in a last round
    bad: tuple             # positions in ``moves`` with a flipped sig byte
    double_of: tuple       # the move each second spend conflicts with


def build_workload(api, notary, alice, bob, n: int, n_bad: int,
                   n_double: int, seed: int) -> Workload:
    """``n`` issue-and-move pairs with magic numbers from ``seed``; the
    moves at ``n_bad`` seeded positions get their signature's byte
    ``sig[k]`` (k seeded too) flipped; ``n_double`` second spends move the
    inputs of seeded good moves back to Alice."""
    rng = np.random.default_rng(seed)
    magics = rng.integers(0, 2**31, n)
    bad = tuple(sorted(int(i) for i in rng.choice(n, n_bad, replace=False)))
    good = [i for i in range(n) if i not in set(bad)]
    double_of = tuple(int(i) for i in rng.choice(good, n_double,
                                                 replace=False))
    issues, moves = [], []
    for i in range(n):
        builder = api.DummyContract.generate_initial(
            alice.identity.ref(i.to_bytes(4, "big")), int(magics[i]),
            notary.identity)
        builder.sign_with(alice.key)
        issue = builder.to_signed_transaction()
        issues.append(issue)
        move = api.DummyContract.move(issue.tx.out_ref(0),
                                      bob.identity.owning_key)
        move.sign_with(alice.key)
        moves.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    for i in bad:
        stx = moves[i]
        sig = stx.sigs[0]
        k = int(rng.integers(0, 64))
        flipped = type(sig)(sig.bytes[:k] + bytes([sig.bytes[k] ^ 0x01])
                            + sig.bytes[k + 1:], sig.by)
        moves[i] = dataclasses.replace(stx, sigs=(flipped,))
    doubles = []
    for i in double_of:
        move = api.DummyContract.move(issues[i].tx.out_ref(0),
                                      alice.identity.owning_key)
        move.sign_with(alice.key)
        doubles.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    return Workload(issues, moves, doubles, bad, double_of)


def outcome_of(handle) -> tuple:
    """("ok", notary signature bytes, signer key bytes), or the exception's
    type name and, for a NotaryException, its error's type name."""
    try:
        sig = handle.result.result()
    except Exception as e:  # noqa: BLE001 -- the outcome is the record
        error = getattr(e, "error", None)
        return (type(e).__name__,
                type(error).__name__ if error is not None else None)
    return ("ok", bytes(sig.bytes), bytes(sig.by.encoded))


def start_timed(node, flow, starts: list, ends: list, k: int):
    """Start ``flow`` on ``node``, stamping ``starts[k]`` now and
    ``ends[k]`` when its result is set (a done-callback)."""
    starts[k] = time.perf_counter()
    handle = node.start_flow(flow)

    def _done(_future, k=k):
        ends[k] = time.perf_counter()

    handle.result.add_done_callback(_done)
    if handle.result.done and not ends[k]:  # finished inside start_flow
        ends[k] = time.perf_counter()
    return handle


def run_network_async(net, timeout_s: float = 120.0) -> None:
    """``net.run_network()`` for nodes whose state machine has the async
    verify pump installed (``smm.async_verify``): deliver messages, submit
    each such node's micro-batch to its pump and deliver the batches it
    has finished (other nodes flush as usual), until nothing moves and no
    batch is in flight. Raises AssertionError after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        net.messaging_network.run()
        progressed = 0
        for node in net.nodes:
            if node.smm.async_verify is not None:
                progressed += node.smm.submit_pending_verifies()
                progressed += node.smm.drain_async_verifies()
            else:
                progressed += node.smm.flush_pending_verifies()
        busy = any(node.smm.async_verify is not None
                   and node.smm.async_verify.in_flight for node in net.nodes)
        if (not progressed and not busy
                and net.messaging_network.in_flight_count == 0):
            return
        if busy and not progressed:
            time.sleep(0.005)
    raise AssertionError("the network did not settle")


def run_workload(api, net, notary, alice, bob, workload: Workload,
                 wave: int | None = None, settle=None) -> dict:
    """Notarise ``workload.moves`` from Alice, all at once (``wave`` None)
    or ``wave`` flows at a time, then the second spends as one more round;
    each round ends with ``settle(net)`` (default ``net.run_network()``;
    ``run_network_async`` for the async pump). Returns the outcome record
    (see the module docstring); ``wall_s`` is the whole run's, ``flow_s``
    each flow's start-to-result time in the order of ``moves`` then
    ``doubles``."""
    stxs = workload.moves + workload.doubles
    starts = [0.0] * len(stxs)
    ends = [0.0] * len(stxs)
    rounds = ([range(len(workload.moves))] if wave is None else
              [range(lo, min(lo + wave, len(workload.moves)))
               for lo in range(0, len(workload.moves), wave)])
    rounds.append(range(len(workload.moves), len(stxs)))
    for issue in workload.issues:
        alice.record_transaction(issue)
    handles = [None] * len(stxs)
    t0 = time.perf_counter()
    for r in rounds:
        for k in r:
            handles[k] = start_timed(alice, api.NotaryClientFlow(stxs[k]),
                                     starts, ends, k)
        if settle is None:
            net.run_network()
        else:
            settle(net)
    wall_s = time.perf_counter() - t0
    outcomes = [outcome_of(h) for h in handles]
    committed = {
        (bytes(ref.txhash.bytes), ref.index): bytes(tx.id.bytes)
        for ref, tx in notary.uniqueness_provider._committed.items()}
    nodes = {}
    for node in (notary, alice, bob):
        timed = node.smm.verifier
        nodes[node.name] = {
            "verify_batches": node.smm.metrics["verify_batches"],
            "verify_sigs": node.smm.metrics["verify_sigs"],
            "verify_device_degraded":
                node.smm.metrics["verify_device_degraded"],
            "largest_batch": max(timed.sizes, default=0),
            "verify_s": timed.seconds,
        }
    return {
        "outcomes": outcomes,
        "tx_ids": [bytes(s.id.bytes) for s in stxs],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "verify_s": sum(v["verify_s"] for v in nodes.values()),
        "notarised": sum(o[0] == "ok" for o in outcomes),
        "committed": committed,
        "committed_count": notary.uniqueness_provider.committed_count,
        "nodes": nodes,
    }


def node_seed(name: str) -> bytes:
    """The identity seed of the node ``name`` in every TCP run."""
    return hashlib.sha256(b"notary-load:" + name.encode()).digest()


def _start_nodes(api, base_dir, specs) -> list:
    """Start a ``Node`` for each ``(name, config keywords)`` of ``specs``
    under ``base_dir`` over localhost TCP, sharing one netmap file, each
    identity seeded (``node_seed``) through its database before the node
    opens it; then refresh every netmap and wrap each state machine's
    verifier, and the async pump's, in a TimedVerifier."""
    base_dir = Path(base_dir)
    nodes = []
    for name, kw in specs:
        node_dir = base_dir / name
        node_dir.mkdir(parents=True, exist_ok=True)
        db = api.NodeDatabase(node_dir / "node.db")
        db.load_or_create_identity(name, node_seed(name))
        db.close()
        nodes.append(api.Node(api.NodeConfig(
            name=name, base_dir=node_dir, port=0,
            network_map=base_dir / "netmap.json", **kw)).start())
    for node in nodes:
        node.refresh_netmap()
        timed = TimedVerifier(node.smm.verifier)
        node.smm.verifier = timed
        if node.smm.async_verify is not None:
            node.smm.async_verify.verifier = timed
    return nodes


def make_tcp_nodes(api, base_dir, verifier: str, validating: bool,
                   tls: bool = False, notary_batch=None) -> tuple:
    """(notary, alice, bob): started ``Node``s over localhost TCP under
    ``base_dir``, sharing one netmap file, each with ``verifier`` (a config
    kind) and the default ``[batch]`` policy (max_sigs 4096, max_wait_ms
    2.0, the async verify pump on). Each
    node's identity is seeded (``node_seed``) through its database before
    the node opens it. Each state machine's verifier, and the async pump's,
    is wrapped in a TimedVerifier. ``tls``: every node speaks mutual TLS
    (certificates from the dev CA beside the netmap file, or already in a
    node's ``certificates`` directory). ``notary_batch``: the notary's
    ``[batch]`` (a BatchConfig, e.g. naming ``federation_hosts``)."""
    kind = "validating" if validating else "simple"
    specs = []
    for name in NODE_NAMES:
        kw = {"notary": kind if name == NODE_NAMES[0] else "none",
              "verifier": verifier, "tls": tls}
        if name == NODE_NAMES[0] and notary_batch is not None:
            kw["batch"] = notary_batch
        specs.append((name, kw))
    return tuple(_start_nodes(api, base_dir, specs))


def _settle(step, done, timeout_s: float) -> None:
    """Call ``step()`` until ``done()``; raises AssertionError after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError("the nodes did not settle")
        step()


def pump_nodes(nodes, done, timeout_s: float = 300.0,
               round_timeout_s: float = 0.001) -> None:
    """Round-robin ``run_once`` over ``nodes`` until ``done()``; raises
    AssertionError after ``timeout_s``."""
    def step():
        for node in nodes:
            node.run_once(timeout=round_timeout_s)

    _settle(step, done, timeout_s)


_COMMITTED_SQL = "SELECT state_ref, consuming FROM committed_states"


def committed_inputs(node) -> dict:
    """{(txhash bytes, index): consuming tx id bytes} from the notary's
    sqlite commit log."""
    with node.db.lock:
        rows = node.db.conn.execute(_COMMITTED_SQL).fetchall()
    return _decode_committed(rows)


def committed_inputs_at(db_path) -> dict:
    """``committed_inputs`` of a notary running in another process, read
    from its sqlite file through a read-only connection (WAL lets it read
    beside the node's writer)."""
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True, timeout=30.0)
    try:
        rows = conn.execute(_COMMITTED_SQL).fetchall()
    finally:
        conn.close()
    return _decode_committed(rows)


def _decode_committed(rows) -> dict:
    # The rows' types must be registered with this package's codec, also
    # in a process that has only driven another package's nodes.
    from ..node.services.api import ConsumingTx  # noqa: F401
    from ..serialization.codec import deserialize

    out = {}
    for ref_blob, consuming_blob in rows:
        ref = deserialize(bytes(ref_blob))
        out[(bytes(ref.txhash.bytes), ref.index)] = bytes(
            deserialize(bytes(consuming_blob)).id.bytes)
    return out


def _stage_delta(after: dict | None, before: dict | None) -> dict:
    after, before = after or {}, before or {}
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _stages_before(nodes) -> dict:
    return {n.identity.name: (dict(n.smm.metrics.get("round_stage_s", {})),
                              dict(n.smm.metrics.get("round_phase_s", {})))
            for n in nodes}


def _node_record(node, before: dict) -> dict:
    """A node's verify counts, its verifier's device and host batches and
    batch sizes (a TimedVerifier's), and its ``round_stage_s`` and
    ``round_phase_s`` since ``before`` (``_stages_before``)."""
    timed = node.smm.verifier
    stage0, phase0 = before[node.identity.name]
    return {
        "verify_batches": node.smm.metrics["verify_batches"],
        "verify_sigs": node.smm.metrics["verify_sigs"],
        "verify_device_degraded":
            node.smm.metrics["verify_device_degraded"],
        "device_batches": getattr(timed, "device_batches", 0) or 0,
        "host_batches": getattr(timed, "host_batches", 0) or 0,
        "batch_sizes": list(timed.sizes),
        "largest_batch": max(timed.sizes, default=0),
        "verify_s": timed.seconds,
        "round_stage_s": _stage_delta(
            node.smm.metrics.get("round_stage_s"), stage0),
        "round_phase_s": _stage_delta(
            node.smm.metrics.get("round_phase_s"), phase0),
    }


def run_tcp_workload(api, notary, alice, bob, workload: Workload,
                     timeout_s: float = 300.0, others=()) -> dict:
    """``run_workload`` over TCP nodes from ``make_tcp_nodes``: the moves
    in one burst, then the second spends, each round pumped until every
    flow has its result. The record adds, per node, the verifier's device
    and host batches, every batch size, and the run's ``round_stage_s``
    and ``round_phase_s``. ``others`` are more nodes to pump and record
    (the other members of a raft cluster)."""
    nodes = (notary, alice, bob, *others)
    stxs = workload.moves + workload.doubles
    starts = [0.0] * len(stxs)
    ends = [0.0] * len(stxs)
    alice.services.record_transactions(workload.issues)
    before = _stages_before(nodes)
    handles = [None] * len(stxs)
    t0 = time.perf_counter()
    for r in (range(len(workload.moves)),
              range(len(workload.moves), len(stxs))):
        for k in r:
            handles[k] = start_timed(alice, api.NotaryClientFlow(stxs[k]),
                                     starts, ends, k)
        pump_nodes(nodes, lambda r=r: all(handles[k].result.done for k in r),
                   timeout_s)
    wall_s = time.perf_counter() - t0
    outcomes = [outcome_of(h) for h in handles]
    per_node = {node.config.name: _node_record(node, before)
                for node in nodes}
    return {
        "outcomes": outcomes,
        "tx_ids": [bytes(s.id.bytes) for s in stxs],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "verify_s": sum(v["verify_s"] for v in per_node.values()),
        "notarised": sum(o[0] == "ok" for o in outcomes),
        "committed": committed_inputs(notary),
        "committed_count": notary.uniqueness_provider.committed_count,
        "nodes": per_node,
    }


def make_raft_nodes(api, base_dir, verifier: str, validating: bool) -> tuple:
    """(raft members, alice, bob): the three raft notary ``Node``s of
    RAFT_NAMES (``raft-validating`` or ``raft-simple``, one
    ``raft_cluster``), then Alice and Bob, over localhost TCP under
    ``base_dir`` with one netmap file, each with ``verifier`` (a config
    kind), the default ``[batch]`` and ``[raft]`` policy and an identity
    seeded as ``make_tcp_nodes`` seeds it. Returns once a member leads
    (pumping every node round-robin; AssertionError after
    ELECT_TIMEOUT_S). Each state machine's verifier, and the async
    pump's, is wrapped in a TimedVerifier."""
    kind = "raft-validating" if validating else "raft-simple"
    nodes = _start_nodes(api, base_dir, [
        (name, {"notary": kind, "raft_cluster": RAFT_NAMES,
                "verifier": verifier}) for name in RAFT_NAMES] + [
        (name, {"verifier": verifier}) for name in NODE_NAMES[1:]])
    n = len(RAFT_NAMES)
    cluster = tuple(nodes[:n])
    pump_nodes(nodes, lambda: leader_of(cluster) is not None,
               ELECT_TIMEOUT_S)
    return cluster, nodes[n], nodes[n + 1]


def leader_of(members):
    """The member that leads (None while an election runs)."""
    return next((m for m in members if m.raft_member.role == "leader"), None)


def run_raft_workload(api, members, alice, bob, workload: Workload,
                      timeout_s: float = 300.0) -> dict:
    """``run_tcp_workload`` against a raft cluster from ``make_raft_nodes``:
    the flows notarise at ``members[0]`` (the transactions' notary), every
    member is pumped, and once every flow has its result the nodes are
    pumped on until each member has applied every notarised commit. The
    record adds ``first_leader`` and ``leader`` (the names of the members
    that led at the start and at the end), ``terms`` (the raft term then
    and now: equal when no election ran), ``members_committed`` (each
    member's committed inputs) and ``raft_stamp`` (the leader's
    ``RaftMember.stamp()``)."""
    notary, others = members[0], tuple(members[1:])
    first = leader_of(members)
    term0 = first.raft_member.term if first is not None else None
    res = run_tcp_workload(api, notary, alice, bob, workload, timeout_s,
                           others=others)
    want = res["notarised"]
    pump_nodes((*members, alice, bob), lambda: all(
        m.uniqueness_provider.committed_count >= want for m in members),
        timeout_s)
    lead = leader_of(members)
    res["leader"] = lead.config.name if lead is not None else None
    res["first_leader"] = first.config.name if first is not None else None
    res["terms"] = (term0, lead.raft_member.term if lead is not None
                    else None)
    res["members_committed"] = {m.config.name: committed_inputs(m)
                                for m in members}
    res["raft_stamp"] = (lead.raft_member.stamp() if lead is not None
                         else None)
    return res


def make_shard_nodes(api, base_dir, verifier: str, validating: bool) -> tuple:
    """(groups of members, alice, bob): the raft notary groups of
    SHARD_NAMES (two groups of three ``Node``s, named as the driver names
    them) under one ``[notary_shards]`` map, then Alice and Bob, as
    ``make_raft_nodes`` builds them; returns once every group has a
    leader."""
    shards = api.ShardConfig(count=len(SHARD_NAMES), groups=SHARD_NAMES)
    kind = "raft-validating" if validating else "raft-simple"
    nodes = _start_nodes(api, base_dir, [
        (name, {"notary": kind, "raft_cluster": group,
                "notary_shards": shards, "verifier": verifier})
        for group in SHARD_NAMES for name in group] + [
        (name, {"verifier": verifier}) for name in NODE_NAMES[1:]])
    cluster, i = [], 0
    for group in SHARD_NAMES:
        cluster.append(tuple(nodes[i:i + len(group)]))
        i += len(group)
    pump_nodes(nodes, lambda: all(leader_of(c) is not None
                                  for c in cluster), ELECT_TIMEOUT_S)
    return cluster, nodes[i], nodes[i + 1]


def run_shard_workload(api, cluster, alice, bob, workload: Workload,
                       timeout_s: float = 300.0) -> dict:
    """``run_tcp_workload`` against the groups of ``make_shard_nodes``: every
    flow notarises at ``cluster[0][0]`` (the transactions' notary), whose
    provider commits an input its group owns and forwards the rest to the
    owning group; once every flow has its result the nodes are pumped on
    until every member holds its group's share of the notarised inputs. The record adds ``groups_committed``
    (per group, each member's committed inputs) and ``provider_stamps``
    (each member's ``ShardedUniquenessProvider.stamp()``)."""
    from ..node.services.sharding import shard_of

    members = [m for group in cluster for m in group]
    res = run_tcp_workload(api, members[0], alice, bob, workload, timeout_s,
                           others=members[1:])
    count = len(cluster)
    want = [0] * count
    for stx, outcome in zip(workload.moves + workload.doubles,
                            res["outcomes"]):
        if outcome[0] == "ok":
            for ref in stx.tx.inputs:
                want[shard_of(ref, count)] += 1
    pump_nodes((*members, alice, bob), lambda: all(
        m.uniqueness_provider.committed_count >= want[g]
        for g, group in enumerate(cluster) for m in group), timeout_s)
    res["groups_committed"] = [[committed_inputs(m) for m in group]
                               for group in cluster]
    res["provider_stamps"] = {m.config.name: m.uniqueness_provider.stamp()
                              for m in members}
    return res


def start_raft_processes(d, validating: bool, devices: dict,
                         cordapps=()) -> list:
    """Spawn the raft members RAFT_NAMES (one cluster, RPC on) through
    the driver ``d`` (``python -m corda_tpu_torch.node.node``), each placed
    on ``devices[name]`` ("accelerator" or "cpu"; the driver picks the
    verifier from it). RAFT_NAMES[0] is spawned and up before the others
    start, so it registers first in the network map and is the notary the
    demo flow picks. Returns the handles in the order of RAFT_NAMES once
    every member's banner is up."""
    kind = "raft-validating" if validating else "raft-simple"

    def spawn(name):
        return d.start_node(name, notary=kind, raft_cluster=RAFT_NAMES,
                            cordapps=cordapps, rpc=True, wait=False,
                            device=devices.get(name, "cpu"))

    first, *rest = RAFT_NAMES
    handles = [spawn(first).wait_up()] + [spawn(name) for name in rest]
    for h in handles[1:]:
        h.wait_up()
    return handles


def run_open_loop(client, rate_tx_s: float, n: int, first_magic: int,
                  flow: str = "IssueAndNotariseFlow",
                  timeout_s: float = 120.0) -> dict:
    """Start ``n`` ``flow(first_magic + i)`` through the RPC ``client`` at
    ``rate_tx_s``, open loop: flow i's request is sent at its scheduled
    time (or as soon after as the client gets to it) without waiting for
    any reply. A flow's latency runs from its scheduled start to the
    change feed's ("remove", run_id) push. Returns the latencies in
    seconds (start order; None for a flow that did not finish), each
    flow's result (its value, or the RpcError text), the achieved tx/s
    (finished flows over the span from the first scheduled start to the
    last end) and how far behind schedule the last request was sent."""
    from ..node.rpc import RpcError

    done_at: dict = {}

    def on_changes(events, _cursor):
        now = time.perf_counter()
        for event in events:
            if event[0] == "remove":
                done_at.setdefault(bytes(event[1]), now)

    client.subscribe_changes(on_changes)
    t0 = time.perf_counter() + 0.05
    schedule = [t0 + i / rate_tx_s for i in range(n)]
    run_ids: list = [None] * n
    results: list = [None] * n
    pending: dict = {}  # request id -> flow index
    sent, start_lag_s = 0, 0.0
    deadline = schedule[-1] + timeout_s
    while (sent < n or pending) and time.perf_counter() < deadline:
        now = time.perf_counter()
        if sent < n and now >= schedule[sent]:
            start_lag_s = now - schedule[sent]
            pending[client.submit("start_flow_dynamic", flow,
                                  (first_magic + sent,))] = sent
            sent += 1
            continue
        client.poll_push(timeout=min(0.001, schedule[sent] - now)
                         if sent < n else 0.005)
        for request_id in list(pending):
            try:
                done, info = client.take_reply(request_id)
            except RpcError as e:
                results[pending.pop(request_id)] = f"RpcError: {e}"
                continue
            if done:
                run_ids[pending.pop(request_id)] = bytes(info.run_id)
    while (any(r is not None and r not in done_at for r in run_ids)
           and time.perf_counter() < deadline):
        client.poll_push(timeout=0.005)
    for k, run_id in enumerate(run_ids):
        if run_id is None:
            continue
        try:
            done, value = client.call("flow_result", run_id)
            results[k] = value if done else None
        except RpcError as e:
            results[k] = f"RpcError: {e}"
    ends = [done_at.get(r) if r is not None else None for r in run_ids]
    finished = [e for e in ends if e is not None]
    return {
        "latency_s": [None if e is None else e - s
                      for s, e in zip(schedule, ends)],
        "results": results,
        "tx_per_sec": (len(finished) / (max(finished) - t0)
                       if finished else 0.0),
        "start_lag_s": start_lag_s,
    }


def expected_outcomes(workload: Workload) -> list:
    """The outcome kind each transaction must have: a refused own signature
    for the flipped ones, a conflict for the second spends, else a notary
    signature."""
    bad = set(workload.bad)
    kinds = [("NotaryException", "NotarySignaturesMissing") if i in bad
             else ("ok",) for i in range(len(workload.moves))]
    kinds += [("NotaryException", "NotaryConflict")] * len(workload.doubles)
    return kinds


# --- the trader demo (BASELINE config 2, samples/trader-demo) -------------

# The notary (validating), the buyer and the seller.
TRADE_NAMES = ("Notary", "BankA", "BankB")
# bench.py:451-466's terms: a paper of face value 900 USD maturing in a
# week, sold for 750 USD out of the buyer's 800 USD cash states.
PAPER_FACE, BUYER_CASH, PRICE = 900, 800, 750
WEEK_MICROS = 7 * 86_400 * 1_000_000
TIME_WINDOW_MICROS = 30_000_000  # the issue's timestamp, either side of now
BALLAST_CURRENCY = "GBP"  # the buyer's ballast, never spent by a trade
TRADE_RPC_USER = ("bank", "s3cret")  # the banks' RPC login (all permissions)


@dataclasses.dataclass
class Trades:
    issues: list   # the seller's CommercialPaper issues, not yet notarised
    cash: list     # the buyer's self-issued USD cash, one state each
    now_us: int    # the instant the issues are timestamped around


def build_trades(api, notary, buyer, seller, n: int, seed: int,
                 now_us: int) -> Trades:
    """``n`` papers issued by ``seller`` (issuance references from
    ``seed``; timestamped around ``now_us``, maturing a week after it)
    and ``n`` USD cash states self-issued by ``buyer`` (nonces from
    ``seed``). Given the same keys, seed and ``now_us``, every package
    builds byte-equal transactions."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 2**31, n)
    nonces = rng.integers(0, 2**62, n)
    issues, cash = [], []
    for i in range(n):
        ref = seller.identity.ref(int(refs[i]).to_bytes(4, "big"))
        issue = api.CommercialPaper.generate_issue(
            ref, api.Amount(PAPER_FACE, api.Issued(ref, "USD")),
            now_us + WEEK_MICROS, notary.identity)
        issue.set_time(api.Timestamp.around(now_us, TIME_WINDOW_MICROS))
        issue.sign_with(seller.key)
        issues.append(issue.to_signed_transaction(
            check_sufficient_signatures=False))
        coin = api.Cash.generate_issue(
            api.Amount(BUYER_CASH, "USD"),
            buyer.identity.ref(i.to_bytes(4, "big")),
            buyer.identity.owning_key, notary.identity, nonce=int(nonces[i]))
        coin.sign_with(buyer.key)
        cash.append(coin.to_signed_transaction())
    return Trades(issues, cash, now_us)


def make_trade_network(api, verifier):
    """A MockNetwork with the validating notary, the buyer and the seller
    of TRADE_NAMES, created in that order; each state machine's verifier
    a TimedVerifier over ``verifier``."""
    net = api.MockNetwork(verifier=verifier)
    notary = net.create_notary_node(TRADE_NAMES[0], validating=True)
    buyer = net.create_node(TRADE_NAMES[1])
    seller = net.create_node(TRADE_NAMES[2])
    for node in (notary, buyer, seller):
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return net, notary, buyer, seller


def seed_ballast(api, db_path, n: int) -> None:
    """Make the buyer's store at ``db_path`` before its node first starts:
    its seeded identity (``node_seed``) and ``n`` BALLAST_CURRENCY cash
    states it owns, bulk-loaded into the indexed vault through
    ``seed_states`` (the bank-day pre-seed path). The rows are shaped as
    bench_vault_scaling's (bench.py:1181-1189): each a transaction of its
    own, its amount from an LCG spread over 9,973 values."""
    name = TRADE_NAMES[1]
    Path(db_path).parent.mkdir(parents=True, exist_ok=True)
    db = api.NodeDatabase(Path(db_path))
    try:
        key = db.load_or_create_identity(name, node_seed(name))
        me = api.Party.of(name, key.public)
        token = api.Issued(me.ref(b"\x00"), BALLAST_CURRENCY)
        vault = api.IndexedVaultService(db, lambda: {key.public})
        notary = api.Party.of(TRADE_NAMES[0], api.KeyPair.generate(
            node_seed(TRADE_NAMES[0])).public)

        def states():
            for i in range(n):
                qty = 1 + (i * 6364136223846793005
                           + 1442695040888963407) % 9973
                yield api.StateAndRef(
                    api.TransactionState(api.CashState(
                        api.Amount(qty, token), me.owning_key), notary),
                    api.StateRef(api.SecureHash(
                        i.to_bytes(16, "big") + b"vault-bench-pad!"), 0))

        api.seed_states(vault, states())
    finally:
        db.close()


def make_trade_nodes(api, base_dir, verifier: str, ballast_db) -> tuple:
    """(notary, buyer, seller): the nodes of TRADE_NAMES over localhost TCP
    under ``base_dir``, each with ``verifier`` (a config kind), the
    indexed vault, a web API on a free port and an identity seeded as
    ``make_tcp_nodes`` seeds it. The notary is validating and hosts the
    wire network map; the banks register with it and serve RPC to
    TRADE_RPC_USER. The buyer's store is a copy of ``ballast_db`` (from
    ``seed_ballast``). Returns once both banks are registered and have
    fetched the map."""
    base_dir = Path(base_dir)
    (base_dir / TRADE_NAMES[1]).mkdir(parents=True, exist_ok=True)
    shutil.copyfile(ballast_db, base_dir / TRADE_NAMES[1] / "node.db")
    common = {"verifier": verifier, "vault": api.VaultConfig(indexed=True),
              "web_port": 0}
    user, password = TRADE_RPC_USER
    bank = {"map_node": TRADE_NAMES[0], "rpc_users": (
        {"username": user, "password": password, "permissions": ["ALL"]},),
        **common}
    nodes = _start_nodes(api, base_dir, [
        (TRADE_NAMES[0], {"notary": "validating", "map_service": True,
                          **common}),
        (TRADE_NAMES[1], bank), (TRADE_NAMES[2], bank)])
    pump_nodes(nodes, lambda: all(n.netmap_client.registered
                                  and n.netmap_client.fetched
                                  for n in nodes[1:]), 60.0)
    return tuple(nodes)


def _committed_of(notary) -> dict:
    db = getattr(notary, "db", None)
    if db is not None:
        return committed_inputs(notary)
    return {(bytes(ref.txhash.bytes), ref.index): bytes(tx.id.bytes)
            for ref, tx in notary.uniqueness_provider._committed.items()}


def vault_record(api, node, now_us: int) -> dict:
    """The node's USD cash and its papers: ``states`` as sorted (txhash,
    index, TransactionState blob), ``contents`` as the sorted blobs of the
    state data with each paper's maturity taken relative to ``now_us``
    (equal between runs timestamped at different instants), and the
    vault's ``balances``."""
    vault = node.services.vault_service
    sars = list(vault.iter_unconsumed(api.CPState))
    cursor = None
    while True:
        page = vault.query(api.VaultQuery(currency="USD", after=cursor,
                                          page_size=4096))
        sars.extend(page.states)
        cursor = page.next_cursor
        if cursor is None:
            break
    contents = []
    for sar in sars:
        data = sar.state.data
        if isinstance(data, api.CPState):
            data = dataclasses.replace(
                data, maturity_micros=data.maturity_micros - now_us)
        contents.append(api.serialize(data).bytes)
    return {
        "states": sorted((bytes(s.ref.txhash.bytes), s.ref.index,
                          api.serialize(s.state).bytes) for s in sars),
        "contents": sorted(contents),
        "papers": sum(isinstance(s.state.data, api.CPState) for s in sars),
        "balances": dict(vault.balances()),
    }


def _trade_outcome(handle) -> tuple:
    try:
        final = handle.result.result()
    except Exception as e:  # noqa: BLE001 -- the outcome is the record
        error = getattr(e, "error", None)
        return (type(e).__name__,
                type(error).__name__ if error is not None else None)
    return ("ok", bytes(final.id.bytes))


def _run_trades(api, step, nodes, trades: Trades, in_flight: int,
                timeout_s: float) -> dict:
    notary, buyer, seller = nodes
    t_issue = time.perf_counter()
    issued = [seller.start_flow(api.NotaryClientFlow(stx))
              for stx in trades.issues]
    _settle(step, lambda: all(h.result.done for h in issued), timeout_s)
    papers = []
    for stx, h in zip(trades.issues, issued):
        notarised = stx.with_additional_signature(h.result.result())
        seller.services.record_transactions([notarised])
        papers.append(notarised.tx.out_ref(0))
    buyer.services.record_transactions(trades.cash)
    buyer.smm.register_flow_initiator(
        "SellerFlow", lambda party: api.BuyerFlow(
            party, api.Amount(PRICE, "USD"), notary.identity))
    issue_s = time.perf_counter() - t_issue
    n = len(papers)
    starts, ends = [0.0] * n, [0.0] * n
    handles: list = [None] * n
    before = _stages_before(nodes)
    pending: set = set()
    t0 = time.perf_counter()
    k = 0
    deadline = time.monotonic() + timeout_s
    while k < n or pending:
        while k < n and len(pending) < in_flight:
            starts[k] = time.perf_counter()
            handles[k] = seller.start_flow(api.SellerFlow(
                buyer.identity, papers[k], api.Amount(PRICE, "USD")))
            pending.add(k)
            k += 1
        step()
        for j in [j for j in pending if handles[j].result.done]:
            ends[j] = time.perf_counter()
            pending.discard(j)
        if time.monotonic() > deadline:
            raise AssertionError("the trades did not settle")
    outcomes = [_trade_outcome(h) for h in handles]
    wall_s = time.perf_counter() - t0
    # The buyer records the paper from the seller's finality broadcast.
    settled = sum(o[0] == "ok" for o in outcomes)
    _settle(step, lambda: vault_record(api, buyer, trades.now_us)["papers"]
            >= settled, timeout_s)
    trade_inputs = {}
    for h, o in zip(handles, outcomes):
        if o[0] == "ok":
            for ref in h.result.result().tx.inputs:
                trade_inputs[(bytes(ref.txhash.bytes), ref.index)] = o[1]
    return {
        "outcomes": outcomes,
        "paper_ids": [bytes(p.ref.txhash.bytes) for p in papers],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "issue_s": issue_s,
        "settled": settled,
        "committed": _committed_of(notary),
        "trade_inputs": trade_inputs,
        "vaults": {node.identity.name: vault_record(api, node, trades.now_us)
                   for node in (buyer, seller)},
        "nodes": {node.identity.name: _node_record(node, before)
                  for node in nodes},
    }


def run_mock_trades(api, net, notary, buyer, seller, trades: Trades,
                    in_flight: int, timeout_s: float = 300.0) -> dict:
    """The trader demo over ``make_trade_network``'s MockNetwork, as
    bench_trades composes it (bench.py:437-469): the seller notarises its
    issues and records them, the buyer records its cash and answers
    ``SellerFlow`` with ``BuyerFlow``; then each paper is sold for PRICE,
    ``in_flight`` trades started at a time and the network run until they
    finish. Returns each trade's outcome (``("ok", settled tx id)`` or the
    exception's names) and start-to-result time, the notary's committed
    inputs beside the settled trades' inputs, the two banks'
    ``vault_record`` and each node's verify record."""
    return _run_trades(api, net.run_network, (notary, buyer, seller), trades,
                       in_flight, timeout_s)


def run_tcp_trades(api, notary, buyer, seller, trades: Trades,
                   in_flight: int, timeout_s: float = 600.0) -> dict:
    """``run_mock_trades`` over ``make_trade_nodes``' TCP nodes, pumped
    round-robin with ``run_once``: a trade starts as soon as one of the
    ``in_flight`` before it has finished."""
    nodes = (notary, buyer, seller)

    def step():
        for node in nodes:
            node.run_once(timeout=0.001)

    return _run_trades(api, step, nodes, trades, in_flight, timeout_s)


# --- the notary change (flows/state_replacement.py) -----------------------

CHANGE_NAMES = ("Notary", "Notary2", "Alice", "Bob")


def run_notary_change(api, verifier, n: int, seed: int) -> dict:
    """Move ``n`` DummyMultiOwnerStates co-owned by Alice and Bob (magic
    numbers from ``seed``) from the validating Notary to the validating
    Notary2 through ``NotaryChangeFlow`` started on Alice, all in one
    burst over a MockNetwork whose state machines verify through
    ``verifier``; Bob accepts through ``install_notary_change_acceptor``.
    Returns each flow's outcome (``("ok", replacement tx id)`` or the
    exception's names), the old notary's committed inputs, what Bob
    recorded and each node's verify record."""
    net = api.MockNetwork(verifier=verifier)
    try:
        old = net.create_notary_node(CHANGE_NAMES[0], validating=True)
        new = net.create_notary_node(CHANGE_NAMES[1], validating=True)
        alice = net.create_node(CHANGE_NAMES[2])
        bob = net.create_node(CHANGE_NAMES[3])
        nodes = (old, new, alice, bob)
        for node in nodes:
            node.smm.verifier = TimedVerifier(node.smm.verifier)
        api.install_notary_change_acceptor(bob.smm)
        magics = np.random.default_rng(seed).integers(0, 2**31, n)
        owners = (alice.identity.owning_key, bob.identity.owning_key)
        issued = []
        for magic in magics:
            tx = api.TransactionBuilder(notary=old.identity)
            tx.add_output_state(api.DummyMultiOwnerState(int(magic), owners))
            tx.add_command(api.Command(api.DummyCreate(), owners[:1]))
            tx.sign_with(alice.key)
            stx = tx.to_signed_transaction()
            alice.services.record_transactions([stx])
            bob.services.record_transactions([stx])
            issued.append(stx)
        before = _stages_before(nodes)
        t0 = time.perf_counter()
        handles = [alice.start_flow(api.NotaryChangeFlow(
            stx.tx.out_ref(0), new.identity)) for stx in issued]
        net.run_network()
        wall_s = time.perf_counter() - t0
        outcomes = []
        for h in handles:
            try:
                outcomes.append(("ok", bytes(h.result.result().ref.txhash
                                             .bytes)))
            except Exception as e:  # noqa: BLE001 -- the outcome is the record
                outcomes.append((type(e).__name__,))
        bob_txs = bob.services.storage_service.validated_transactions
        return {
            "outcomes": outcomes,
            "new_notaries": [h.result.result().state.notary.name
                             for h, o in zip(handles, outcomes)
                             if o[0] == "ok"],
            "bob_recorded": sum(
                bob_txs.get_transaction(api.SecureHash(o[1])) is not None
                for o in outcomes if o[0] == "ok"),
            "committed": _committed_of(old),
            "issue_ids": [bytes(s.id.bytes) for s in issued],
            "wall_s": wall_s,
            "nodes": {node.identity.name: _node_record(node, before)
                      for node in nodes},
        }
    finally:
        net.stop_nodes()
