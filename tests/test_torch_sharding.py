"""The port's sharded notary: shard map, reservation TTL, cross-shard 2PC.

The port's copy of the JAX package's ``tests/test_sharding.py``, run
against ``corda_tpu_torch`` with verifier "cpu"; its two slow soaks have
port counterparts that need no loadtest tool: in process under the lossy
plan with group 0's leader stopped and rebuilt from its disk, as the
reference's chaos harness does, and through the port's driver. One more
test, run against both packages, shows a stall they share when a group
member stays down (ROADMAP.md queue 3).

Three tiers:

* pure functions (shard_of / service strings / config parsing) — no I/O;
* the replicated state machine's reservation semantics, driven through
  make_apply_command directly against a NodeDatabase with HAND-CRAFTED
  issued_at stamps (determinism means expiry is arithmetic, so the tests
  need no sleeps and no clocks);
* real in-process Nodes — two single-member raft groups over TCP + sqlite —
  driving ShardedUniquenessProvider's poll machines end to end: fast path,
  remote forwarding, the two-phase commit, the cross-shard double-spend
  race, and TTL release after a simulated coordinator crash.

The soaks (chaos plan + leader kill, driver shard cluster) are @slow —
they boot whole fleets and stay out of tier-1.
"""

import time

import pytest

from corda_tpu_torch.contracts.structures import StateRef
from corda_tpu_torch.crypto.hashes import SecureHash
from corda_tpu_torch.crypto.keys import KeyPair
from corda_tpu_torch.crypto.party import Party
from corda_tpu_torch.node.config import NodeConfig, ShardConfig
from corda_tpu_torch.node.node import Node
from corda_tpu_torch.node.services.api import UniquenessConflict, UniquenessException
from corda_tpu_torch.node.services.persistence import NodeDatabase
from corda_tpu_torch.node.services.raft import (
    BUSY,
    WRONG_EPOCH,
    AbortReservedCommand,
    CommitReservedCommand,
    InstallShardStateCommand,
    PutAllCommand,
    ReserveCommand,
    ShardFenceCommand,
    WrongShardEpochException,
    make_apply_command,
)
from corda_tpu_torch.node.services.sharding import (
    ShardedUniquenessProvider,
    parse_reshard_plan,
    parse_shard_service,
    parse_shard_service_full,
    publish_reshard_plan,
    reshard_plan_string,
    shard_of,
    shard_service_string,
    split_by_shard,
)
from corda_tpu_torch.serialization.codec import deserialize, serialize
# The reference chaos harness's client flow: notarise under the product
# retry policy, so a killed leader's availability window is ridden out.
from corda_tpu_torch.tools.loadtest import RetryingNotariseFlow


def _ref(tag: str, index: int = 0) -> StateRef:
    return StateRef(SecureHash.sha256(tag.encode()), index)


def _ref_in_group(group: int, count: int = 2, salt: str = "") -> StateRef:
    i = 0
    while True:
        ref = _ref(f"state-{salt}-{i}")
        if shard_of(ref, count) == group:
            return ref
        i += 1


# -- shard map ---------------------------------------------------------------


def test_shard_of_is_deterministic_and_spreads():
    refs = [_ref(f"s{i}") for i in range(400)]
    for count in (2, 3, 4):
        owners = [shard_of(r, count) for r in refs]
        assert owners == [shard_of(r, count) for r in refs]  # pure
        per_group = [owners.count(g) for g in range(count)]
        assert all(n > 0 for n in per_group), per_group
        # A SHA-256-derived keyspace should not skew grossly.
        assert max(per_group) < 2.5 * min(per_group), per_group
    # count <= 1 is always group 0 (the unsharded degenerate case).
    assert all(shard_of(r, 1) == 0 for r in refs[:10])
    assert all(shard_of(r, 0) == 0 for r in refs[:10])


def test_shard_of_spreads_outputs_of_one_transaction():
    # The XOR with the output index exists so one transaction's outputs do
    # not all land on the shard its txhash happens to pick.
    h = SecureHash.sha256(b"one-tx")
    owners = {shard_of(StateRef(h, i), 4) for i in range(8)}
    assert len(owners) > 1


def test_split_by_shard_partitions_and_preserves_order():
    refs = [_ref(f"p{i}") for i in range(40)]
    by_group = split_by_shard(refs, 4)
    assert {r for g in by_group.values() for r in g} == set(refs)
    for g, grefs in by_group.items():
        assert all(shard_of(r, 4) == g for r in grefs)
        # Order preserved WITHIN a group (commit/abort replay the same
        # ref order the reserve claimed).
        assert sorted(grefs, key=refs.index) == list(grefs)


def test_shard_service_string_roundtrip_and_rejects():
    assert parse_shard_service(shard_service_string(2, 4)) == (2, 4)
    assert parse_shard_service(shard_service_string(0, 1)) == (0, 1)
    for bad in ("corda.notary.simple",          # not the shard prefix
                "corda.notary.shard.4of4",      # group out of range
                "corda.notary.shard.-1of4",
                "corda.notary.shard.1of0",
                "corda.notary.shard.xof4",
                "corda.notary.shard.2of",
                "corda.notary.shard."):
        assert parse_shard_service(bad) is None, bad


def test_config_parses_and_validates_notary_shards(tmp_path):
    raw = {"name": "ShardA", "notary": "raft-simple",
           "raft_cluster": ["ShardA"],
           "notary_shards": {"groups": [["ShardA"], ["ShardB"]],
                             "reserve_ttl_s": 3.5}}
    cfg = NodeConfig.from_dict(dict(raw), default_dir=tmp_path)
    assert cfg.notary_shards == ShardConfig(
        count=2, groups=(("ShardA",), ("ShardB",)), reserve_ttl_s=3.5)

    with pytest.raises(ValueError, match="count=3 but 2 groups"):
        NodeConfig.from_dict(
            {**raw, "notary_shards": {"count": 3,
                                      "groups": [["A"], ["B"]]}},
            default_dir=tmp_path)
    with pytest.raises(ValueError, match="requires a raft"):
        NodeConfig.from_dict(
            {"name": "N", "notary": "simple",
             "notary_shards": {"groups": [["N"]]}}, default_dir=tmp_path)


def test_netmap_register_is_race_free_under_concurrent_boots(tmp_path):
    """Members of a sharded topology boot in parallel and all register in
    the SAME netmap file. The load-modify-replace must be serialised
    (flock): before it was, two simultaneous registrations could each read
    the map missing the other and the loser's entry was silently dropped —
    that group's member stayed unreachable for the whole run (observed as
    per_group_committed [n, 0] with every group-1 tx timing out)."""
    import threading

    from corda_tpu_torch.node.config import netmap_load, netmap_register

    path = tmp_path / "netmap.json"
    names = [f"Node{i}" for i in range(8)]
    keys = {n: KeyPair.generate().public.composite for n in names}
    barrier = threading.Barrier(len(names))

    def boot(name):
        barrier.wait()
        for round_ in range(6):  # re-register like a self-heal would
            netmap_register(path, name, "127.0.0.1", 10_000,
                            keys[name], (f"svc.{name}.{round_}",))

    threads = [threading.Thread(target=boot, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    entries = {e.name: e for e in netmap_load(path)}
    assert sorted(entries) == names  # nobody's registration was clobbered
    # Same-name re-registration replaced, not duplicated, and kept the
    # LAST round's services.
    assert all(entries[n].services == (f"svc.{n}.5",) for n in names)


# -- replicated reservation semantics (no clocks, no sleeps) -----------------


CALLER = Party.of("Tester", KeyPair.generate().public)
TX_A = SecureHash.sha256(b"tx-a")
TX_B = SecureHash.sha256(b"tx-b")
T0 = 1000.0  # an arbitrary coordinator stamp: expiry is pure arithmetic


def _mk(tmp_path):
    db = NodeDatabase(tmp_path / "apply.sqlite")
    return make_apply_command(db), db


def _reserved(db):
    return db.conn.execute(
        "SELECT COUNT(*) FROM reserved_states").fetchone()[0]


def _committed(db):
    return db.conn.execute(
        "SELECT COUNT(*) FROM committed_states").fetchone()[0]


def test_reserve_blocks_unexpired_then_deterministically_steals(tmp_path):
    apply, db = _mk(tmp_path)
    r1 = _ref("ttl-1")
    assert apply(ReserveCommand((r1,), TX_A, CALLER, b"r1",
                                issued_at=T0, ttl_s=5.0)) is None
    assert _reserved(db) == 1
    # A different tx stamped INSIDE the hold bounces (retryable).
    assert apply(ReserveCommand((r1,), TX_B, CALLER, b"r2",
                                issued_at=T0 + 4.9, ttl_s=5.0)) is BUSY
    # The same tx refreshes its own hold (retried phase 1): expiry moves.
    assert apply(ReserveCommand((r1,), TX_A, CALLER, b"r3",
                                issued_at=T0 + 1.0, ttl_s=5.0)) is None
    assert apply(ReserveCommand((r1,), TX_B, CALLER, b"r4",
                                issued_at=T0 + 5.5, ttl_s=5.0)) is BUSY
    # Stamped AT/PAST the refreshed expiry: the deterministic steal — the
    # crashed-coordinator release needs no clock and no janitor.
    assert apply(ReserveCommand((r1,), TX_B, CALLER, b"r5",
                                issued_at=T0 + 6.0, ttl_s=5.0)) is None
    assert _reserved(db) == 1  # REPLACEd, not accumulated


def test_reserve_is_atomic_per_group(tmp_path):
    apply, db = _mk(tmp_path)
    r1, r2 = _ref("atomic-1"), _ref("atomic-2")
    assert apply(ReserveCommand((r2,), TX_B, CALLER, b"r1",
                                issued_at=T0, ttl_s=50.0)) is None
    # TX_A wants both; r2 is held -> BUSY and r1 must NOT be taken (a
    # partial hold would be a lock leak the coordinator never learns of).
    assert apply(ReserveCommand((r1, r2), TX_A, CALLER, b"r2",
                                issued_at=T0 + 1, ttl_s=50.0)) is BUSY
    assert _reserved(db) == 1


def test_putall_respects_and_clears_reservations(tmp_path):
    apply, db = _mk(tmp_path)
    r1 = _ref("put-1")
    assert apply(ReserveCommand((r1,), TX_A, CALLER, b"r1",
                                issued_at=T0, ttl_s=5.0)) is None
    # Foreign unexpired hold bounces a plain commit too (the single-shard
    # fast path must not race a 2PC mid-flight).
    assert apply(PutAllCommand((r1,), TX_B, CALLER, b"p1",
                               issued_at=T0 + 1)) is BUSY
    # The holder itself commits straight through and the hold dissolves.
    assert apply(PutAllCommand((r1,), TX_A, CALLER, b"p2",
                               issued_at=T0 + 1)) is None
    assert (_reserved(db), _committed(db)) == (0, 1)
    # Now the spend is FINAL for everyone else, however late the stamp.
    out = apply(PutAllCommand((r1,), TX_B, CALLER, b"p3",
                              issued_at=T0 + 9999))
    assert isinstance(out, UniquenessConflict)
    # ... and idempotent for the committing tx (re-applied log entries).
    assert apply(PutAllCommand((r1,), TX_A, CALLER, b"p4",
                               issued_at=T0 + 9999)) is None
    assert _committed(db) == 1


def test_commit_reserved_idempotent_and_never_blocked_by_holds(tmp_path):
    apply, db = _mk(tmp_path)
    r1, r2 = _ref("cr-1"), _ref("cr-2")
    assert apply(ReserveCommand((r1,), TX_A, CALLER, b"r1",
                                issued_at=T0, ttl_s=5.0)) is None
    assert apply(CommitReservedCommand((r1,), TX_A, CALLER, b"c1")) is None
    assert (_reserved(db), _committed(db)) == (0, 1)
    # Idempotent: a coordinator retry of phase 2 converges.
    assert apply(CommitReservedCommand((r1,), TX_A, CALLER, b"c2")) is None
    assert _committed(db) == 1
    # Phase-2 TERMINATION: a foreign (even unexpired) hold does not block
    # the commit — the reservation was won in phase 1; re-checking here
    # would let a TTL steal wedge a half-committed 2PC forever. The
    # resulting steal window is the documented tradeoff.
    assert apply(ReserveCommand((r2,), TX_B, CALLER, b"r2",
                                issued_at=T0, ttl_s=10_000.0)) is None
    assert apply(CommitReservedCommand((r2,), TX_A, CALLER, b"c3")) is None
    assert _committed(db) == 2
    # Committed-by-another-tx stays final though.
    out = apply(CommitReservedCommand((r1,), TX_B, CALLER, b"c4"))
    assert isinstance(out, UniquenessConflict)


def test_abort_releases_only_its_own_holds(tmp_path):
    apply, db = _mk(tmp_path)
    r1, r2 = _ref("ab-1"), _ref("ab-2")
    assert apply(ReserveCommand((r1,), TX_A, CALLER, b"r1",
                                issued_at=T0, ttl_s=50.0)) is None
    assert apply(ReserveCommand((r2,), TX_B, CALLER, b"r2",
                                issued_at=T0, ttl_s=50.0)) is None
    # TX_A aborts both refs; only ITS hold may dissolve (a late abort from
    # a retried coordinator must not release someone else's phase 1).
    assert apply(AbortReservedCommand((r1, r2), TX_A, b"a1")) is None
    assert _reserved(db) == 1
    row = db.conn.execute(
        "SELECT tx_id FROM reserved_states").fetchone()
    assert bytes(row[0]) == TX_B.bytes
    # Aborting nothing is fine — abort never adds a failure mode.
    assert apply(AbortReservedCommand((r1,), TX_A, b"a2")) is None


# -- in-process cross-shard networks -----------------------------------------


SHARD_NAMES = ("ShardA", "ShardB")


def make_shard_net(tmp_path, ttl_s=15.0):
    cfg = ShardConfig(count=2, groups=(("ShardA",), ("ShardB",)),
                      reserve_ttl_s=ttl_s)
    nodes = []
    for name in SHARD_NAMES:
        nodes.append(Node(NodeConfig(
            name=name,
            verifier="cpu",
            base_dir=tmp_path / name,
            notary="raft-simple",
            raft_cluster=(name,),
            network_map=tmp_path / "netmap.json",
            notary_shards=cfg,
        )).start())
    for n in nodes:
        n.refresh_netmap()
    return nodes


def wait_group_leaders(nodes, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for n in nodes:
            n.run_once(timeout=0.005)
        if all(n.raft_member.role == "leader" for n in nodes):
            for n in nodes:
                n.refresh_netmap()
            return
    raise AssertionError("single-member groups failed to self-elect")


def drive(nodes, poll, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = poll()
        if out is not None:
            return out
        for n in nodes:
            n.run_once(timeout=0.005)
            n.refresh_netmap_maybe(every=0.2)
    raise AssertionError("poll did not decide in time")


def test_node_boots_sharded_provider_and_advertises_group(tmp_path):
    nodes = make_shard_net(tmp_path)
    try:
        for i, n in enumerate(nodes):
            assert isinstance(n.uniqueness_provider,
                              ShardedUniquenessProvider)
            assert n.uniqueness_provider.my_group == i
        # The shard service string rides the netmap so CLIENTS can build
        # the directory from the map alone.
        from corda_tpu_torch.flows.notary import _shard_directory

        class _FakeFlow:
            class service_hub:
                network_map_cache = nodes[0].services.network_map_cache

        directory = _shard_directory(_FakeFlow)
        assert directory is not None
        count, groups = directory
        assert count == 2
        assert sorted(p.name for ps in groups.values() for p in ps) == \
            list(SHARD_NAMES)
    finally:
        for n in nodes:
            n.stop()


def test_single_shard_fast_path_and_remote_forwarding(tmp_path):
    nodes = make_shard_net(tmp_path)
    try:
        wait_group_leaders(nodes)
        prov = nodes[0].uniqueness_provider
        # Fast path: a ref OWNED by the local group — plain raft commit.
        local_ref = _ref_in_group(0, salt="fast")
        assert drive(nodes, prov.commit_async(
            (local_ref,), SecureHash.sha256(b"fast-tx"),
            nodes[0].identity)) is True
        assert prov.stamp()["single_shard"] == 1
        assert nodes[0].uniqueness_provider.committed_count == 1
        # Remote single group: committed THROUGH node 0, lands on group 1's
        # ledger — no 2PC, one forwarded PutAll.
        remote_ref = _ref_in_group(1, salt="remote")
        assert drive(nodes, prov.commit_async(
            (remote_ref,), SecureHash.sha256(b"remote-tx"),
            nodes[0].identity)) is True
        assert prov.stamp()["remote_single"] == 1
        assert nodes[1].uniqueness_provider.committed_count == 1
        assert nodes[0].uniqueness_provider.committed_count == 1
    finally:
        for n in nodes:
            n.stop()


def test_cross_shard_two_phase_commit_and_double_spend(tmp_path):
    nodes = make_shard_net(tmp_path)
    try:
        wait_group_leaders(nodes)
        prov = nodes[0].uniqueness_provider
        ra = _ref_in_group(0, salt="x0")
        rb = _ref_in_group(1, salt="x1")
        tx1 = SecureHash.sha256(b"cross-tx-1")
        assert drive(nodes, prov.commit_async(
            (ra, rb), tx1, nodes[0].identity)) is True
        assert prov.stamp()["cross_shard"] == 1
        # Each group durably owns its half; no reservation survives.
        for n in nodes:
            assert n.uniqueness_provider.committed_count == 1
            assert n.raft_member.db.conn.execute(
                "SELECT COUNT(*) FROM reserved_states").fetchone()[0] == 0
        # Exactly-once: a retry of the SAME tx converges to success
        # (reserve treats committed-by-this-tx as ok; commit idempotent).
        assert drive(nodes, prov.commit_async(
            (ra, rb), tx1, nodes[0].identity)) is True
        for n in nodes:
            assert n.uniqueness_provider.committed_count == 1
        # A DIFFERENT tx spending either half is a final double-spend.
        poll = prov.commit_async((ra,), SecureHash.sha256(b"thief"),
                                 nodes[0].identity)
        with pytest.raises(UniquenessException):
            drive(nodes, poll)
    finally:
        for n in nodes:
            n.stop()


def test_concurrent_cross_shard_race_exactly_one_wins(tmp_path):
    """Two coordinators (one per group) race the SAME two inputs with
    different txs. Ordered acquisition serializes them at the lowest
    contended group: exactly one commits, the other sees a final conflict,
    and the ledgers hold each ref exactly once."""
    nodes = make_shard_net(tmp_path, ttl_s=60.0)  # TTL must NOT be the
    # resolution mechanism here — a steal would mask an ordering bug
    try:
        wait_group_leaders(nodes)
        ra = _ref_in_group(0, salt="race0")
        rb = _ref_in_group(1, salt="race1")
        polls = {
            "a": nodes[0].uniqueness_provider.commit_async(
                (ra, rb), SecureHash.sha256(b"race-a"), nodes[0].identity),
            "b": nodes[1].uniqueness_provider.commit_async(
                (ra, rb), SecureHash.sha256(b"race-b"), nodes[1].identity),
        }
        outcomes = {}
        deadline = time.monotonic() + 30.0
        while len(outcomes) < 2 and time.monotonic() < deadline:
            for key, poll in polls.items():
                if key in outcomes:
                    continue
                try:
                    out = poll()
                except UniquenessException:
                    outcomes[key] = "conflict"
                else:
                    if out is not None:
                        outcomes[key] = "ok"
            for n in nodes:
                n.run_once(timeout=0.005)
                n.refresh_netmap_maybe(every=0.2)
        assert sorted(outcomes.values()) == ["conflict", "ok"], outcomes
        # Each ref committed exactly once across the two ledgers, and the
        # loser's unwind left no live reservation anywhere.
        for n in nodes:
            assert n.uniqueness_provider.committed_count == 1
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            leaks = sum(n.raft_member.db.conn.execute(
                "SELECT COUNT(*) FROM reserved_states").fetchone()[0]
                for n in nodes)
            if leaks == 0:
                break
            for n in nodes:  # the loser's aborts are still in flight
                n.run_once(timeout=0.005)
        assert leaks == 0
    finally:
        for n in nodes:
            n.stop()


def test_crashed_coordinator_reservation_released_by_ttl(tmp_path):
    """A reservation whose coordinator vanished (simulated: the command is
    injected directly, no 2PC follows) must release by TTL: a later spend
    bounces while the hold is live, then steals deterministically once its
    re-stamped resubmission passes the expiry."""
    nodes = make_shard_net(tmp_path, ttl_s=1.0)
    try:
        wait_group_leaders(nodes)
        victim_ref = _ref_in_group(1, salt="crash")
        ghost_tx = SecureHash.sha256(b"ghost-coordinator")
        import os as _os
        nodes[1].raft_member.submit(ReserveCommand(
            (victim_ref,), ghost_tx, nodes[1].identity, _os.urandom(16),
            issued_at=time.time(), ttl_s=1.0))

        def _held():
            return nodes[1].raft_member.db.conn.execute(
                "SELECT COUNT(*) FROM reserved_states").fetchone()[0]

        deadline = time.monotonic() + 10.0
        while _held() == 0 and time.monotonic() < deadline:
            for n in nodes:
                n.run_once(timeout=0.005)
        assert _held() == 1  # the ghost's hold is replicated and live

        # Now a real client spends through node 0 (remote single-group
        # path): resubmissions re-stamp issued_at every 0.5 s, so the poll
        # bounces BUSY until the stamp passes expiry, then commits.
        prov = nodes[0].uniqueness_provider
        t0 = time.monotonic()
        assert drive(nodes, prov.commit_async(
            (victim_ref,), SecureHash.sha256(b"claimant"),
            nodes[0].identity), timeout=20.0) is True
        assert time.monotonic() - t0 >= 0.5  # it actually waited the hold out
        assert _held() == 0
        assert nodes[1].uniqueness_provider.committed_count == 1
    finally:
        for n in nodes:
            n.stop()


# -- elastic resharding (round 13) -------------------------------------------


def test_epoch_service_strings_and_reshard_plan_parse():
    # Epoch 0 emits the BARE pre-reshard format (old clients keep parsing).
    assert shard_service_string(2, 4) == "corda.notary.shard.2of4"
    assert parse_shard_service_full(shard_service_string(2, 4)) == (2, 4, 0)
    assert parse_shard_service_full(shard_service_string(2, 4, epoch=3)) \
        == (2, 4, 3)
    # The 2-tuple parser stays epoch-blind for its existing callers.
    assert parse_shard_service(shard_service_string(2, 4, epoch=3)) == (2, 4)
    assert parse_shard_service_full("corda.notary.shard.2of4@x") is None
    assert parse_reshard_plan(reshard_plan_string(1, 2, 4)) == (1, 2, 4)
    assert parse_reshard_plan(reshard_plan_string(2, 4, 2)) == (2, 4, 2)
    for bad in ("corda.notary.reshard.0:2to4",   # epoch must be >= 1
                "corda.notary.reshard.1:2to3",   # not a double/halve
                "corda.notary.reshard.1:2to",
                "corda.notary.shard.1of2"):
        assert parse_reshard_plan(bad) is None, bad


def test_seal_fences_only_the_moving_keyspace(tmp_path):
    """mode="seal" on the source of a 1 -> 2 split: refs moving to the new
    group bounce WRONG_EPOCH (retryable after a directory re-derive), refs
    the group keeps commit straight through — the unmoved majority sees no
    outage. Abort stays exempt so 2PC unwinds never wedge on a fence."""
    apply, db = _mk(tmp_path)
    kept = _ref_in_group(0, count=2, salt="seal-keep")
    moved = _ref_in_group(1, count=2, salt="seal-move")
    assert apply(PutAllCommand((moved,), TX_A, CALLER, b"p0",
                               issued_at=T0)) is None
    assert apply(ShardFenceCommand(0, 1, 2, 1, "seal", b"f1")) is None
    moved2 = _ref_in_group(1, count=2, salt="seal-move-2")
    assert apply(PutAllCommand((moved2,), TX_B, CALLER, b"p1",
                               issued_at=T0 + 1)) is WRONG_EPOCH
    assert apply(ReserveCommand((moved2,), TX_B, CALLER, b"r1",
                                issued_at=T0 + 1, ttl_s=5.0)) is WRONG_EPOCH
    assert apply(PutAllCommand((kept,), TX_B, CALLER, b"p2",
                               issued_at=T0 + 1)) is None
    # Abort is NEVER fenced: releasing holds must work mid-handoff.
    assert apply(AbortReservedCommand((moved2,), TX_B, b"a1")) is None
    # Seal is idempotent (coordinator retry / log replay).
    assert apply(ShardFenceCommand(0, 1, 2, 1, "seal", b"f2")) is None


def test_handoff_install_activate_and_purge(tmp_path):
    """The full two-phase state handoff at the apply layer: seal the
    source, stream the moved slice, fence-then-activate the target, purge
    the source. Exactly-once is structural — the moved spend stays final
    on the new owner (with its consuming-tx provenance), and the sum of
    per-group rows never double-counts."""
    for d in ("src", "dst"):
        (tmp_path / d).mkdir()
    s_apply, s_db = _mk(tmp_path / "src")
    t_apply, t_db = _mk(tmp_path / "dst")
    kept = _ref_in_group(0, count=2, salt="ho-keep")
    moved = _ref_in_group(1, count=2, salt="ho-move")
    assert s_apply(PutAllCommand((kept, moved), TX_A, CALLER, b"p0",
                                 issued_at=T0)) is None
    assert s_apply(ShardFenceCommand(0, 1, 2, 1, "seal", b"f0")) is None
    rows = s_db.conn.execute(
        "SELECT state_ref, consuming FROM committed_states").fetchall()
    moved_rows = tuple(
        (bytes(b), bytes(c)) for b, c in rows
        if shard_of(deserialize(bytes(b)), 2) == 1)
    assert len(moved_rows) == 1
    assert t_apply(InstallShardStateCommand(
        moved_rows, (), 1, 1, 2, 1, b"i0")) is None
    # First frame fenced the target "importing": a new-epoch client racing
    # ahead of the cutover bounces instead of committing against a
    # half-installed ledger.
    assert t_apply(PutAllCommand((moved,), TX_B, CALLER, b"p1",
                                 issued_at=T0 + 1)) is WRONG_EPOCH
    # Re-install is idempotent (retried frame / log replay).
    assert t_apply(InstallShardStateCommand(
        moved_rows, (), 1, 1, 2, 1, b"i1")) is None
    assert _committed(t_db) == 1
    assert t_apply(ShardFenceCommand(1, 1, 2, 1, "activate", b"f1")) is None
    # Final for a thief — the streamed row carries its consuming tx...
    out = t_apply(PutAllCommand((moved,), TX_B, CALLER, b"p2",
                                issued_at=T0 + 2))
    assert isinstance(out, UniquenessConflict)
    # ...and idempotent for the committing tx (retries converge).
    assert t_apply(PutAllCommand((moved,), TX_A, CALLER, b"p3",
                                 issued_at=T0 + 2)) is None
    # The target only serves the keyspace it owns at the new count.
    assert t_apply(PutAllCommand((kept,), TX_B, CALLER, b"p4",
                                 issued_at=T0 + 2)) is WRONG_EPOCH
    # Source activation purges the moved rows (the target's quorum owns
    # them durably by now) and keeps the rest — the cross-group row sum
    # stays exactly the consumed refs.
    assert s_apply(ShardFenceCommand(0, 1, 2, 1, "activate", b"f2")) is None
    assert _committed(s_db) == 1
    (left,) = s_db.conn.execute(
        "SELECT state_ref FROM committed_states").fetchone()
    assert shard_of(deserialize(bytes(left)), 2) == 0
    assert s_apply(PutAllCommand((moved,), TX_B, CALLER, b"p5",
                                 issued_at=T0 + 3)) is WRONG_EPOCH


def test_streamed_reservation_releases_by_original_ttl(tmp_path):
    """Crashed-handoff-coordinator backstop: a 2PC hold streamed
    mid-handoff keeps its ORIGINAL coordinator-stamped expires_at on the
    new owner, so even if both the 2PC and the handoff coordinator die
    forever, the hold releases by the same deterministic TTL arithmetic —
    on a group that never saw the original reserve."""
    t_apply, t_db = _mk(tmp_path)
    held = _ref_in_group(1, count=2, salt="ttl-stream")
    assert t_apply(InstallShardStateCommand(
        (), ((serialize(held).bytes, TX_A.bytes, T0 + 5.0),),
        1, 1, 2, 1, b"i0")) is None
    assert t_apply(ShardFenceCommand(1, 1, 2, 1, "activate", b"f0")) is None
    assert _reserved(t_db) == 1
    # Inside the hold: enforced on the new owner exactly as on the old.
    assert t_apply(PutAllCommand((held,), TX_B, CALLER, b"p0",
                                 issued_at=T0 + 4.9)) is BUSY
    # Stamped at/past the original expiry: the deterministic steal.
    assert t_apply(PutAllCommand((held,), TX_B, CALLER, b"p1",
                                 issued_at=T0 + 5.0)) is None
    assert (_reserved(t_db), _committed(t_db)) == (0, 1)


def test_live_split_old_epoch_bounce_rederive_exactly_once(tmp_path):
    """The tentpole end to end, deterministically: a 1 -> 2 split over two
    in-process nodes (group 1 booted as a PENDING target). An old-epoch
    submission hits the sealed source and surfaces WrongShardEpochException
    — resubmitting to the same group can never succeed — then the
    plan-driven handoff runs to completion through the node loop, routing
    re-derives, and the SAME transactions converge exactly once with the
    moved history answering on the new owner."""
    import os as _os

    cfg = ShardConfig(count=1, groups=(("ShardA",), ("ShardB",)),
                      reserve_ttl_s=15.0)
    nodes = []
    for name in SHARD_NAMES:
        nodes.append(Node(NodeConfig(
            name=name, verifier="cpu",
            base_dir=tmp_path / name, notary="raft-simple",
            raft_cluster=(name,), network_map=tmp_path / "netmap.json",
            notary_shards=cfg)).start())
    try:
        for n in nodes:
            n.refresh_netmap()
        wait_group_leaders(nodes)
        prov = nodes[0].uniqueness_provider
        assert (prov.count, prov.epoch) == (1, 0)
        moved = _ref_in_group(1, count=2, salt="live-move")
        tx_m = SecureHash.sha256(b"live-moved-tx")
        # Pre-split: EVERYTHING routes to group 0 (count=1 fast path).
        assert drive(nodes, prov.commit_async(
            (moved,), tx_m, nodes[0].identity)) is True
        assert nodes[0].uniqueness_provider.committed_count == 1

        # Seal group 0 by hand (the coordinator's first step) so the
        # old-epoch bounce is deterministic, not a race with the stream.
        nodes[0].raft_member.submit(
            ShardFenceCommand(0, 1, 2, 1, "seal", _os.urandom(16)))

        def _sealed():
            f = prov._read_fence()
            return True if f and f["mode"] == "sealed" else None

        drive(nodes, _sealed)
        moved2 = _ref_in_group(1, count=2, salt="live-move-2")
        tx_2 = SecureHash.sha256(b"live-post-split-tx")
        with pytest.raises(WrongShardEpochException):
            drive(nodes, prov.commit_async(
                (moved2,), tx_2, nodes[0].identity))
        assert prov.metrics["wrong_epoch"] >= 1

        # Publish the plan; the node loop picks it up off the netmap and
        # the source leader re-runs seal -> stream -> activate (idempotent
        # over the manual seal) to completion.
        publish_reshard_plan(tmp_path / "netmap.json", 1, 1, 2,
                             nodes[0].identity.owning_key)

        def _adopted():
            done = all(
                n.uniqueness_provider.epoch >= 1
                and n.uniqueness_provider.count == 2 for n in nodes)
            return True if done else None

        drive(nodes, _adopted, timeout=30.0)

        # Re-derived routing: the bounced tx now lands on group 1 and
        # commits; the pre-split spend is idempotent for its own tx and
        # FINAL for a thief — served by the NEW owner from streamed state.
        assert drive(nodes, prov.commit_async(
            (moved2,), tx_2, nodes[0].identity)) is True
        assert drive(nodes, prov.commit_async(
            (moved,), tx_m, nodes[0].identity)) is True
        with pytest.raises(UniquenessException):
            drive(nodes, prov.commit_async(
                (moved,), SecureHash.sha256(b"live-thief"),
                nodes[0].identity))
        # Exactly-once across the ledgers: each spend exactly one row, the
        # moved history purged from the source.
        assert nodes[0].uniqueness_provider.committed_count == 0
        assert nodes[1].uniqueness_provider.committed_count == 2
        assert prov.stamp()["epoch"] == 1
        assert nodes[0].uniqueness_provider.metrics["resharded"] == 1
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.xfail(strict=True, raises=TimeoutError, reason=(
    "ROADMAP.md queue 3: the cross-group channel targets a group's first "
    "member until a reply names another (ShardedUniquenessProvider._targets), "
    "so a stopped target stalls every commit into that group, the same in "
    "both packages"))
@pytest.mark.parametrize("package", ["corda_tpu", "corda_tpu_torch"])
def test_cross_shard_commit_survives_a_stopped_member(tmp_path, package):
    """Group 0 has three members and group 1 one. Shard0A, group 0's first
    member, is stopped for good once group 0 has elected; Shard0B and
    Shard0C still make a quorum and elect among themselves. A cross-shard
    commit coordinated by Shard1A must then be decided within a few
    resubmit periods. Both packages keep sending it to Shard0A, which never
    answers, so no hint ever moves the target."""
    import importlib

    def mod(sub):
        return importlib.import_module(f"{package}.{sub}")

    node_mod, config = mod("node.node"), mod("node.config")
    structures, hashes = mod("contracts.structures"), mod("crypto.hashes")
    shard_of_ = mod("node.services.sharding").shard_of
    groups = (("Shard0A", "Shard0B", "Shard0C"), ("Shard1A",))
    shards = config.ShardConfig(count=2, groups=groups)
    nodes = {name: node_mod.Node(config.NodeConfig(
        name=name, base_dir=tmp_path / name, port=0, notary="raft-simple",
        raft_cluster=group, network_map=tmp_path / "netmap.json",
        notary_shards=shards, verifier="cpu")).start()
        for group in groups for name in group}
    live = list(nodes.values())

    def pump_until(predicate, what):
        deadline = time.monotonic() + 30.0
        while not predicate():
            assert time.monotonic() < deadline, what
            for node in live:
                node.run_once(timeout=0.002)
                node.refresh_netmap_maybe(every=0.2)

    def led(names):
        return any(nodes[n].raft_member.role == "leader" for n in names)

    def ref_in(group):
        i = 0
        while True:
            ref = structures.StateRef(
                hashes.SecureHash.sha256(f"stall-{i}".encode()), 0)
            if shard_of_(ref, 2) == group:
                return ref
            i += 1

    try:
        for node in live:
            node.refresh_netmap()
        pump_until(lambda: led(groups[0]) and led(groups[1]), "no leaders")
        nodes["Shard0A"].stop()
        live.remove(nodes["Shard0A"])
        pump_until(lambda: led(("Shard0B", "Shard0C")), "group 0 never led")
        coordinator = nodes["Shard1A"]
        poll = coordinator.uniqueness_provider.commit_async(
            (ref_in(0), ref_in(1)), hashes.SecureHash.sha256(b"stall-tx"),
            coordinator.identity)
        deadline = time.monotonic() + 8.0  # 16 resubmit periods
        while poll() is None:
            if time.monotonic() > deadline:
                raise TimeoutError("the cross-shard commit was not decided")
            for node in live:
                node.run_once(timeout=0.002)
    finally:
        for node in nodes.values():
            node.stop()


# -- multi-group soaks (out of tier-1) ---------------------------------------


def _cross_mix(api, alice, notary, n_tx, cross_every, shards, magic0=1):
    """``n_tx`` moves from Alice, each every ``cross_every``-th spending two
    inputs that live on different groups (the two-phase commit), else one;
    the issues are recorded on Alice."""
    from corda_tpu_torch.testing.dummies import DummyContract

    def issue(i):
        builder = DummyContract.generate_initial(
            alice.identity.ref(i.to_bytes(4, "big")), i, notary)
        builder.sign_with(alice.key)
        stx = builder.to_signed_transaction()
        alice.services.record_transactions([stx])
        return stx.tx.out_ref(0)

    stxs, cross = [], 0
    for i in range(n_tx):
        priors = [issue(magic0 + i)]
        if cross_every and i % cross_every == 0:
            cross += 1
            for attempt in range(1, 17):
                p2 = issue(magic0 + i + n_tx * attempt)
                if shard_of(p2.ref, shards) != shard_of(priors[0].ref,
                                                        shards):
                    break
            priors.append(p2)
        move = DummyContract.move(priors, alice.identity.owning_key)
        move.sign_with(alice.key)
        stxs.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    return stxs, cross


def _audit(stxs, committed_by_group, shards):
    """Exactly once: every input of every move is committed once, on the
    group shard_of names, consumed by its move; nothing else is."""
    want = {}
    for stx in stxs:
        for ref in stx.tx.inputs:
            want[(bytes(ref.txhash.bytes), ref.index)] = bytes(stx.id.bytes)
    seen = {}
    for g, rows in committed_by_group.items():
        for key, tx in rows.items():
            assert key not in seen, "an input committed on two groups"
            ref = StateRef(SecureHash(key[0]), key[1])
            assert shard_of(ref, shards) == g
            seen[key] = tx
    assert seen == want


@pytest.mark.slow
def test_chaos_sharded_exactly_once_under_faults(tmp_path):
    """The reference's soak (``run_chaos_loadtest(plan="lossy", n_tx=24,
    cluster_size=3, kill_leader=True, shards=2, cross_frac=0.25)``, whose
    tool is not ported) in this process: 2 groups x 3 members, the lossy
    transport plan armed before any node boots, every fourth move
    cross-shard, group 0's LEADER stopped once a third of the moves are
    done and rebuilt from its disk. Every move notarises exactly once,
    each group's ledger holds exactly its inputs on every member, and no
    reservation survives the drain."""
    from corda_tpu_torch.testing import faults
    from corda_tpu_torch.testing import notary_load as nl

    groups = [list(g) for g in nl.SHARD_NAMES]
    cfg = ShardConfig(count=2, groups=nl.SHARD_NAMES, reserve_ttl_s=15.0)

    def start(config):
        return Node(config).start()

    def member_config(name, group):
        return NodeConfig(name=name, verifier="cpu",
                          base_dir=tmp_path / name, notary="raft-simple",
                          raft_cluster=tuple(group),
                          network_map=tmp_path / "netmap.json",
                          notary_shards=cfg)

    faults.arm(faults.builtin_plan("lossy"))
    nodes = {}
    alice = None
    try:
        for g in groups:
            for name in g:
                nodes[name] = start(member_config(name, g))
        alice = start(NodeConfig(name="Alice", verifier="cpu",
                                 base_dir=tmp_path / "Alice",
                                 network_map=tmp_path / "netmap.json"))
        everyone = [*nodes.values(), alice]
        for n in everyone:
            n.refresh_netmap()
        nl.pump_nodes(everyone, lambda: all(
            nl.leader_of([nodes[m] for m in g]) is not None
            for g in groups), 60.0)
        stxs, cross = _cross_mix(nl.port_api(), alice,
                                 nodes["Shard0A"].identity, 24, 4, 2)
        assert cross == 6
        handles = [alice.start_flow(RetryingNotariseFlow(s, 60.0))
                   for s in stxs]
        killed = None
        deadline = time.monotonic() + 180.0
        while not all(h.result.done for h in handles):
            assert time.monotonic() < deadline, [
                k for k, h in enumerate(handles) if not h.result.done]
            for n in everyone:
                n.run_once(timeout=0.002)
            done = sum(h.result.done for h in handles)
            leader = nl.leader_of([nodes[m] for m in groups[0]])
            if killed is None and done >= len(stxs) // 3 and leader:
                killed = leader.config
                leader.stop()
                everyone.remove(leader)
                nodes[killed.name] = start(killed)  # rebuilt from its disk
                everyone.append(nodes[killed.name])
                for n in everyone:
                    n.refresh_netmap()
        assert killed is not None
        for h in handles:
            h.result.result()  # every move notarised, none refused
        faults.disarm()
        n_inputs = [sum(shard_of(r, 2) == g for s in stxs
                        for r in s.tx.inputs) for g in range(2)]
        nl.pump_nodes(everyone, lambda: all(
            nodes[m].uniqueness_provider.committed_count == n_inputs[g]
            for g in range(2) for m in groups[g]), 60.0)
        for g in range(2):
            rows = [nl.committed_inputs(nodes[m]) for m in groups[g]]
            assert all(r == rows[0] for r in rows)
            for m in groups[g]:
                assert nodes[m].raft_member.db.conn.execute(
                    "SELECT COUNT(*) FROM reserved_states").fetchone()[0] == 0
        _audit(stxs, {g: nl.committed_inputs(nodes[groups[g][0]])
                      for g in range(2)}, 2)
    finally:
        faults.disarm()
        for n in [*nodes.values(), alice]:
            if n is not None:
                n.stop()


@pytest.mark.slow
def test_multiprocess_shard_cluster_cross_mix(tmp_path):
    """Driver-booted 2-shard topology (one member a group, real OS
    processes) with Alice in this process, a quarter of the moves
    cross-shard: every move notarises, each group's sqlite ledger holds
    exactly its inputs, no reservation is left, and every member exits 0
    on SIGTERM."""
    import sqlite3

    from corda_tpu_torch.flows.notary import NotaryClientFlow
    from corda_tpu_torch.testing import notary_load as nl
    from corda_tpu_torch.testing.driver import driver

    with driver(tmp_path / "mp") as d:
        rows = d.start_shard_cluster(
            groups=2, members=1, notary="raft-simple",
            cordapps=("corda_tpu_torch.testing.dummies",))
        alice = Node(NodeConfig(
            name="Alice", verifier="cpu", base_dir=tmp_path / "Alice",
            network_map=d.netmap)).start()
        try:
            deadline = time.monotonic() + 30.0
            while {"Shard0A", "Shard1A"} - {
                    n.legal_identity.name
                    for n in alice.network_map_cache.party_nodes}:
                assert time.monotonic() < deadline
                alice.refresh_netmap()
                time.sleep(0.1)
            notary = next(
                n.legal_identity
                for n in alice.network_map_cache.party_nodes
                if n.legal_identity.name == "Shard0A")
            stxs, cross = _cross_mix(nl.port_api(), alice, notary, 24, 4, 2)
            assert cross > 0
            handles = [alice.start_flow(NotaryClientFlow(s)) for s in stxs]
            nl.pump_nodes([alice], lambda: all(h.result.done
                                               for h in handles), 120.0)
            for h in handles:
                h.result.result()
            _audit(stxs, {g: nl.committed_inputs_at(
                rows[g][0].base_dir / "node.db") for g in range(2)}, 2)
            for g in range(2):
                conn = sqlite3.connect(
                    f"file:{rows[g][0].base_dir / 'node.db'}?mode=ro",
                    uri=True)
                try:
                    assert conn.execute("SELECT COUNT(*) FROM "
                                        "reserved_states").fetchone()[0] == 0
                finally:
                    conn.close()
        finally:
            alice.stop()
        for row in rows:
            for h in row:
                h.process.terminate()
                assert h.process.wait(timeout=60) == 0
