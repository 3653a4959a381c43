"""The port's node-tier services: RPC, scheduler, vault rebuild, progress
tracking, the change feed and the flow-to-transaction mappings.

The port's mirror of ``tests/test_node_services.py`` and
``tests/test_tx_mapping.py``, on port nodes with ``verifier = "cpu"``; the
wire network map also between one package's map node and the other's
members. Test-local codec classes are registered
only while this module's tests run: other test modules read the port's
registry as the set of its own classes.
"""

import time
from dataclasses import dataclass

import pytest

from corda_tpu_torch.contracts.structures import (
    Contract,
    SchedulableState,
    TypeOnlyCommandData,
    now_micros,
)
from corda_tpu_torch.crypto.hashes import SecureHash
from corda_tpu_torch.flows.api import FlowLogic, register_flow
from corda_tpu_torch.node.config import NodeConfig
from corda_tpu_torch.node.node import Node
from corda_tpu_torch.node.rpc import RpcClient, RpcError
from corda_tpu_torch.node.services.scheduler import ScheduledActivity
from corda_tpu_torch.serialization.codec import register
from corda_tpu_torch.utils.progress import Change, ProgressTracker, Step

import os
import sys
sys.path.insert(0, os.path.dirname(__file__))
from test_torch_tcp_node import issue_and_move, pump_until  # noqa: E402


RPC_USERS = ({"username": "demo", "password": "s3cret",
              "permissions": ["ALL"]},
             {"username": "limited", "password": "pw", "permissions": []})


@register_flow
class PingFlow(FlowLogic):
    """Trivial whitelisted flow for RPC start tests."""

    def __init__(self, payload: str):
        self.payload = payload

    def call(self):
        return f"pong:{self.payload}"


class TestRpc:
    def _node(self, tmp_path):
        return Node(NodeConfig(
            name="RpcNode", base_dir=tmp_path / "RpcNode",
            network_map=tmp_path / "netmap.json", verifier="cpu",
            rpc_users=RPC_USERS)).start()

    def test_auth_and_start_flow(self, tmp_path):
        import threading

        node = self._node(tmp_path)
        client = RpcClient(node.messaging.my_address, "demo", "s3cret")
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                node.run_once(timeout=0.01)

        pumper = threading.Thread(target=pump, daemon=True)
        pumper.start()
        try:
            handle = client.start_flow("PingFlow", "hello")
            value = client.wait_for_flow(handle)
            assert value == "pong:hello"
            assert client.call("node_identity") == node.identity
        finally:
            stop.set()
            pumper.join(timeout=2)
            client.close()
            node.stop()

    def test_bad_password_rejected(self, tmp_path):
        node = self._node(tmp_path)
        client = RpcClient(node.messaging.my_address, "demo", "WRONG",
                           timeout=5.0)
        try:
            import threading
            pumper = threading.Thread(
                target=lambda: [node.run_once(timeout=0.01)
                                for _ in range(300)], daemon=True)
            pumper.start()
            with pytest.raises(RpcError, match="authentication"):
                client.call("vault_snapshot")
        finally:
            client.close()
            node.stop()

    def test_permissions_gate_flow_start(self, tmp_path):
        node = self._node(tmp_path)
        client = RpcClient(node.messaging.my_address, "limited", "pw",
                           timeout=5.0)
        try:
            import threading
            pumper = threading.Thread(
                target=lambda: [node.run_once(timeout=0.01)
                                for _ in range(300)], daemon=True)
            pumper.start()
            with pytest.raises(RpcError, match="may not start"):
                client.start_flow("PingFlow", "x")
        finally:
            client.close()
            node.stop()

    def test_arbitrary_attributes_not_dispatchable(self, tmp_path):
        node = self._node(tmp_path)
        client = RpcClient(node.messaging.my_address, "demo", "s3cret",
                           timeout=5.0)
        try:
            import threading
            pumper = threading.Thread(
                target=lambda: [node.run_once(timeout=0.01)
                                for _ in range(300)], daemon=True)
            pumper.start()
            with pytest.raises(RpcError, match="no such method"):
                client.call("_handle")
            with pytest.raises(RpcError, match="no such method"):
                client.call("__init__")
        finally:
            client.close()
            node.stop()


def test_submit_and_take_reply_pipeline_requests(tmp_path):
    """submit() sends without waiting; take_reply() collects each reply
    once the transport has pumped it, in any order; an error reply
    raises. notary_load.run_open_loop starts flows this way on its
    schedule and times each to the change feed's end event."""
    import threading

    from corda_tpu_torch.testing import notary_load as nl

    node = TestRpc()._node(tmp_path)
    stop = threading.Event()
    pumper = threading.Thread(
        target=lambda: [node.run_once(timeout=0.01)
                        for _ in iter(stop.is_set, True)], daemon=True)
    pumper.start()
    client = RpcClient(node.messaging.my_address, "demo", "s3cret",
                       timeout=10.0)
    try:
        ids = [client.submit("start_flow_dynamic", "PingFlow", (str(i),))
               for i in range(3)]
        bad = client.submit("no_such_method")
        got = {}
        deadline = time.monotonic() + 10
        while len(got) < 3 and time.monotonic() < deadline:
            client.poll_push()
            for rid in ids:
                done, info = client.take_reply(rid)
                if done:
                    got[rid] = info
        assert len(got) == 3
        assert [client.wait_for_flow(got[rid]) for rid in ids] == [
            "pong:0", "pong:1", "pong:2"]
        error = None
        while error is None and time.monotonic() < deadline:
            client.poll_push()
            try:
                client.take_reply(bad)
            except RpcError as e:
                error = e
        assert "no such method" in str(error)
        res = nl.run_open_loop(client, 200.0, 5, 7, flow="PingFlow",
                               timeout_s=10.0)
        assert res["results"] == [f"pong:{i}" for i in range(7, 12)]
        assert all(x is not None and x >= 0 for x in res["latency_s"])
        assert res["tx_per_sec"] > 0
    finally:
        client.close()
        stop.set()
        pumper.join(timeout=2)
        node.stop()


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


FIRED: list[str] = []


@register_flow
class ScheduledPing(FlowLogic):
    def __init__(self, tag: str):
        self.tag = tag

    def call(self):
        FIRED.append(self.tag)
        return self.tag


class _AcceptAll(Contract):
    def verify(self, tx):
        pass

    @property
    def legal_contract_reference(self):
        return SecureHash.sha256(b"accept-all")


@dataclass(frozen=True)
class TimerState(SchedulableState):
    """A state that asks for ScheduledPing at `fire_at`."""

    owner_tag: str = ""
    fire_at: int = 0
    owner = None  # set per-test: vault relevancy needs a participant

    @property
    def contract(self):
        return _AcceptAll()

    @property
    def participants(self):
        return [TimerState.owner] if TimerState.owner is not None else []

    def next_scheduled_activity(self, this_state_ref, flow_factory):
        return ScheduledActivity("ScheduledPing", (self.owner_tag,),
                                 self.fire_at)


@dataclass(frozen=True)
class _Noop(TypeOnlyCommandData):
    pass


@pytest.fixture(autouse=True, scope="module")
def _test_classes_registered():
    """TimerState and _Noop are in the port's codec whitelist only while
    this module's tests run."""
    from corda_tpu_torch.serialization import codec

    for cls in (TimerState, _Noop):
        register(cls)
    yield
    for cls in (TimerState, _Noop):
        codec._BY_NAME.pop(codec._BY_TYPE.pop(cls))


def test_scheduler_fires_due_state(tmp_path):
    from corda_tpu_torch.contracts.structures import Command
    from corda_tpu_torch.transactions.builder import TransactionBuilder

    node = Node(NodeConfig(name="Sched", base_dir=tmp_path / "Sched",
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu")).start()
    try:
        FIRED.clear()

        fire_at = now_micros() + 100_000  # 0.1s from now
        TimerState.owner = node.identity.owning_key  # vault relevancy
        tx = TransactionBuilder(notary=node.identity)
        tx.add_output_state(TimerState("tick-1", fire_at))
        tx.add_command(Command(_Noop(), (node.identity.owning_key,)))
        tx.sign_with(node.key)
        stx = tx.to_signed_transaction()
        node.services.record_transactions([stx])

        assert node.scheduler.next_scheduled is not None
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not FIRED:
            node.run_once(timeout=0.01)
        assert FIRED == ["tick-1"]
        assert node.scheduler.next_scheduled is None  # consumed
    finally:
        node.stop()


def test_vault_rebuilds_after_restart(tmp_path):
    node = Node(NodeConfig(name="V", base_dir=tmp_path / "V",
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu")).start()
    stx = issue_and_move(node, node.identity, magic=5)
    node.services.record_transactions([stx])
    before = {s.ref for s in node.services.vault_service.current_vault.states}
    assert before
    node.stop()
    del node

    reborn = Node(NodeConfig(name="V", base_dir=tmp_path / "V",
                             network_map=tmp_path / "netmap.json",
                             verifier="cpu")).start()
    try:
        after = {s.ref
                 for s in reborn.services.vault_service.current_vault.states}
        assert after == before
    finally:
        reborn.stop()


# ---------------------------------------------------------------------------
# ProgressTracker
# ---------------------------------------------------------------------------


def test_progress_tracker_stream_and_children():
    fetching = Step("Fetching")
    verifying = Step("Verifying")
    signing = Step("Signing")
    tracker = ProgressTracker(fetching, verifying, signing)
    seen: list[tuple[str, ...]] = []
    tracker.subscribe(lambda c: seen.append(c.path))

    tracker.next_step()
    assert tracker.current_step == fetching
    child = ProgressTracker(Step("Downloading"), Step("Checking"))
    tracker.set_child_tracker(verifying, child)
    tracker.next_step()
    child.next_step()  # bubbles through the parent path
    tracker.current_step = signing
    from corda_tpu_torch.utils.progress import DONE

    tracker.current_step = DONE
    assert seen == [
        ("Fetching",),
        ("Verifying",),
        ("Verifying", "Downloading"),
        ("Signing",),
        ("Done",),
    ]


# ---------------------------------------------------------------------------
# Network map directory service (wire tier)
# ---------------------------------------------------------------------------


def test_netmap_service_register_fetch_subscribe(tmp_path):
    """A map node serves signed registrations; late joiners learn earlier
    nodes over the wire (not from the bootstrap file), and registrations not
    signed by the registering identity are rejected."""
    def node(name, **kw):
        return Node(NodeConfig(
            name=name, base_dir=tmp_path / name,
            network_map=tmp_path / "netmap.json", verifier="cpu",
            **kw)).start()

    map_node = node("MapNode", map_service=True)
    a = node("NodeA", map_node="MapNode")
    nodes = [map_node, a]
    try:
        pump_until(nodes, lambda: a.netmap_client.registered
                   and a.netmap_client.fetched)
        assert map_node.netmap_service.node_count == 1

        # NodeB never touches the bootstrap file after boot; it learns NodeA
        # through fetch, and NodeA learns NodeB through the pushed update.
        b = node("NodeB", map_node="MapNode")
        nodes.append(b)
        pump_until(nodes, lambda: b.netmap_client.registered)
        pump_until(nodes, lambda: any(
            n.legal_identity.name == "NodeA"
            for n in b.network_map_cache.party_nodes))
        pump_until(nodes, lambda: any(
            n.legal_identity.name == "NodeB"
            for n in a.network_map_cache.party_nodes))

        # Forged registration: NodeB signs a registration claiming NodeA's
        # identity but pointing at B's OWN address (session hijack attempt).
        # Rejected: the map's entry and serial for NodeA must not change.
        from dataclasses import replace as _replace

        from corda_tpu_torch.crypto.signed_data import SignedData
        from corda_tpu_torch.node.messaging.api import TopicSession
        from corda_tpu_torch.node.services.netmap_service import (
            ADD,
            NodeRegistration,
            RegistrationRequest,
        )
        from corda_tpu_torch.serialization.codec import serialize

        serial_before = map_node.netmap_service.serial_of("NodeA")
        forged_info = _replace(a.info, address=b.messaging.my_address)
        reg = NodeRegistration(forged_info, 999, ADD)
        blob = serialize(reg)
        signed = SignedData(blob, b.key.sign(blob.bytes))  # B signs as A
        b.messaging.send(
            TopicSession("platform.netmap", 0),
            serialize(RegistrationRequest(
                signed, b.messaging.my_address)).bytes,
            map_node.messaging.my_address)
        for _ in range(30):
            for n in nodes:
                n.run_once(timeout=0.005)
        stored = map_node.netmap_service.get_node("NodeA")
        assert stored is not None
        assert stored.address == a.messaging.my_address  # NOT hijacked
        assert map_node.netmap_service.serial_of("NodeA") == serial_before
        # A legitimate re-register (next serial) still succeeds.
        a.netmap_client.register(a.info)
        pump_until(nodes, lambda:
                   map_node.netmap_service.serial_of("NodeA")
                   == serial_before + 1)
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("map_host", ["jax", "port"])
def test_wire_map_across_the_packages(tmp_path, map_host):
    """One package's map node, the other's members: registrations, fetches
    and pushed updates interoperate over TCP (the netmap messages carry
    the same wire names in both packages), and a member's cache learns the
    other member through the map."""
    import importlib

    def node(pkg, name, **kw):
        config = importlib.import_module(f"{pkg}.node.config")
        node_mod = importlib.import_module(f"{pkg}.node.node")
        return node_mod.Node(config.NodeConfig(
            name=name, base_dir=tmp_path / name,
            network_map=tmp_path / "netmap.json", verifier="cpu",
            **kw)).start()

    host_pkg, member_pkg = (("corda_tpu", "corda_tpu_torch")
                            if map_host == "jax"
                            else ("corda_tpu_torch", "corda_tpu"))
    host = node(host_pkg, "MapNode", map_service=True)
    nodes = [host]
    try:
        for name in ("MemberA", "MemberB"):
            nodes.append(node(member_pkg, name, map_node="MapNode"))
        a, b = nodes[1:]
        pump_until(nodes, lambda: all(m.netmap_client.registered
                                      and m.netmap_client.fetched
                                      for m in (a, b)))
        assert host.netmap_service.node_count == 2
        for member in (a, b):
            stored = host.netmap_service.get_node(member.config.name)
            assert stored.legal_identity.owning_key.to_base58_string() == \
                member.identity.owning_key.to_base58_string()
        pump_until(nodes, lambda: any(
            n.legal_identity.name == "MemberB"
            for n in a.network_map_cache.party_nodes))
    finally:
        for n in nodes:
            n.stop()


def test_notarisation_emits_progress_events(tmp_path):
    """The library flows declare real progress steps: a notarisation's
    change feed shows the NotaryClientFlow tracker advancing (the stream the
    reference renders over RPC/console)."""
    from corda_tpu_torch.flows.notary import NotaryClientFlow
    notary = Node(NodeConfig(name="Notary", base_dir=tmp_path / "Notary",
                             notary="simple", network_map=tmp_path / "m.json",
                             verifier="cpu")).start()
    alice = Node(NodeConfig(name="Alice", base_dir=tmp_path / "Alice",
                            network_map=tmp_path / "m.json",
                            verifier="cpu")).start()
    try:
        for n in (notary, alice):
            n.refresh_netmap()
        stx = issue_and_move(alice, notary.identity, magic=33)
        h = alice.start_flow(NotaryClientFlow(stx))
        pump_until([notary, alice], lambda: h.result.done)
        h.result.result()
        _cursor, events = alice.smm.changes.since(0)
        paths = [e[2] for e in events if e[0] == "progress"]
        labels = [p[-1] for p in paths]
        assert "Verifying our signatures" in labels
        assert "Requesting signature by notary service" in labels
        assert "Validating response from notary service" in labels
    finally:
        notary.stop()
        alice.stop()


# ---------------------------------------------------------------------------
# Flow -> transaction provenance mapping (tests/test_tx_mapping.py)
# ---------------------------------------------------------------------------

import threading  # noqa: E402

from corda_tpu_torch.crypto.provider import CpuVerifier  # noqa: E402
from corda_tpu_torch.flows import FinalityFlow  # noqa: E402
from corda_tpu_torch.testing.dummies import DummyContract  # noqa: E402
from corda_tpu_torch.testing.mock_network import MockNetwork  # noqa: E402


@pytest.fixture()
def net():
    network = MockNetwork(verifier=CpuVerifier())
    yield network
    network.stop_nodes()


def _issue_and_finalise(net, node, notary_party, magic=3, recipients=()):
    builder = DummyContract.generate_initial(
        node.identity.ref(b"\x00"), magic, notary_party)
    builder.sign_with(node.key)
    stx = builder.to_signed_transaction()
    handle = node.start_flow(FinalityFlow(stx, tuple(recipients)))
    net.run_network()
    handle.result.result()
    return stx, handle


def test_flow_recording_lands_in_mapping_storage(net):
    notary = net.create_notary_node("Notary")
    alice = net.create_node("Alice")
    stx, handle = _issue_and_finalise(net, alice, notary.identity)

    mapping = alice.services.storage_service \
        .state_machine_recorded_transaction_mapping
    got = {(m.run_id, m.tx_id) for m in mapping.mappings()}
    assert (handle.run_id, stx.id) in got


def test_mapping_dedupes_and_notifies_once():
    from corda_tpu_torch.node.services.inmemory import (
        InMemoryTransactionMappingStorage,
    )

    storage = InMemoryTransactionMappingStorage()
    seen = []
    storage.subscribe(seen.append)
    tx_id = SecureHash.sha256(b"tx")
    storage.add_mapping(b"run-1", tx_id)
    storage.add_mapping(b"run-1", tx_id)  # checkpoint replay re-record
    storage.add_mapping(b"run-2", tx_id)  # a second flow touching the tx
    assert len(storage.mappings()) == 2
    assert len(seen) == 2
    assert seen[0].run_id == b"run-1" and seen[0].tx_id == tx_id


def test_db_mapping_survives_restart(tmp_path):
    from corda_tpu_torch.node.services.persistence import (
        DBTransactionMappingStorage,
        NodeDatabase,
    )

    path = tmp_path / "node.db"
    db = NodeDatabase(path)
    storage = DBTransactionMappingStorage(db)
    tx_id = SecureHash.sha256(b"durable-tx")
    storage.add_mapping(b"run-9", tx_id)
    storage.add_mapping(b"run-9", tx_id)  # idempotent
    db.close()

    db2 = NodeDatabase(path)  # the rebirth
    storage2 = DBTransactionMappingStorage(db2)
    got = storage2.mappings()
    assert [(m.run_id, m.tx_id) for m in got] == [(b"run-9", tx_id)]
    db2.close()


def test_mapping_over_rpc_poll_and_push(tmp_path):
    """A real node: the RPC snapshot carries the mapping and the push
    stream announces it live as a ("tx_recorded", run_id, tx_id) event."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.rpc import RpcClient

    node = Node(NodeConfig(
        name="Prov", base_dir=tmp_path / "Prov",
        network_map=tmp_path / "netmap.json", notary="simple",
        verifier="cpu", rpc_users=({"username": "ops", "password": "pw",
                    "permissions": ["ALL"]},))).start()
    stop = threading.Event()
    pumper = threading.Thread(
        target=lambda: [node.run_once(timeout=0.01)
                        for _ in iter(stop.is_set, True)], daemon=True)
    pumper.start()
    client = RpcClient(node.messaging.my_address, "ops", "pw")
    try:
        import corda_tpu_torch.tools.demo_cordapp  # noqa: F401  (registers the flow)

        got: list = []
        client.subscribe_changes(lambda events, cursor: got.extend(events))
        handle = client.call(
            "start_flow_dynamic", "IssueAndNotariseFlow", (41,))
        import time

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            done, _ = client.call("flow_result", handle.run_id)
            if done:
                break
            client.poll_push()
            time.sleep(0.05)
        else:
            pytest.fail("demo flow did not finish")

        snapshot = client.call("state_machine_recorded_transaction_mapping")
        by_run = [m for m in snapshot if m.run_id == handle.run_id]
        # DemoIssueAndMove records the issue and the notarised move.
        assert len(by_run) == 2, snapshot
        for m in by_run:
            assert client.call("verified_transaction", m.tx_id) is not None

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            recorded = [e for e in got if e[0] == "tx_recorded"]
            if len(recorded) >= 2:
                break
            client.poll_push()
            time.sleep(0.05)
        recorded = [e for e in got if e[0] == "tx_recorded"]
        assert {e[1] for e in recorded} == {handle.run_id}
        assert {bytes(e[2]) for e in recorded} == {
            m.tx_id.bytes for m in by_run}
    finally:
        client.close()
        stop.set()
        pumper.join(timeout=2)
        node.stop()


def test_responder_side_records_provenance_too(net):
    """A two-party broadcast: the RECIPIENT's responder flow (data-vending
    NotifyTransactionHandler) records the tx with ITS OWN run id — both
    ledgers can attribute the tx to the protocol run that delivered it
    (reference: every recordTransactions call site feeds the mapping,
    ServiceHubInternal)."""
    notary = net.create_notary_node("Notary")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    stx, handle = _issue_and_finalise(net, alice, notary.identity, magic=9,
                                      recipients=(bob.identity,))

    for node, run_id in ((alice, handle.run_id), (bob, None)):
        mapping = node.services.storage_service \
            .state_machine_recorded_transaction_mapping
        entries = [m for m in mapping.mappings() if m.tx_id == stx.id]
        assert entries, f"{node.identity.name} has no mapping for the tx"
        if run_id is not None:
            assert entries[0].run_id == run_id
        else:
            # Bob's mapping belongs to his responder flow — a run id of
            # HIS state machine, not Alice's.
            assert entries[0].run_id != handle.run_id
