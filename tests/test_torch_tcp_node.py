"""The port's node over real localhost TCP sockets + sqlite, on the CPU.

The port's mirror of ``tests/test_tcp_node.py``: each port ``Node`` owns its
own sqlite file and TCP listener, runs ``verifier = "cpu"`` (the port's
default, ``"torch"``, needs the card) and the test round-robins
``run_once()`` as the scheduler. Every wait is bounded by its own timeout.
"""

import json
import time

import pytest

from corda_tpu_torch.flows.notary import NotaryClientFlow, NotaryException
from corda_tpu_torch.node.config import BatchConfig, NodeConfig
from corda_tpu_torch.node.node import Node
from corda_tpu_torch.testing.dummies import DummyContract


def make_node(tmp_path, name, notary="none", netmap="netmap.json", **kw):
    config = NodeConfig(
        name=name,
        base_dir=tmp_path / name,
        port=0,
        notary=notary,
        network_map=tmp_path / netmap,
        verifier=kw.pop("verifier", "cpu"),
        batch=BatchConfig(max_sigs=kw.pop("max_sigs", 4096),
                          max_wait_ms=kw.pop("max_wait_ms", 2.0)),
        **kw,
    )
    return Node(config).start()


def pump_until(nodes, predicate, timeout=15.0):
    """Round-robin run_once across nodes until predicate() or timeout.

    Netmap refresh is throttled (as in production run_forever): re-reading
    the file every iteration made each pump cycle slow enough to quantize
    raft election timeouts to cycle boundaries — repeated split votes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for node in nodes:
            node.run_once(timeout=0.01)
            node.refresh_netmap_maybe(every=0.2)
        if predicate():
            return
    raise AssertionError("timed out waiting for network to settle")


def issue_and_move(alice, notary_identity, magic=1):
    builder = DummyContract.generate_initial(
        alice.identity.ref(b"\x01"), magic, notary_identity)
    builder.sign_with(alice.key)
    issue_stx = builder.to_signed_transaction()
    alice.services.record_transactions([issue_stx])
    move = DummyContract.move(issue_stx.tx.out_ref(0),
                              alice.identity.owning_key)
    move.sign_with(alice.key)
    return move.to_signed_transaction(check_sufficient_signatures=False)


class TestTcpNotarisation:
    def test_two_nodes_plus_notary_smoke(self, tmp_path):
        notary = make_node(tmp_path, "Notary", notary="simple")
        alice = make_node(tmp_path, "Alice")
        bob = make_node(tmp_path, "Bob")
        nodes = [notary, alice, bob]
        try:
            for n in nodes:
                n.refresh_netmap()
            stx = issue_and_move(alice, notary.identity)
            handle = alice.start_flow(NotaryClientFlow(stx))
            pump_until(nodes, lambda: handle.result.done)
            sig = handle.result.result()
            assert sig.by in notary.identity.owning_key.keys
            sig.verify(stx.id.bytes)
            assert notary.uniqueness_provider.committed_count == 1
        finally:
            for n in nodes:
                n.stop()

    def test_double_spend_rejected_across_tcp(self, tmp_path):
        notary = make_node(tmp_path, "Notary", notary="simple")
        alice = make_node(tmp_path, "Alice")
        nodes = [notary, alice]
        try:
            for n in nodes:
                n.refresh_netmap()
            builder = DummyContract.generate_initial(
                alice.identity.ref(b"\x01"), 5, notary.identity)
            builder.sign_with(alice.key)
            issue_stx = builder.to_signed_transaction()
            alice.services.record_transactions([issue_stx])
            prior = issue_stx.tx.out_ref(0)

            m1 = DummyContract.move(prior, alice.identity.owning_key)
            m1.sign_with(alice.key)
            stx1 = m1.to_signed_transaction(check_sufficient_signatures=False)
            m2 = DummyContract.move(prior, notary.identity.owning_key)
            m2.sign_with(alice.key)
            stx2 = m2.to_signed_transaction(check_sufficient_signatures=False)
            assert stx1.id != stx2.id

            h1 = alice.start_flow(NotaryClientFlow(stx1))
            pump_until(nodes, lambda: h1.result.done)
            h1.result.result()

            h2 = alice.start_flow(NotaryClientFlow(stx2))
            pump_until(nodes, lambda: h2.result.done)
            with pytest.raises(NotaryException) as err:
                h2.result.result()
            assert "used in another transaction" in str(err.value)
        finally:
            for n in nodes:
                n.stop()

def test_notary_restart_new_process_semantics(tmp_path):
    """Kill the notary node (drop every object), rebuild purely from its
    base_dir, and verify (a) the commit log survived sqlite-durably and (b) a
    notarisation started while it was down completes after rebirth (durable
    outbox + bridge retry — store-and-forward across a peer restart)."""
    notary = make_node(tmp_path, "Notary", notary="simple")
    alice = make_node(tmp_path, "Alice")
    survivors = [alice]
    try:
        for n in (notary, alice):
            n.refresh_netmap()
        stx = issue_and_move(alice, notary.identity, magic=9)
        h = alice.start_flow(NotaryClientFlow(stx))
        pump_until([notary, alice], lambda: h.result.done)
        h.result.result()
        assert notary.uniqueness_provider.committed_count == 1
        notary_config = notary.config
        notary_identity = notary.identity

        # -- crash: drop every in-memory object -----------------------------
        notary.stop()
        del notary
        time.sleep(0.05)

        # While down, Alice fires a second notarisation; the send parks in
        # her durable outbox and the bridge retries.
        stx2 = issue_and_move(alice, notary_identity, magic=10)
        h2 = alice.start_flow(NotaryClientFlow(stx2))
        for _ in range(5):
            alice.run_once(timeout=0.01)
        assert not h2.result.done  # notary is down; flow is parked

        # -- rebirth purely from the base_dir (fresh port; netmap updates) --
        reborn = Node(NodeConfig(
            name=notary_config.name,
            base_dir=notary_config.base_dir,
            port=0,
            notary="simple",
            network_map=notary_config.network_map,
            verifier="cpu",
        )).start()
        survivors.append(reborn)
        assert reborn.identity == notary_identity  # key survived on disk
        assert reborn.uniqueness_provider.committed_count == 1  # log survived

        pump_until([alice, reborn], lambda: h2.result.done)
        sig2 = h2.result.result()
        sig2.verify(stx2.id.bytes)
        assert reborn.uniqueness_provider.committed_count == 2
    finally:
        for n in survivors:
            n.stop()


class TestKillAtStepSqlite:
    """Kill-at-every-step re-run against the DURABLE stack: sqlite checkpoint
    storage + TCP transport, with rebirth strictly from the base_dir (no
    object hand-over — the new-process semantics VERDICT r1 asked for)."""

    @pytest.mark.parametrize("crash_after", [1, 2, 3])
    @pytest.mark.parametrize("victim", ["client", "notary"])
    def test_crash_at_step(self, tmp_path, crash_after, victim):
        notary = make_node(tmp_path, "Notary", notary="simple")
        alice = make_node(tmp_path, "Alice")
        nodes = {"notary": notary, "client": alice}
        try:
            for n in nodes.values():
                n.refresh_netmap()
            stx = issue_and_move(alice, notary.identity, magic=crash_after)
            alice.start_flow(NotaryClientFlow(stx))

            dispatched = 0
            crashed = False
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                for node in list(nodes.values()):
                    dispatched += node.run_once(timeout=0.01)
                if not crashed and dispatched >= crash_after:
                    crashed = True
                    dead = nodes[victim]
                    config = dead.config
                    dead.stop()
                    del dead, nodes[victim]
                    # Rebirth purely from disk.
                    nodes[victim] = Node(NodeConfig(
                        name=config.name,
                        base_dir=config.base_dir,
                        port=0,
                        notary=config.notary,
                        network_map=config.network_map,
                        verifier="cpu",
                    )).start()
                if nodes["notary"].uniqueness_provider.committed_count == 1 \
                        and not any(n.smm.flows for n in nodes.values()):
                    break
            assert crashed, "network settled before the crash point"
            assert nodes["notary"].uniqueness_provider.committed_count == 1, (
                f"crash_after={crash_after} victim={victim}: "
                "protocol did not complete")
        finally:
            for n in nodes.values():
                n.stop()


class TestTlsTransport:
    def test_notarisation_over_mutual_tls(self, tmp_path):
        """TLS-enabled nodes (certs chained to the shared dev CA) complete a
        notarisation; a plaintext client cannot talk to a TLS node."""
        notary = make_node(tmp_path, "Notary", notary="simple", tls=True)
        alice = make_node(tmp_path, "Alice", tls=True)
        nodes = [notary, alice]
        try:
            for n in nodes:
                n.refresh_netmap()
            assert (tmp_path / "dev-ca.pem").exists()
            assert (tmp_path / "Alice" / "certificates"
                    / "tls-cert.pem").exists()
            stx = issue_and_move(alice, notary.identity, magic=21)
            h = alice.start_flow(NotaryClientFlow(stx))
            pump_until(nodes, lambda: h.result.done)
            h.result.result().verify(stx.id.bytes)

            # A plaintext endpoint is refused by the TLS listener: its sends
            # never ack (handshake bytes are not a valid frame).
            from corda_tpu_torch.node.messaging.api import TopicSession
            from corda_tpu_torch.node.messaging.tcp import TcpMessaging

            plain = TcpMessaging("127.0.0.1", 0).start()
            plain.send(TopicSession("platform.session", 0), b"junk",
                       notary.messaging.my_address)
            before = notary.smm.metrics["started"]
            deadline = time.monotonic() + 1.5
            while time.monotonic() < deadline:
                for n in nodes:
                    n.run_once(timeout=0.01)
            assert notary.smm.metrics["started"] == before
            plain.stop()
        finally:
            for n in nodes:
                n.stop()


class TestHostileSocket:
    @pytest.mark.filterwarnings(
        "error::pytest.PytestUnhandledThreadExceptionWarning")
    def test_raw_garbage_on_the_wire_does_not_kill_the_node(self, tmp_path):
        """A port-scanner / hostile client writing raw bytes (bad framing,
        oversized length prefixes, empty connects) must not take the node
        down or wedge its accept loop — legitimate traffic keeps flowing."""
        import socket
        import struct

        notary = make_node(tmp_path, "Notary", notary="simple")
        alice = make_node(tmp_path, "Alice")
        nodes = [notary, alice]
        try:
            for n in nodes:
                n.refresh_netmap()
            addr = (notary.messaging.my_address.host,
                    notary.messaging.my_address.port)
            payloads = [
                b"",                                   # connect + close
                b"\x00",                               # short read
                b"GET / HTTP/1.1\r\n\r\n",             # wrong protocol
                struct.pack(">I", 0xFFFFFFF0) + b"x",  # absurd length prefix
                b"\xff" * 4096,                        # framed-looking noise
            ]
            # a WELL-FRAMED frame whose payload decodes to a non-sequence
            from corda_tpu_torch.serialization.codec import serialize

            scalar = bytes(serialize(7).bytes)
            payloads.append(struct.pack(">I", len(scalar)) + scalar)
            # a well-formed 'msg' frame with WRONG-TYPED fields (dict where
            # the dedupe id must be bytes) must die at the reader, not on
            # the node's pump thread
            evil = bytes(serialize(
                ("msg", "platform.session", 0, {"a": 1}, "h", 1, b"")).bytes)
            payloads.append(struct.pack(">I", len(evil)) + evil)
            for payload in payloads:
                s = socket.create_connection(addr, timeout=2)
                try:
                    if payload:
                        s.sendall(payload)
                finally:
                    s.close()
                for n in nodes:
                    n.run_once(timeout=0.01)
            # the node still serves legitimate protocol traffic
            stx = issue_and_move(alice, notary.identity, magic=77)
            h = alice.start_flow(NotaryClientFlow(stx))
            pump_until(nodes, lambda: h.result.done)
            h.result.result().verify(stx.id.bytes)
        finally:
            for n in nodes:
                n.stop()


    @pytest.mark.filterwarnings(
        "error::pytest.PytestUnhandledThreadExceptionWarning")
    def test_garbage_acking_peer_does_not_kill_the_bridge(self, tmp_path):
        """An outbound bridge whose peer replies with garbage instead of
        ACK frames must reconnect-and-retry, not lose its thread — and the
        node keeps serving other peers."""
        import socket
        import threading

        from corda_tpu_torch.node.messaging.api import TopicSession
        from corda_tpu_torch.node.messaging.tcp import TcpAddress

        notary = make_node(tmp_path, "Notary", notary="simple")
        alice = make_node(tmp_path, "Alice")
        nodes = [notary, alice]

        fake = socket.socket()
        fake.bind(("127.0.0.1", 0))
        fake.listen(4)
        fake_addr = TcpAddress("127.0.0.1", fake.getsockname()[1])
        hits = []

        def fake_peer():
            fake.settimeout(5)
            try:
                while len(hits) < 2:  # original connect + >=1 reconnect
                    conn, _ = fake.accept()
                    hits.append(1)
                    conn.settimeout(2)
                    try:
                        conn.recv(4096)  # the bridged frame
                        conn.sendall(b"\xde\xad\xbe\xef" * 4)  # garbage
                    except OSError:
                        pass
                    conn.close()
            except OSError:
                pass

        t = threading.Thread(target=fake_peer, daemon=True)
        t.start()
        try:
            for n in nodes:
                n.refresh_netmap()
            alice.messaging.send(TopicSession("platform.session", 0),
                                 b"payload", fake_addr)
            deadline = __import__("time").monotonic() + 6
            while __import__("time").monotonic() < deadline and len(hits) < 2:
                for n in nodes:
                    n.run_once(timeout=0.01)
            assert len(hits) >= 2, "bridge never reconnected after garbage"
            # the node still serves legitimate peers
            stx = issue_and_move(alice, notary.identity, magic=88)
            h = alice.start_flow(NotaryClientFlow(stx))
            pump_until(nodes, lambda: h.result.done)
            h.result.result().verify(stx.id.bytes)
        finally:
            fake.close()
            t.join(timeout=2)
            for n in nodes:
                n.stop()


class TestRoundTransactions:
    """The run-loop round batch (NodeDatabase.batch + TcpMessaging round
    deferral): a round commits as ONE unit, a failed round rolls back as one
    unit, and the dedupe/ACK machinery follows the transaction's fate."""

    def test_round_commits_as_unit(self, tmp_path):
        from corda_tpu_torch.node.services.persistence import NodeDatabase

        db = NodeDatabase(tmp_path / "n.db")
        with db.batch():
            db.set_setting("a", "1")
            db.set_setting("b", "2")
            # Not yet visible to a second connection (uncommitted).
            assert db.aux_conn.execute(
                "SELECT COUNT(*) FROM settings WHERE key IN ('a','b')"
            ).fetchone()[0] == 0
        assert db.get_setting("a") == "1"
        assert db.get_setting("b") == "2"
        db.close()

    def test_failed_round_rolls_back(self, tmp_path):
        from corda_tpu_torch.node.services.persistence import NodeDatabase

        db = NodeDatabase(tmp_path / "n.db")
        with pytest.raises(RuntimeError):
            with db.batch():
                db.set_setting("a", "1")
                raise RuntimeError("mid-round failure")
        assert db.get_setting("a") is None
        # The connection stays usable for the next round.
        with db.batch():
            db.set_setting("a", "2")
        assert db.get_setting("a") == "2"
        db.close()

    def test_foreign_thread_commit_is_immediate(self, tmp_path):
        # A webserver-style thread must keep commit-before-return while the
        # node thread holds a round open (db.lock serializes them).
        import threading

        from corda_tpu_torch.node.services.persistence import (
            DBAttachmentStorage,
            NodeDatabase,
        )

        db = NodeDatabase(tmp_path / "n.db")
        storage = DBAttachmentStorage(db)
        in_round = threading.Event()
        release = threading.Event()
        result = {}

        def node_round():
            with db.batch():
                db.set_setting("round", "open")
                in_round.set()
                release.wait(timeout=5.0)

        def http_upload():
            in_round.wait(timeout=5.0)
            att_id = storage.import_attachment(b"payload")
            # By the time import_attachment returns, the row must be durable
            # (visible to an independent connection).
            result["count"] = db.aux_conn.execute(
                "SELECT COUNT(*) FROM attachments WHERE att_id = ?",
                (att_id.bytes,)).fetchone()[0]

        t1 = threading.Thread(target=node_round)
        t2 = threading.Thread(target=http_upload)
        t1.start()
        t2.start()
        # The upload blocks on db.lock until the round ends.
        release.set()
        t1.join(timeout=10.0)
        t2.join(timeout=10.0)
        assert result.get("count") == 1
        db.close()

    def test_dedupe_mirror_follows_round_fate(self, tmp_path):
        from corda_tpu_torch.node.messaging.tcp import _Dedupe
        from corda_tpu_torch.node.services.persistence import NodeDatabase

        db = NodeDatabase(tmp_path / "n.db")
        dedupe = _Dedupe(db)
        # Aborted round: the mirror entry must unwind with the rollback so a
        # redelivery is processed, not swallowed.
        try:
            with db.batch():
                dedupe.record(b"lost-message")
                raise RuntimeError("round failed")
        except RuntimeError:
            pass
        dedupe.round_aborted()
        assert not dedupe.seen(b"lost-message")
        # Committed round: the entry stays.
        with db.batch():
            dedupe.record(b"kept-message")
        dedupe.round_committed()
        assert dedupe.seen(b"kept-message")
        db.close()

    def test_flush_checkpoints_fails_bad_flow_in_place(self):
        # Round-3 advisor: propagating a serialization error out of
        # flush_checkpoints rolled back the WHOLE round and exited the node;
        # restart replayed the flow to the same unserializable state — a
        # permanent crash loop. The bad flow must instead be failed like a
        # handler exception would fail it, keeping the round committable.
        from corda_tpu_torch.flows.api import FlowException
        from corda_tpu_torch.node.statemachine import (
            InMemoryCheckpointStorage,
            StateMachineManager,
        )

        failed = []

        class _Good:
            state = "runnable"
            run_id = b"good"

        class _Bad:
            state = "runnable"
            run_id = b"bad"

            def _fail(self, exc):
                self.state = "done"
                failed.append(exc)

        storage = InMemoryCheckpointStorage()
        smm = StateMachineManager.__new__(StateMachineManager)
        smm.defer_checkpoints = True
        smm.checkpoint_storage = storage
        smm.metrics = {"checkpointing_rate": 0}

        def ser(fsm):
            if fsm.run_id == b"bad":
                raise FlowException("unserializable flow state")
            return b"blob-" + fsm.run_id

        smm._serialize_checkpoint = ser
        smm._dirty_checkpoints = {b"bad": _Bad(), b"good": _Good()}
        assert smm.flush_checkpoints() == 1
        assert [type(e) for e in failed] == [FlowException]
        # The good flow's checkpoint was written; the dirty set is drained.
        assert list(storage.checkpoints()) == [b"blob-good"]
        assert smm._dirty_checkpoints == {}

    def test_flush_checkpoints_storage_error_still_aborts_round(self):
        # A STORAGE write failure compromises every flow's durability, not
        # one flow's state: it must propagate and abort the round.
        from corda_tpu_torch.node.statemachine import StateMachineManager

        class _Flow:
            state = "runnable"
            run_id = b"f"

        class _BrokenStorage:
            def update_checkpoint(self, run_id, blob):
                raise OSError("disk full")

        smm = StateMachineManager.__new__(StateMachineManager)
        smm.defer_checkpoints = True
        smm.checkpoint_storage = _BrokenStorage()
        smm.metrics = {"checkpointing_rate": 0}
        smm._serialize_checkpoint = lambda fsm: b"blob"
        smm._dirty_checkpoints = {b"f": _Flow()}
        with pytest.raises(OSError):
            smm.flush_checkpoints()


# ---------------------------------------------------------------------------
# TLS, the federation and the sidecar's device stamp, and the boot warm
# ---------------------------------------------------------------------------

from corda_tpu_torch.node import node as node_module  # noqa: E402
from corda_tpu_torch.node.config import VaultConfig  # noqa: E402


def _check_tls(node, tmp_path):
    assert node.messaging._tls_server_ctx is not None
    assert (tmp_path / "N" / "certificates" / "tls-key.pem").exists()
    assert (tmp_path / "dev-ca.pem").exists()  # beside the network map


def _check_federation(node, tmp_path):
    from corda_tpu_torch.crypto.federation import FederatedVerifier

    v = node.smm.verifier
    assert isinstance(v, FederatedVerifier)
    assert [c.address for c in v.channels] == ["h1:1", "h2:2"]


def _check_sidecar_devices(node, tmp_path):
    from corda_tpu_torch.node.verify_client import SidecarVerifier

    v = node.smm.verifier
    assert type(v) is SidecarVerifier and v.address == "sidecar.sock"
    # The stamp only: the client never contacts the sidecar at boot.
    assert v.devices == 2 and v.sidecar_stats()["devices"] == 2


@pytest.mark.parametrize("kw, check", [
    ({"tls": True}, _check_tls),
    ({"batch": BatchConfig(federation_hosts="h1:1, h2:2")},
     _check_federation),
    ({"batch": BatchConfig(sidecar="sidecar.sock", sidecar_devices=2)},
     _check_sidecar_devices),
], ids=["tls", "federation_hosts", "sidecar_devices"])
def test_feature_config_boots(tmp_path, kw, check):
    """Every configuration the reference's Node accepts boots on the CPU:
    mutual TLS, the federation and the sidecar client's device stamp."""
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu", **kw)).start()
    try:
        check(node, tmp_path)
    finally:
        node.stop()


@pytest.mark.parametrize("env", ["CORDA_TPU_FEDERATION"])
def test_feature_env_selects_the_federation(tmp_path, monkeypatch, env):
    from corda_tpu_torch.crypto.federation import FederatedVerifier

    monkeypatch.setenv(env, "h0.sock,h1.sock,h2.sock")
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json",
                           verifier="cpu")).start()
    try:
        assert isinstance(node.smm.verifier, FederatedVerifier)
        assert len(node.smm.verifier.channels) == 3
    finally:
        node.stop()


# ---------------------------------------------------------------------------
# The indexed vault, the wire map and the web API: the reference's branches
# ---------------------------------------------------------------------------


def test_vault_indexed_config_boots_the_indexed_engine(tmp_path):
    """[vault] indexed = true: the sqlite IndexedVaultService, its tables in
    the node's own store, and the balance gauges read from its aggregate
    table."""
    from corda_tpu_torch.node.services.vault import IndexedVaultService

    node = make_node(tmp_path, "Ix", vault=VaultConfig(indexed=True))
    try:
        vault = node.services.vault_service
        assert isinstance(vault, IndexedVaultService)
        stx = issue_and_move(node, node.identity, magic=3)
        assert len(vault) == 1 and vault.watermark > 0
        with node.db.lock:
            tables = {r[0] for r in node.db.conn.execute(
                "SELECT name FROM sqlite_master WHERE type = 'table'")}
        assert {"vault_states", "vault_participants",
                "vault_balances"} <= tables
        assert stx.tx.inputs[0] == vault.current_vault.states[0].ref
    finally:
        node.stop()


@pytest.mark.parametrize("value, indexed", [("1", True), ("0", False)])
def test_vault_indexed_env_picks_the_engine(tmp_path, monkeypatch, value,
                                            indexed):
    """CORDA_TPU_VAULT_INDEXED arms the indexed engine as the reference
    reads it ("" and "0" leave the in-memory engine)."""
    from corda_tpu_torch.node.services.vault import IndexedVaultService

    monkeypatch.setenv("CORDA_TPU_VAULT_INDEXED", value)
    node = make_node(tmp_path, "Env")
    try:
        assert isinstance(node.services.vault_service,
                          IndexedVaultService) is indexed
    finally:
        node.stop()


def test_map_service_node_hosts_the_wire_map(tmp_path):
    """map_service = true: the node serves the wire network map; a node
    naming it in map_node registers there at start() and fetches the map."""
    from corda_tpu_torch.node.services.netmap_service import (
        NetworkMapClient,
        NetworkMapService,
    )

    host = make_node(tmp_path, "MapHost", map_service=True)
    nodes = [host]
    try:
        assert isinstance(host.netmap_service, NetworkMapService)
        assert host.netmap_client is None  # the map node does not register
        member = make_node(tmp_path, "Member", map_node="MapHost")
        nodes.append(member)
        assert isinstance(member.netmap_client, NetworkMapClient)
        assert member.netmap_service is None
        pump_until(nodes, lambda: member.netmap_client.registered
                   and member.netmap_client.fetched)
        assert host.netmap_service.get_node("Member").address == \
            member.messaging.my_address
    finally:
        for n in nodes:
            n.stop()


def test_map_node_missing_from_the_bootstrap_map_fails_start(tmp_path):
    with pytest.raises(RuntimeError, match="not in bootstrap map"):
        make_node(tmp_path, "Lost", map_node="Nowhere")


def test_web_port_binds_in_start_and_stops_with_the_node(tmp_path):
    """web_port: the web API binds in start(), never in the constructor,
    and closes in stop()."""
    import json
    import urllib.error
    import urllib.request

    config = NodeConfig(name="Web", base_dir=tmp_path / "Web", port=0,
                        network_map=tmp_path / "netmap.json",
                        verifier="cpu", web_port=0)
    node = Node(config)
    assert node.webserver is None
    node.start()
    port = node.webserver.port
    try:
        status = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/status", timeout=10))
        assert status == {"name": "Web",
                          "address": str(node.messaging.my_address),
                          "flows_in_flight": 0}
    finally:
        node.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api/status",
                               timeout=2)


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "memory"])
def test_rpc_vault_page_walks_the_vault(tmp_path, indexed):
    """RPC vault_page: keyset pages over the node's vault, each ref once,
    in (txhash, index) order, on either engine; vault_balances beside it."""
    import threading

    from corda_tpu_torch.node.rpc import RpcClient

    node = make_node(tmp_path, "RpcNode", vault=VaultConfig(indexed=indexed),
                     rpc_users=({"username": "ops", "password": "pw",
                                 "permissions": ["ALL"]},))
    for magic in range(7):
        builder = DummyContract.generate_initial(
            node.identity.ref(bytes([magic])), magic, node.identity)
        builder.sign_with(node.key)
        node.services.record_transactions([builder.to_signed_transaction()])
    stop = threading.Event()
    pumper = threading.Thread(
        target=lambda: [node.run_once(timeout=0.01)
                        for _ in iter(stop.is_set, True)], daemon=True)
    pumper.start()
    client = RpcClient(node.messaging.my_address, "ops", "pw", timeout=10.0)
    try:
        keys, cursor, pages = [], None, 0
        while True:
            states, cursor = client.call(
                "vault_page", None if cursor is None else cursor[0],
                0 if cursor is None else cursor[1], 3)
            keys.extend((s.ref.txhash.bytes, s.ref.index) for s in states)
            pages += 1
            if cursor is None:
                break
        assert pages == 3 and len(keys) == 7
        assert keys == sorted(set(keys))
        assert sorted(keys) == sorted(
            (s.ref.txhash.bytes, s.ref.index)
            for s in client.call("vault_snapshot"))
        assert client.call("vault_balances") == {}  # no cash here
        metrics = client.call("node_metrics")
        assert metrics["verifier"] == "cpu-openssl"
        assert metrics["verify_device_ready"] is None  # nothing to warm
    finally:
        client.close()
        stop.set()
        pumper.join(timeout=2)
        node.stop()


class _FakeCudaVerifier:
    """Looks like a TorchVerifier on the card: name "torch", a CUDA device,
    and a warm() that raises or records when it ran."""

    name = "torch"
    device_min_sigs = 4

    def __init__(self, fail: bool):
        import torch

        self.device = torch.device("cuda")
        self.fail = fail
        self.warmed = 0

    def warm(self):
        if self.fail:
            raise RuntimeError("nvcc: kernel build failed")
        self.warmed += 1

    def verify_batch(self, jobs):
        from corda_tpu_torch.crypto.provider import CpuVerifier

        return CpuVerifier().verify_batch(jobs)


def test_warm_that_raises_fails_start(tmp_path, monkeypatch):
    fake = _FakeCudaVerifier(fail=True)
    monkeypatch.setattr(node_module, "_make_verifier", lambda kind: fake)
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json"))
    try:
        with pytest.raises(RuntimeError, match="kernel build failed"):
            node.start()
        assert not node._started
    finally:
        node.stop()


def test_warm_that_raises_makes_main_exit_nonzero(tmp_path, monkeypatch):
    monkeypatch.setattr(node_module, "_make_verifier",
                        lambda kind: _FakeCudaVerifier(fail=True))
    path = tmp_path / "n.toml"
    path.write_text(f'name = "N"\nbase_dir = "{tmp_path / "N"}"\n'
                    f'network_map = "{tmp_path / "netmap.json"}"\n')
    assert node_module.main([str(path)]) == 1


def test_warm_runs_before_checkpoint_restore(tmp_path, monkeypatch):
    fake = _FakeCudaVerifier(fail=False)
    monkeypatch.setattr(node_module, "_make_verifier", lambda kind: fake)
    order = []
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json"))
    real_warm, real_start = fake.warm, node.smm.start
    monkeypatch.setattr(fake, "warm",
                        lambda: (order.append("warm"), real_warm())[1])
    monkeypatch.setattr(node.smm, "start",
                        lambda: (order.append("smm.start"), real_start())[1])
    try:
        node.start()
        assert order == ["warm", "smm.start"]
        assert fake.warmed == 1
    finally:
        node.stop()


def test_node_metrics_reports_the_launches_left_by_the_boot_warm(
        tmp_path, monkeypatch):
    # node_metrics exports this process's kernel launches and the counts
    # start()'s warm left, so a node alone in its process reports what its
    # traffic launched; a node that warmed nothing reports no boot counts.
    from corda_tpu_torch.node.rpc import NodeRpcOps
    from corda_tpu_torch.ops import kernels

    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    fake = _FakeCudaVerifier(fail=False)
    real_warm = fake.warm

    def warm():
        real_warm()
        kernels.LAUNCHES["ed25519_verify"] += 4
        kernels.LAUNCHES["sha512_challenge"] += 2

    monkeypatch.setattr(fake, "warm", warm)
    make_verifier = node_module._make_verifier
    monkeypatch.setattr(node_module, "_make_verifier", lambda kind: fake)
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json"))
    assert node.boot_launches is None
    try:
        node.start()
        kernels.LAUNCHES["ed25519_verify"] += 1  # one device batch after boot
        m = NodeRpcOps(node).node_metrics()
        assert m["kernel_launches_at_boot"] == {
            "ed25519_verify": 4, "sha512_challenge": 2, "sha256_many": 0,
            "sha256_pair": 0}
        assert m["kernel_launches"]["ed25519_verify"] == 5
        json.dumps(m["kernel_launches"])
    finally:
        node.stop()
    monkeypatch.setattr(node_module, "_make_verifier", make_verifier)
    cpu = Node(NodeConfig(name="C", base_dir=tmp_path / "C", port=0,
                          verifier="cpu", network_map=tmp_path / "netmap.json"))
    try:
        cpu.start()
        assert NodeRpcOps(cpu).node_metrics()["kernel_launches_at_boot"] is None
    finally:
        cpu.stop()


def test_cpu_torch_verifier_has_nothing_to_warm(tmp_path, monkeypatch):
    from corda_tpu_torch.crypto.provider import TorchVerifier

    verifier = TorchVerifier(device="cpu", device_min_sigs=0)
    warmed = []
    monkeypatch.setattr(verifier, "warm", lambda: warmed.append(1))
    monkeypatch.setattr(node_module, "_make_verifier", lambda kind: verifier)
    node = Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                           network_map=tmp_path / "netmap.json")).start()
    try:
        assert warmed == []
        assert verifier.device_gate is None
    finally:
        node.stop()


def test_torch_verifier_without_a_card_raises_before_opening(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the torch verifier builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        Node(NodeConfig(name="N", base_dir=tmp_path / "N", port=0,
                        network_map=tmp_path / "netmap.json"))
    assert not (tmp_path / "N").exists()


# -- a fault both packages share (ROADMAP.md queue 3) ------------------------


def _package(name):
    """Node, NodeConfig, faults, DummyContract and NotaryClientFlow of
    ``corda_tpu`` or ``corda_tpu_torch``."""
    import importlib
    from types import SimpleNamespace

    def mod(sub):
        return importlib.import_module(f"{name}.{sub}")

    return SimpleNamespace(
        Node=mod("node.node").Node, NodeConfig=mod("node.config").NodeConfig,
        faults=mod("testing.faults"),
        DummyContract=mod("testing.dummies").DummyContract,
        NotaryClientFlow=mod("flows.notary").NotaryClientFlow)


@pytest.mark.xfail(strict=True, raises=TimeoutError, reason=(
    "ROADMAP.md queue 3: a transport.send drop before a bridge to the peer "
    "exists is never redelivered (node/messaging/tcp.py send/send_many, "
    "the same in both packages)"))
@pytest.mark.parametrize("package", ["corda_tpu", "corda_tpu_torch"])
def test_dropped_first_frame_to_a_peer_is_redelivered(tmp_path, package):
    """One injected ``transport.send`` drop of Alice's first frame to the
    notary, when no bridge to it exists yet: the frame's durable outbox row
    must go out on the bridge's ~1 s fallback re-poll and the flow
    notarise. Both packages return before ``_ensure_bridge`` on a drop, so
    no bridge ever reads that row and the flow waits for ever."""
    pkg = _package(package)

    def start(name, notary):
        return pkg.Node(pkg.NodeConfig(
            name=name, base_dir=tmp_path / name, port=0, notary=notary,
            network_map=tmp_path / "netmap.json", verifier="cpu")).start()

    notary, alice = start("Notary", "simple"), start("Alice", "none")
    plan = pkg.faults.FaultPlan(1, [pkg.faults.FaultRule(
        "transport.send", "drop", max_fires=1)])
    try:
        for node in (notary, alice):
            node.refresh_netmap()
        builder = pkg.DummyContract.generate_initial(
            alice.identity.ref(b"\x01"), 1, notary.identity)
        builder.sign_with(alice.key)
        issue = builder.to_signed_transaction()
        alice.services.record_transactions([issue])
        move = pkg.DummyContract.move(issue.tx.out_ref(0),
                                      alice.identity.owning_key)
        move.sign_with(alice.key)
        pkg.faults.arm(plan)
        handle = alice.start_flow(pkg.NotaryClientFlow(
            move.to_signed_transaction(check_sufficient_signatures=False)))
        deadline = time.monotonic() + 6.0  # several ~1 s re-polls
        while not handle.result.done:
            if time.monotonic() > deadline:
                assert plan.injected() == {"transport.send:drop": 1}
                raise TimeoutError("the dropped frame was never redelivered")
            for node in (notary, alice):
                node.run_once(timeout=0.01)
        assert plan.injected() == {"transport.send:drop": 1}
        handle.result.result()
    finally:
        pkg.faults.disarm()
        alice.stop()
        notary.stop()
