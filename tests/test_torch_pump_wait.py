"""The run loop's pump split from its wait, and the sidecar's pack paths in
its stats, on the CPU.

``TcpMessaging.pump`` adds the seconds it spends blocked on its inbound
queue to ``pump_wait_s`` (exported in ``transport_stats()``); the node's run
loop books the same seconds of each round as ``round_stage_s["pump_wait"]``
beside ``"pump"``, which still holds the whole pump call. The sidecar's
``stats()`` carries ``provider.PACKS`` under ``"packs"``.
"""

import time

import pytest

from corda_tpu_torch.crypto import provider, sidecar
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.node.config import BatchConfig, NodeConfig
from corda_tpu_torch.node.messaging.api import Message, TopicSession
from corda_tpu_torch.node.messaging.inmem import InMemoryMessagingNetwork
from corda_tpu_torch.node.messaging.tcp import TcpMessaging
from corda_tpu_torch.node.node import Node


def _message(i: int) -> Message:
    return Message(TopicSession("bench.pump", 0), b"x", bytes([i]) * 16)


def test_a_queued_message_is_taken_without_waiting():
    messaging = TcpMessaging()  # not started: no sockets, just the queue
    got = []
    messaging.add_message_handler("bench.pump", 0, lambda m: got.append(m))
    messaging._inbound.put((None, _message(1)))
    t0 = time.perf_counter()
    assert messaging.pump(timeout=2.0) == 1
    assert time.perf_counter() - t0 < 1.0
    assert len(got) == 1
    assert 0.0 <= messaging.pump_wait_s < 0.05
    assert messaging.transport_stats()["pump_wait_s"] == round(
        messaging.pump_wait_s, 6)


def test_a_pump_that_times_out_counts_its_timeout():
    messaging = TcpMessaging()
    assert messaging.pump(timeout=0.2) == 0
    assert 0.18 <= messaging.pump_wait_s < 1.0
    assert messaging.pump(timeout=0.0) == 0  # a non-blocking pump adds 0
    assert messaging.pump_wait_s < 1.0


def test_the_coalescing_window_is_waiting_too():
    messaging = TcpMessaging()
    messaging.add_message_handler("bench.pump", 0, lambda m: None)
    messaging._inbound.put((None, _message(2)))
    assert messaging.pump(timeout=1.0, coalesce=0.15) == 1
    assert 0.13 <= messaging.pump_wait_s < 1.0


def test_inmem_transport_stats_carry_the_key():
    net = InMemoryMessagingNetwork()
    stats = net.create_node_messaging("a").transport_stats()
    assert stats["pump_wait_s"] == 0.0
    assert set(stats) == set(TcpMessaging().transport_stats())


@pytest.fixture
def node(tmp_path):
    config = NodeConfig(name="Solo", base_dir=tmp_path / "Solo", port=0,
                        notary="none", network_map=tmp_path / "netmap.json",
                        verifier="cpu",
                        batch=BatchConfig(max_sigs=4096, max_wait_ms=2.0))
    n = Node(config).start()
    yield n
    n.stop()


def test_round_stage_pump_holds_its_wait(node):
    """An idle round's pump is all wait: ``pump`` keeps the whole call,
    ``pump_wait`` the blocked part of it."""
    node.run_once(timeout=0.01)
    stages = node.smm.metrics["round_stage_s"]
    pump0, wait0 = stages["pump"], stages["pump_wait"]
    for _ in range(3):
        node.run_once(timeout=0.1)
    pump = stages["pump"] - pump0
    wait = stages["pump_wait"] - wait0
    assert 0.27 <= wait <= pump
    assert pump - wait < 0.05
    assert stages["rounds"] == 4


def test_round_stage_pump_work_without_wait(node):
    """A round whose message is already queued waits ~0 and books the
    handler's time as pump work."""
    node.messaging.add_message_handler(
        "bench.pump", 0, lambda m: time.sleep(0.05))
    node.run_once(timeout=0.0)
    stages = node.smm.metrics["round_stage_s"]
    pump0, wait0 = stages["pump"], stages["pump_wait"]
    node.messaging._inbound.put((None, _message(3)))
    node.run_once(timeout=1.0)
    pump = stages["pump"] - pump0
    wait = stages["pump_wait"] - wait0
    assert wait < 0.03
    assert pump - wait >= 0.045
    assert node.messaging.pump_wait_s >= wait


def _signed(i: int):
    seed = bytes([i + 1]) * 32
    msg = bytes([i, 9]) * 16
    return provider.VerifyJob(ref.public_key(seed), msg, ref.sign(seed, msg))


def test_sidecar_stats_carry_the_pack_paths(tmp_path):
    address = str(tmp_path / "s.sock")
    if len(address) >= 100:
        address = "127.0.0.1:0"
    srv = sidecar.SidecarServer(address, device="cpu", coalesce_us=0,
                                max_sigs=64, device_min_sigs=0).start(
                                    warm=False)
    try:
        before = srv.stats()["packs"]
        assert before == provider.PACKS
        assert set(before) == {"single_pass", "fallback"}
        jobs = [_signed(i) for i in range(5)]
        packed = srv.verifier.pack_device(jobs)
        assert packed is not None
        assert srv.verifier.verify_packed(packed).all()
        after = srv.stats()["packs"]
        assert (sum(after.values()) - sum(before.values())) == 1
        # The copy is the process's counter at the time of the call.
        after["single_pass"] += 100
        assert srv.stats()["packs"] != after
    finally:
        srv.stop()
