"""The port's TCP node held to the JAX package's, on the CPU.

One seeded workload (``testing/notary_load``: DummyContract issue-and-move
transactions from Alice, a few with a flipped signature byte, then a few
second spends) runs through three JAX ``Node``s and three port ``Node``s
over localhost TCP, each on its own sqlite with identities seeded through
``NodeDatabase.load_or_create_identity``, both notary kinds, every node on
``verifier = "cpu"``. Transaction ids, outcomes, notary signature bytes,
the committed inputs in the notary's sqlite and every node's stored
transaction blobs must be equal. One TOML parses the same in both
``NodeConfig.load``s apart from the verifier kind. Then the packages talk
to each other: a JAX Alice notarises through a port notary over TCP in one
process, and the other way round (the codec's wire names carry no package
prefix, so the frames interoperate).
"""

import sqlite3
import time
from types import SimpleNamespace

import pytest

from corda_tpu_torch.testing import notary_load as nl


def _jax_api():
    from corda_tpu.flows.notary import NotaryClientFlow
    from corda_tpu.node.config import NodeConfig
    from corda_tpu.node.node import Node
    from corda_tpu.node.services.persistence import NodeDatabase
    from corda_tpu.testing.dummies import DummyContract

    return SimpleNamespace(DummyContract=DummyContract,
                           NotaryClientFlow=NotaryClientFlow, Node=Node,
                           NodeConfig=NodeConfig, NodeDatabase=NodeDatabase)


JAX = _jax_api()
PORT = nl.port_api()


def _blobs(node):
    conn = sqlite3.connect(str(node.config.base_dir / "node.db"))
    try:
        return [(bytes(a), bytes(b)) for a, b in conn.execute(
            "SELECT tx_id, blob FROM transactions ORDER BY tx_id")]
    finally:
        conn.close()


def _run(api, base, validating):
    nodes = nl.make_tcp_nodes(api, base, "cpu", validating)
    try:
        work = nl.build_workload(api, *nodes, 24, 2, 2, 11)
        res = nl.run_tcp_workload(api, *nodes, work, timeout_s=120.0)
        res["expected"] = nl.expected_outcomes(work)
        res["blobs"] = {n.config.name: _blobs(n) for n in nodes}
        # The reader chip_smoke's ladder uses on a notary in another
        # process: a read-only connection beside the open node.
        res["committed_at"] = nl.committed_inputs_at(
            nodes[0].config.base_dir / "node.db")
        res["keys"] = [bytes(n.key.public.encoded) for n in nodes]
        return res
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("validating", [False, True],
                         ids=["simple", "validating"])
def test_tcp_workload_equals_the_jax_package(tmp_path, validating):
    jax_res = _run(JAX, tmp_path / "jax", validating)
    port_res = _run(PORT, tmp_path / "port", validating)
    assert port_res["keys"] == jax_res["keys"]
    assert port_res["tx_ids"] == jax_res["tx_ids"]
    kinds = [o[:1] if o[0] == "ok" else o for o in port_res["outcomes"]]
    assert kinds == port_res["expected"]
    assert port_res["outcomes"] == jax_res["outcomes"]  # signature bytes too
    assert port_res["committed"] == jax_res["committed"]
    assert port_res["committed_at"] == port_res["committed"]
    assert port_res["committed_count"] == port_res["notarised"] == 22
    assert port_res["blobs"] == jax_res["blobs"]
    # Signature counts are the workload's; micro-batch boundaries depend on
    # when a round wakes, so the number of batches is not compared.
    for name in nl.NODE_NAMES:
        assert (port_res["nodes"][name]["verify_sigs"]
                == jax_res["nodes"][name]["verify_sigs"]), name


TOML = """
name = "Notary"
base_dir = "nodes/notary"
host = "127.0.0.1"
port = 10001
notary = "validating"
network_map = "netmap.json"
verifier = "{verifier}"
cordapps = ["x.y"]

[batch]
max_sigs = 2048
max_wait_ms = 5.0
coalesce_ms = 0.5
async_verify = false
async_depth = 3
sidecar_deadline_ms = 1500.0

[raft]
pipeline_window = 512
prevote = true

[qos]
enabled = true
slo_ms = 40.0
interactive_rate = 100.0

[durability]
scrub_enabled = true
scrub_rows_per_s = 250.0

[vault]
softlock_ttl_s = 2.0
rebuild_batch = 128

[[rpc_users]]
username = "ops"
password = "pw"
permissions = ["ALL"]
"""


def test_one_toml_parses_the_same_in_both_packages(tmp_path):
    from corda_tpu.node.config import NodeConfig as JaxConfig
    from corda_tpu_torch.node.config import NodeConfig as PortConfig

    (tmp_path / "jax.toml").write_text(TOML.format(verifier="cpu"))
    (tmp_path / "port.toml").write_text(TOML.format(verifier="torch"))
    jax_cfg = JaxConfig.load(tmp_path / "jax.toml")
    port_cfg = PortConfig.load(tmp_path / "port.toml")
    assert port_cfg.verifier == "torch" and jax_cfg.verifier == "cpu"
    fields = [f for f in vars(jax_cfg) if f != "verifier"]
    assert [f for f in vars(port_cfg) if f != "verifier"] == fields
    for f in fields:
        a, b = getattr(jax_cfg, f), getattr(port_cfg, f)
        if hasattr(a, "__dataclass_fields__"):
            a, b = vars(a), vars(b)
        assert a == b, f


@pytest.mark.parametrize("kind", ["jax", "jax-shadow", "jax-sharded", "tpu"])
def test_a_jax_verifier_kind_raises_at_load(tmp_path, kind):
    from corda_tpu_torch.node.config import NodeConfig

    (tmp_path / "n.toml").write_text(f'name = "N"\nverifier = "{kind}"\n')
    with pytest.raises(ValueError, match="torch"):
        NodeConfig.load(tmp_path / "n.toml")


def test_the_port_defaults_to_the_card(tmp_path):
    from corda_tpu_torch.node.config import NodeConfig

    (tmp_path / "n.toml").write_text('name = "N"\n')
    assert NodeConfig.load(tmp_path / "n.toml").verifier == "torch"


def _node(api, base, name, notary="none"):
    node_dir = base / name
    node_dir.mkdir(parents=True, exist_ok=True)
    db = api.NodeDatabase(node_dir / "node.db")
    db.load_or_create_identity(name, nl.node_seed(name))
    db.close()
    return api.Node(api.NodeConfig(
        name=name, base_dir=node_dir, port=0, notary=notary,
        network_map=base / "netmap.json", verifier="cpu")).start()


@pytest.mark.parametrize("client_api, notary_api",
                         [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-alice-port-notary", "port-alice-jax-notary"])
def test_the_packages_notarise_through_each_other(tmp_path, client_api,
                                                  notary_api):
    notary = _node(notary_api, tmp_path, "Notary", notary="simple")
    alice = _node(client_api, tmp_path, "Alice")
    bob = _node(client_api, tmp_path, "Bob")
    nodes = [notary, alice, bob]
    try:
        for n in nodes:
            n.refresh_netmap()
        # The client's own package's view of the notary, from its netmap.
        seen = next(n.legal_identity for n in alice.network_map_cache.party_nodes
                    if n.legal_identity.name == "Notary")
        work = nl.build_workload(client_api, SimpleNamespace(identity=seen),
                                 alice, bob, 6, 1, 1, 5)
        alice.services.record_transactions(work.issues)
        handles = [alice.start_flow(client_api.NotaryClientFlow(s))
                   for s in work.moves + work.doubles]
        deadline = time.monotonic() + 60
        while not all(h.result.done for h in handles):
            assert time.monotonic() < deadline, "the nodes did not settle"
            for n in nodes:
                n.run_once(timeout=0.005)
        kinds = []
        for h, stx in zip(handles, work.moves + work.doubles):
            out = nl.outcome_of(h)
            kinds.append(out[:1] if out[0] == "ok" else out)
            if out[0] == "ok":
                assert out[2] == bytes(notary.key.public.encoded)
        assert kinds == nl.expected_outcomes(work)
        assert notary.uniqueness_provider.committed_count == 5
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("service", [
    "corda.notary.reshard.1:2to4", "corda.notary.reshard.3:4to2",
    "corda.notary.reshard.0:2to4", "corda.notary.reshard.2:2to3",
    "corda.notary.reshard.x:2to4", "corda.notary.shard.0of2",
    "corda.notary.reshard.5:8to16"])
def test_reshard_plan_parse_equals_the_jax_package(service):
    from corda_tpu.node.services import sharding as jax_sharding
    from corda_tpu_torch.node.services import sharding

    assert sharding.parse_reshard_plan(service) == \
        jax_sharding.parse_reshard_plan(service)


def test_shard_service_string_equals_the_jax_package():
    from corda_tpu.node.services import sharding as jax_sharding
    from corda_tpu_torch.node.services import sharding

    for group, count, epoch in ((0, 1, 0), (1, 2, 0), (3, 4, 7)):
        got = sharding.shard_service_string(group, count, epoch)
        assert got == jax_sharding.shard_service_string(group, count, epoch)
        assert sharding.parse_shard_service_full(got) == (group, count, epoch)
    assert sharding.RESHARD_PLAN_PREFIX == jax_sharding.RESHARD_PLAN_PREFIX
    assert sharding.RESHARD_PLAN_ENTRY == jax_sharding.RESHARD_PLAN_ENTRY
