"""The port's multi-process tier: real port node processes, real sockets.

The port's mirror of ``tests/test_driver.py``: nodes run as separate OS
processes (``python -m corda_tpu_torch.node.node``) spawned by the port's
driver, on the host tier (``device="cpu"``: ``verifier = "cpu"``, the card
hidden), and the tests drive them only through RPC. The two long
multi-process tests are marked slow as the reference's are; config
rendering and the host seam run in tier-1.
"""

import time

import pytest

import corda_tpu_torch.testing.dummies  # noqa: F401  (the vault's state type)
from corda_tpu_torch.testing.driver import driver


@pytest.mark.slow
def test_two_processes_issue_and_notarise(tmp_path):
    with driver(tmp_path) as d:
        d.start_node("Notary", notary="simple",
                     cordapps=("corda_tpu_torch.tools.demo_cordapp",))
        alice = d.start_node(
            "Alice", cordapps=("corda_tpu_torch.tools.demo_cordapp",), rpc=True)
        client = alice.rpc("demo", "s3cret")
        try:
            # Wait until Alice's netmap refresh has seen the notary.
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                names = {n.legal_identity.name
                         for n in client.call("network_map_snapshot")}
                if "Notary" in names:
                    break
                time.sleep(0.2)
            else:
                raise AssertionError("Alice never saw the notary")

            handle = client.start_flow("IssueAndNotariseFlow", 7)
            tx_id = client.wait_for_flow(handle, timeout=30.0)
            assert isinstance(tx_id, str) and len(tx_id) == 64
            # The notarised move is in Alice's storage and her vault holds
            # exactly the moved state.
            assert len(client.call("vault_snapshot")) == 1
        finally:
            client.close()


@pytest.mark.slow
def test_kill_notary_process_and_restart(tmp_path):
    """Process-level disruption (Disruption.kt 'kill' primitive): SIGKILL the
    notary mid-life, restart it from the same base_dir, and notarise again —
    the commit log and identity survive an actual process death."""
    with driver(tmp_path) as d:
        notary = d.start_node("Notary", notary="simple",
                     cordapps=("corda_tpu_torch.tools.demo_cordapp",))
        alice = d.start_node(
            "Alice", cordapps=("corda_tpu_torch.tools.demo_cordapp",), rpc=True)
        client = alice.rpc("demo", "s3cret")
        try:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                names = {n.legal_identity.name
                         for n in client.call("network_map_snapshot")}
                if "Notary" in names:
                    break
                time.sleep(0.2)

            h1 = client.start_flow("IssueAndNotariseFlow", 1)
            client.wait_for_flow(h1, timeout=30.0)

            notary.kill()  # SIGKILL: no graceful shutdown whatsoever
            d.start_node("Notary", notary="simple",
                     cordapps=("corda_tpu_torch.tools.demo_cordapp",))  # same base_dir

            h2 = client.start_flow("IssueAndNotariseFlow", 2)
            tx_id = client.wait_for_flow(h2, timeout=45.0)
            assert len(tx_id) == 64
        finally:
            client.close()


def test_rendered_config_keeps_extra_toml_top_level(tmp_path):
    # Regression: extra_toml appended AFTER [[rpc_users]] made `verifier`
    # an rpc_users field — every RPC-enabled node silently ran the default
    # verifier. The rendered config must parse with the knob top-level.
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.testing.driver import DEFAULT_RPC_USER, render_node_config

    text = render_node_config(
        name="N", node_dir=tmp_path, netmap=tmp_path / "netmap.json",
        cordapps=("corda_tpu_torch.tools.loadgen",),
        extra_toml='verifier = "torch"\n[batch]\nmax_sigs = 4096\n'
                   "max_wait_ms = 2.0\n",
        rpc_users=[DEFAULT_RPC_USER])
    path = tmp_path / "node.toml"
    path.write_text(text)
    cfg = NodeConfig.load(str(path))
    assert cfg.verifier == "torch"
    assert cfg.batch.max_sigs == 4096
    assert cfg.rpc_users and cfg.rpc_users[0]["username"] == "demo"
    assert "verifier" not in cfg.rpc_users[0]


def test_host_seam_routes_every_placement_operation(tmp_path):
    """The Host abstraction (reference: ConnectionManager.kt's remote-host
    placement) carries EVERY file write, log read and spawn — the loadtest
    harness runs unchanged through it, so an SSH host only has to
    implement the same four methods."""
    from corda_tpu_torch.testing.driver import Driver, LocalHost

    class CountingHost(LocalHost):
        name = "counting-localhost"

        def __init__(self):
            self.calls = {"mkdir": 0, "write_file": 0, "read_text": 0,
                          "spawn": 0}

        def mkdir(self, path):
            self.calls["mkdir"] += 1
            return super().mkdir(path)

        def write_file(self, path, text):
            self.calls["write_file"] += 1
            return super().write_file(path, text)

        def read_text(self, path):
            self.calls["read_text"] += 1
            return super().read_text(path)

        def spawn(self, argv, log_path, cwd, env):
            self.calls["spawn"] += 1
            return super().spawn(argv, log_path, cwd, env)

    host = CountingHost()
    d = Driver(tmp_path, host=host)
    try:
        node = d.start_node("Seam", rpc=True)
        assert node.host is host
        rpc = node.rpc("demo", "s3cret")
        assert rpc.call("node_identity") is not None
        rpc.close()
        node.kill()
        reborn = d.restart_node(node)
        assert reborn.host is host and reborn.address is not None
    finally:
        d.stop_all()
    assert reborn.process.returncode == 0  # SIGTERM stops a node cleanly
    assert host.calls["mkdir"] == 1
    assert host.calls["write_file"] == 1
    assert host.calls["spawn"] == 2      # start + restart
    assert host.calls["read_text"] > 0   # banner polling reads the log


def test_rendered_verifier_follows_the_placement(tmp_path):
    """A node placed on the host tier gets verifier = "cpu" and cannot see
    the card; one placed on the accelerator gets verifier = "torch"."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.testing.driver import _node_env, render_node_config

    for verifier in ("cpu", "torch"):
        path = tmp_path / f"{verifier}.toml"
        path.write_text(render_node_config(
            name="N", node_dir=tmp_path, netmap=tmp_path / "netmap.json",
            verifier=verifier, rpc_users=[]))
        assert NodeConfig.load(str(path)).verifier == verifier
    assert _node_env("cpu")["CUDA_VISIBLE_DEVICES"] == ""
    with pytest.raises(ValueError):
        _node_env("tpu")
