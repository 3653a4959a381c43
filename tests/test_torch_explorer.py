"""The port's explorer (corda_tpu_torch/tools/explorer.py): the mirror of
tests/test_explorer.py's five cases against an in-process port node on the
host verifier (``"cpu"``), the demo mode with its verifier set to
``"cpu"``, and ``render_value`` / ``cash_balances`` held to the JAX
package's on the same ledger objects.
"""

import json
import threading
import time
import urllib.request

import pytest

from corda_tpu_torch.finance import Amount
from corda_tpu_torch.finance.cash import Cash
from corda_tpu_torch.node.config import NodeConfig
from corda_tpu_torch.node.node import Node
from corda_tpu_torch.node.rpc import RpcClient
from corda_tpu_torch.tools.explorer import (
    ExplorerServer,
    cash_balances,
    render_value,
)

RPC_USERS = ({"username": "ops", "password": "pw", "permissions": ["ALL"]},)


def _start(tmp_path, name, **kw):
    node = Node(NodeConfig(
        name=name, base_dir=tmp_path / name,
        network_map=tmp_path / "netmap.json", verifier="cpu",
        rpc_users=RPC_USERS, **kw)).start()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            node.run_once(timeout=0.01)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()

    def close():
        stop.set()
        pumper.join(timeout=2)
        node.stop()

    return node, close


@pytest.fixture()
def live_node(tmp_path):
    node, close = _start(tmp_path, "Exp")
    try:
        yield node
    finally:
        close()


def get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def self_issue(node, quantity=5000):
    builder = Cash.generate_issue(
        Amount(quantity, "USD"), node.identity.ref(b"\x01"),
        node.identity.owning_key, node.identity)
    builder.sign_with(node.key)
    stx = builder.to_signed_transaction()
    node.services.record_transactions([stx])
    return stx


def test_render_value_handles_ledger_types(live_node):
    stx = self_issue(live_node)
    rendered = render_value(stx)
    assert rendered["_type"] == "SignedTransaction"
    flat = json.dumps(rendered)
    assert "CashState" in flat and "USD" in flat


def test_render_value_equals_the_references(live_node):
    import corda_tpu.finance.cash  # noqa: F401  (whitelists its types)
    from corda_tpu.serialization.codec import deserialize as ref_deserialize
    from corda_tpu.tools.explorer import render_value as ref_render
    from corda_tpu_torch.serialization.codec import serialize

    stx = self_issue(live_node)
    ref_stx = ref_deserialize(serialize(stx).bytes)
    assert json.dumps(render_value(stx), sort_keys=True) == json.dumps(
        ref_render(ref_stx), sort_keys=True)
    for value in (None, 3, "x", b"\x01" * 65, {1, 2}, {"k": (1, [2])}):
        assert render_value(value) == ref_render(value)


def test_dashboard_aggregates_node_state(live_node):
    self_issue(live_node, 5000)
    self_issue(live_node, 1250)
    client = RpcClient(live_node.messaging.my_address, "ops", "pw")
    server = ExplorerServer(client)
    try:
        host, port = server.address
        status, ctype, body = get(f"http://{host}:{port}/")
        assert status == 200 and "text/html" in ctype
        assert b"corda_tpu_torch explorer" in body

        status, ctype, body = get(f"http://{host}:{port}/api/dashboard")
        assert status == 200 and "application/json" in ctype
        d = json.loads(body)
        assert d["identity"] == "Exp"
        assert d["balances"] == {"USD": 6250}
        assert len(d["vault"]) == 2
        assert len(d["transactions"]) == 2
        assert d["metrics"]["verifier"].startswith("cpu")
        status, _, body2 = get(f"http://{host}:{port}/api/dashboard")
        assert status == 200
        assert json.loads(body2)["balances"] == {"USD": 6250}
        status, _, _ = get(f"http://{host}:{port}/nowhere")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    finally:
        server.stop()
        client.close()


def test_cash_balances_ignores_foreign_states():
    from corda_tpu_torch.testing.dummies import DummySingleOwnerState

    assert cash_balances([]) == {}
    assert cash_balances([DummySingleOwnerState(1)]) == {}


def test_demo_traffic_populates_vault(live_node):
    from corda_tpu_torch.finance import CashState
    from corda_tpu_torch.tools.explorer import DemoTraffic

    traffic = DemoTraffic(live_node, period=0.01, seed=7)
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            states = live_node.services.vault_service.unconsumed_states(
                CashState)
            txs = len(live_node.services.storage_service
                      .validated_transactions)
            if states and txs >= 5:
                break
            time.sleep(0.05)
        assert states, "demo traffic never issued cash"
        assert txs >= 5, "demo traffic stalled"
        assert cash_balances(
            live_node.services.vault_service.current_vault.states)
    finally:
        traffic.stop()


def test_dashboard_joins_tx_provenance(tmp_path):
    import corda_tpu_torch.tools.demo_cordapp  # noqa: F401
    from corda_tpu_torch.tools.explorer import ExplorerModel

    node, close = _start(tmp_path, "ProvExp", notary="simple")
    client = RpcClient(node.messaging.my_address, "ops", "pw")
    try:
        handle = client.call(
            "start_flow_dynamic", "IssueAndNotariseFlow", (7,))
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            done, _ = client.call("flow_result", handle.run_id)
            if done:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("demo flow did not finish")
        model = ExplorerModel(client)
        dash = model.gather()
        run_short = handle.run_id.hex()[:8]
        attributed = [tx for tx, runs in dash["tx_provenance"].items()
                      if run_short in runs]
        assert len(attributed) == 2, dash["tx_provenance"]
    finally:
        client.close()
        close()


def test_run_demo_serves_a_dashboard_on_the_host_verifier():
    from corda_tpu_torch.tools.explorer import _run_demo

    server, cleanup = _run_demo(0, verifier="cpu")
    try:
        host, port = server.address
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            d = json.loads(get(f"http://{host}:{port}/api/dashboard")[2])
            if d["balances"]:
                break
            time.sleep(0.2)
        assert d["identity"] == "DemoBank"
        assert d["balances"] and all(v > 0 for v in d["balances"].values())
        assert d["metrics"]["verifier"].startswith("cpu")
    finally:
        cleanup()


def test_run_demo_defaults_to_the_card():
    import inspect

    from corda_tpu_torch.tools.explorer import _run_demo

    assert inspect.signature(_run_demo).parameters["verifier"].default \
        == "torch"
