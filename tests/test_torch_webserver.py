"""The port's node web API (corda_tpu_torch/node/webserver.py) against the
JAX package's: the mirror of tests/test_clauses_web.py's TestWebServer and
TestMonitoringBridge, with the history, trace, info and Prometheus
endpoints of tests/test_obs_trace.py and tests/test_telemetry.py.

A JAX node and a port node (``verifier = "cpu"``, ``web_port = 0``) run
the same IssueAndNotariseFlow; every endpoint must answer both with the
same JSON keys (values that name the node, its address or its timings
aside), the same attachment id for the same upload, and the same
Prometheus series.
"""

import importlib
import json
import urllib.error
import urllib.request

import pytest

PACKAGES = ("corda_tpu", "corda_tpu_torch")


def _node(pkg, tmp_path, name, **kw):
    config = importlib.import_module(f"{pkg}.node.config")
    node_mod = importlib.import_module(f"{pkg}.node.node")
    return node_mod.Node(config.NodeConfig(
        name=name, base_dir=tmp_path / pkg / name,
        network_map=tmp_path / pkg / "netmap.json", verifier="cpu",
        web_port=0, **kw)).start()


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _json(base, path):
    return json.loads(_get(base, path)[2])


def _keys(x):
    """The nested key structure of a JSON value (lists by their first
    element)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return type(x).__name__


def _run_demo_flow(pkg, node):
    importlib.import_module(f"{pkg}.tools.demo_cordapp")
    flow_registry = importlib.import_module(f"{pkg}.flows.api").flow_registry
    handle = node.smm.add(flow_registry.create("IssueAndNotariseFlow", (3,)))
    for _ in range(2000):
        node.run_once(timeout=0.001)
        if handle.result.done:
            break
    assert handle.result.done and handle.result.exception() is None


def _surfaces(pkg, tmp_path):
    """Every endpoint of a fresh node after one demo flow."""
    node = _node(pkg, tmp_path, "WebNode", notary="simple")
    base = f"http://127.0.0.1:{node.webserver.port}"
    try:
        _run_demo_flow(pkg, node)
        # Force two history samples through the run loop's cadence gate.
        for _ in range(2):
            node._metrics_sampled_at = 0.0
            node.run_once(timeout=0.001)
        blob = b"legal prose attachment" * 50
        req = urllib.request.Request(
            f"{base}/upload/attachment", data=blob, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            att_id = json.load(resp)["id"]
        back = _get(base, f"/attachments/{att_id}")
        missing = []
        for path in (f"/attachments/{'0' * 64}", "/attachments/zz",
                     "/no/such/path"):
            with pytest.raises(urllib.error.HTTPError) as info:
                _get(base, path)
            missing.append(info.value.code)
        _, ctype, text = _get(base, "/metrics")
        export = importlib.import_module(f"{pkg}.obs.export")
        return {
            "name": node.config.name,
            "address": str(node.messaging.my_address),
            "status": _json(base, "/api/status"),
            "metrics": _json(base, "/api/metrics"),
            "history": _json(base, "/api/metrics/history"),
            "trace": _json(base, "/api/trace"),
            "info": _json(base, "/api/info"),
            "owning_key": node.identity.owning_key.to_base58_string(),
            "att_id": att_id, "blob": blob, "back": back,
            "missing": missing, "ctype": ctype,
            "prometheus": export.parse_prometheus(text.decode()),
        }
    finally:
        node.stop()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("web")
    return {pkg: _surfaces(pkg, tmp) for pkg in PACKAGES}


def test_status_answers_as_the_jax_node(both):
    port = both["corda_tpu_torch"]
    assert port["status"] == {"name": "WebNode", "address": port["address"],
                              "flows_in_flight": 0}
    assert _keys(port["status"]) == _keys(both["corda_tpu"]["status"])


def test_metrics_and_flow_timings_as_the_jax_node(both):
    port, jax = both["corda_tpu_torch"], both["corda_tpu"]
    assert "started" in port["metrics"]
    timings = port["metrics"]["flow_timings"]["IssueAndNotariseFlow"]
    assert timings["count"] == 1 and timings["max_ms"] > 0
    assert set(port["metrics"]) == set(jax["metrics"])
    assert _keys(port["metrics"]["flow_timings"]) == \
        _keys(jax["metrics"]["flow_timings"])


def test_metrics_history_newest_first_as_the_jax_node(both):
    port, jax = both["corda_tpu_torch"], both["corda_tpu"]
    history = port["history"]
    assert len(history) >= 2
    assert history[0]["ts"] >= history[-1]["ts"]
    assert "verify_sigs" in history[-1]
    assert set(history[0]) == set(jax["history"][0])


def test_trace_and_info_as_the_jax_node(both):
    port, jax = both["corda_tpu_torch"], both["corda_tpu"]
    assert port["trace"] == {"node": "WebNode", "armed": False,
                             "spans": [], "stats": None} == jax["trace"]
    assert port["info"] == {
        "legal_identity": "WebNode", "owning_key": port["owning_key"],
        "advertised_services": port["info"]["advertised_services"]}
    assert port["info"]["advertised_services"] == \
        jax["info"]["advertised_services"]
    assert _keys(port["info"]) == _keys(jax["info"])


def test_attachment_roundtrip_as_the_jax_node(both):
    port, jax = both["corda_tpu_torch"], both["corda_tpu"]
    status, ctype, body = port["back"]
    assert (status, ctype, body) == (200, "application/octet-stream",
                                     port["blob"])
    assert port["att_id"] == jax["att_id"]  # content-addressed alike
    assert port["missing"] == jax["missing"] == [404, 400, 404]


def test_prometheus_series_as_the_jax_node(both):
    port, jax = both["corda_tpu_torch"], both["corda_tpu"]
    assert port["ctype"] == jax["ctype"]
    for kind in ("counters", "histograms"):
        assert set(port["prometheus"][kind]) == set(jax["prometheus"][kind])
        assert port["prometheus"][kind]
