"""The port's stage registry and trace collector
(corda_tpu_torch/obs/{stages,collect}.py) against the JAX package's.

The registries must be equal name for name; the per-stage breakdown and
the merged Chrome trace of the same span snapshots must be equal, over
seeded synthetic snapshots (batch stages attributed through
``member_traces``, direct stages, markers, orphan spans) and over the
spans a notarisation records on the port's MockNetwork. Then the cases
of tests/test_obs_trace.py, tests/test_qos.py and tests/test_durability.py
that read the registry or the collector, on the port. Tolerance: exact
equality.
"""

import json

import numpy as np
import pytest

from corda_tpu.obs import collect as jcollect
from corda_tpu.obs import stages as jstages
from corda_tpu_torch.crypto.provider import CpuVerifier
from corda_tpu_torch.flows.notary import NotaryClientFlow
from corda_tpu_torch.obs import collect, stages
from corda_tpu_torch.obs import trace as obs
from corda_tpu_torch.testing.dummies import DummyContract
from corda_tpu_torch.testing.mock_network import MockNetwork


@pytest.mark.parametrize("name", jstages.__all__)
def test_registry_equal_jax(name):
    # The port's span names are the reference's and its own provider
    # spans (obs/stages.py PROVIDER_SPANS); every other name is exact.
    want = getattr(jstages, name)
    if name == "SPAN_NAMES":
        want = want | frozenset(stages.PROVIDER_SPANS)
    assert getattr(stages, name) == want
    assert getattr(collect, name, None) == getattr(jcollect, name, None)


def test_provider_spans_are_the_ports_own():
    """No name of the reference's registry is a provider span."""
    jax_names = set()
    for name in jstages.__all__:
        jax_names |= set(getattr(jstages, name))
    assert not set(stages.PROVIDER_SPANS) & jax_names
    assert not hasattr(jstages, "PROVIDER_SPANS")


def _synthetic(seed: int) -> list[dict]:
    """Seeded span snapshots of three nodes: roots, direct stages, batch
    stages over member traces, markers, and spans of no trace."""
    rng = np.random.default_rng(seed)
    traces = [f"t{seed}-{i}" for i in range(40)]
    snaps = []
    for node in ("Notary", "Alice", "Bob"):
        spans = []
        for tid in traces:
            t0 = float(rng.uniform(1e9, 1e9 + 5))
            if rng.random() < 0.9:
                spans.append({"name": "flow:NotaryClientFlow", "parent": None,
                              "trace_id": tid, "span_id": f"{tid}r",
                              "t_start": t0,
                              "t_end": t0 + float(rng.uniform(0.01, 0.2)),
                              "node": node})
            for stage in rng.choice(stages.DIRECT_STAGES + stages.MARKER_SPANS,
                                    3):
                s0 = t0 + float(rng.uniform(0, 0.05))
                spans.append({"name": str(stage), "parent": f"{tid}r",
                              "trace_id": tid, "span_id": f"{tid}{stage}",
                              "t_start": s0,
                              "t_end": s0 + float(rng.uniform(0, 0.05)),
                              "attrs": {"ok": bool(rng.random() < 0.5)}})
        for stage in stages.BATCH_STAGES:
            members = [str(t) for t in rng.choice(traces, 5, replace=False)]
            s0 = float(rng.uniform(1e9, 1e9 + 5))
            spans.append({"name": stage, "parent": None, "trace_id": None,
                          "span_id": f"b{stage}", "t_start": s0,
                          "t_end": s0 + float(rng.uniform(0, 0.02)),
                          "attrs": {"member_traces": members}})
        spans.append({"name": "orphan", "trace_id": None, "t_start": 1e9})
        snaps.append({"node": node, "spans": spans})
    snaps.append([{"name": "flow:Bare", "trace_id": "bare", "parent": None,
                   "t_start": 1e9, "t_end": 1e9 + 0.5}])
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breakdown_and_trace_equal_jax_synthetic(seed):
    snaps = _synthetic(seed)
    assert collect.stage_breakdown(snaps) == jcollect.stage_breakdown(snaps)
    assert collect.merge_chrome_trace(snaps) == \
        jcollect.merge_chrome_trace(snaps)


@pytest.fixture()
def recorder():
    rec = obs.arm("test", capacity=4096)
    yield rec
    obs.disarm()


@pytest.fixture()
def net():
    network = MockNetwork(verifier=CpuVerifier())
    yield network
    network.stop_nodes()


def _notarise_moves(net, n: int = 3):
    notary = net.create_notary_node("Notary")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    handles = []
    for i in range(n):
        builder = DummyContract.generate_initial(
            alice.identity.ref(bytes([i])), 7 + i, notary.identity)
        builder.sign_with(alice.key)
        issue_stx = builder.to_signed_transaction()
        alice.record_transaction(issue_stx)
        move = DummyContract.move(issue_stx.tx.out_ref(0),
                                  bob.identity.owning_key)
        move.sign_with(alice.key)
        handles.append(alice.start_flow(NotaryClientFlow(
            move.to_signed_transaction(check_sufficient_signatures=False))))
    net.run_network()
    assert all(h.result.done and h.result.exception() is None
               for h in handles)


def test_breakdown_and_trace_equal_jax_notarised(recorder, net, tmp_path):
    _notarise_moves(net)
    snaps = [{"node": "inproc", "spans": recorder.snapshot()}]
    assert collect.stage_breakdown(snaps) == jcollect.stage_breakdown(snaps)
    path, jpath = tmp_path / "p.json", tmp_path / "j.json"
    collect.write_chrome_trace(str(path), snaps)
    jcollect.write_chrome_trace(str(jpath), snaps)
    assert path.read_bytes() == jpath.read_bytes()
    assert all(e["cat"] == "corda_tpu"
               for e in json.loads(path.read_text())["traceEvents"]
               if e["ph"] == "X")


# -- tests/test_obs_trace.py -------------------------------------------------


def test_stage_breakdown_from_inmem_trace(recorder, net):
    _notarise_moves(net, 1)
    snap = {"node": "inproc", "spans": recorder.snapshot()}
    breakdown = collect.stage_breakdown([snap])
    assert breakdown["traces"] >= 1
    assert set(breakdown["stages"]) == set(collect.STAGES)
    e2e = breakdown["end_to_end"]["mean_ms"]
    assert e2e > 0
    # The derived reply stage closes the attribution gap: stage sum tracks
    # end-to-end by construction.
    total = sum(v["mean_ms"] for v in breakdown["stages"].values())
    assert total <= e2e * 1.05


def test_merged_chrome_trace_shape(recorder, net, tmp_path):
    _notarise_moves(net, 1)
    path = tmp_path / "trace.json"
    collect.write_chrome_trace(str(path), [
        {"node": "inproc", "spans": recorder.snapshot()}])
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert "flow:NotaryClientFlow" in names
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in events)
    for e in events:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] > 0


def test_recorded_span_names_are_registered(recorder, net):
    """Every span the port records on a notarisation is a registry name
    (or a flow: root), so the breakdown loses none of them."""
    _notarise_moves(net, 2)
    for span in recorder.snapshot():
        name = span["name"]
        assert name in stages.SPAN_NAMES or name.startswith(
            stages.SPAN_NAME_PREFIXES), name


# -- tests/test_qos.py and tests/test_durability.py --------------------------


def test_qos_stages_registered_in_obs():
    assert "admission_wait" in stages.DIRECT_STAGES
    assert "lane_queue_wait" in stages.DIRECT_STAGES
    assert "qos_flush" in stages.MARKER_SPANS


def test_scrub_and_repair_trace_stages_registered():
    for stage in ("scrub", "repair"):
        assert stage in stages.DIRECT_STAGES
        assert stage in stages.STAGES
        assert stage in stages.SPAN_NAMES
