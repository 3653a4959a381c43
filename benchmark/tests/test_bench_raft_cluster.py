"""``raft.fh32`` on the CPU: a tiny whole run comes out correct and hands
every per-layer reader its input; its traffic agrees with its
configuration; and the cell's layout pins each process to cores of its
own."""

from __future__ import annotations

import pytest

from benchmark.cluster import plan
from benchmark.harness import core
from benchmark.tests.raft_tiny import run_tiny

SPEC = core.load_spec()
CELL = core.find(SPEC["workloads"], "raft.fh32", "workload")
CONFIG = core.load_json(core.ROOT / core.find(
    SPEC["configs"], CELL["config"], "configuration")["file"])
TRAFFIC = core.load_json(core.traffic_path(CELL["traffic"]))
READERS = [m["name"] for m in core.cell_metrics(SPEC, "raft.fh32",
                                                "per_layer")]


def test_fh32_traffic_matches_its_configuration():
    t, cfg = TRAFFIC, CONFIG
    assert t["driver"] == "raft_cluster"
    assert t["tampered_per_block"] / t["block"] == cfg["tampered_share"]
    assert t["second_per_block"] / t["block"] == cfg["second_spend_share"]
    assert cfg["width"] == 32 and cfg["majority"] * 2 > cfg["members"]
    assert t["moves_per_client"] >= 1000 + t["warm"]
    assert t["moves_per_client"] % t["block"] == 0
    kind, original = plan.moves(7, 0, t["moves_per_client"],
                                t["tampered_per_block"],
                                t["second_per_block"], t["block"])
    blocks = t["moves_per_client"] // t["block"]
    assert kind.count(plan.TAMPERED) == blocks * t["tampered_per_block"]
    assert kind.count(plan.SECOND_SPEND) == blocks * t["second_per_block"]
    assert all(kind[o] == plan.HONEST and o < q for q, o in original.items())
    assert plan.moves(7, 0, 400) == plan.moves(7, 0, 400)
    assert plan.moves(7, 0, 400) != plan.moves(8, 0, 400)


def test_the_layout_gives_each_process_cores_of_its_own():
    cores = dict(TRAFFIC["cores"])
    members = cores.pop("members")
    assert len(members) == CONFIG["members"]
    # Raft0, the clients' notary, validates every move.
    assert len(members[0]) == max(len(ids) for ids in members)
    names = ({"harness", "sidecar"}
             | {f"Client{i}" for i in range(CONFIG["clients"])})
    assert set(cores) == names
    taken = [c for ids in list(cores.values()) + members for c in ids]
    assert len(taken) == len(set(taken)) and max(taken) < 8


@pytest.fixture(scope="module")
def traced():
    return run_tiny(trace=True)


def test_a_tiny_traced_run_is_correct(traced):
    r = traced["result"]
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"flows_wrong_outcome", "notary_sigs_wrong",
                                "acked_not_on_majority",
                                "refused_committed_anywhere"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert "busy_s" in r["device"] and "window_s" in r["device"]
    # Every move a client started reached the members' stores or was
    # refused: some of each kind ran.
    assert r["detail"]["moves_started"] > 2 * 20


def test_every_reader_finds_its_input(traced):
    layer = traced["layer"]
    assert layer["leader"] in layer["members"]
    before, after = layer["members"][layer["leader"]]
    assert "pump_wait" in after["round_stage_s"]
    assert after["raft"]["group_commits"] >= before["raft"]["group_commits"]
    assert all("packs" in s for s in layer["sidecar"])
    assert "trace" in layer
    values = {name: core.load_reader(name).read(layer) for name in READERS}
    # The CPU sidecar packs nothing for a device and the CPU trace holds no
    # device time: those two read nothing here, and the rest read.
    assert values.pop("provider.single_pass_share.fh32") is None
    assert values.pop("device.idle_share.fh32") is None
    assert values["raft.commands_per_entry.fh32"] >= 1, values
    assert all(v is not None and v > 0 for v in values.values()), values


def test_a_tiny_untraced_run_reports_its_end_to_end_metrics():
    r = run_tiny()["result"]
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"verified_sigs_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
