"""BENCHMARK.json against the files the harness finds by name, and the
contract's limits on the file itself."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = {w["name"]: w for w in SPEC["workloads"]}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_names_a_config_traffic_and_driver(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    cfg = core.find(SPEC["configs"], w["config"], "configuration")
    assert (core.ROOT / cfg["file"]).is_file()
    traffic = core.load_json(core.traffic_path(w["traffic"]))
    assert callable(core.load_driver(traffic["driver"]).run)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("benchmark/configs/")
    body = core.load_json(core.ROOT / cfg["file"])
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert body["guarantees"]
    assert any(cfg["name"] == w["config"] for w in SPEC["workloads"])


def test_bulk_traffic_matches_its_configuration():
    cfg = core.load_json(core.ROOT / "benchmark/configs/firehose-verify.json")
    bulk = core.load_json(core.traffic_path("bulk"))
    assert bulk["batch"] == cfg["verify_batch_sigs"]
    assert bulk["flipped"] == round(bulk["batch"] * cfg["tampered_share"])


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    for cell in m.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_agrees(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    moved = E2E[m["moves"]]
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        assert m["name"].endswith("." + CELLS[cell]["traffic"])
    assert callable(core.load_reader(m["name"]).read)
    assert core.load_reader(m["name"]).read({}) is None
    if m["unit"] == "%":
        assert "roofline" in m["name"] or "share" in m["name"]


def test_every_reader_and_traffic_file_is_named():
    named = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (core.BENCH / "metrics").glob("*.py")}
    assert files == named
    traffics = {p.stem for p in (core.BENCH / "traffic").glob("*.json")}
    assert traffics == {w["traffic"] for w in SPEC["workloads"]}


def test_layers_are_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in core.cell_metrics(SPEC, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(SPEC, cell, "per_layer")


def test_a_new_cell_and_metric_are_files_only(tmp_path, monkeypatch):
    """A cell, its traffic and a per-layer metric added as new files and
    entries run with no edit to the harness."""
    bench = tmp_path / "benchmark"
    for sub in ("traffic", "metrics"):
        shutil.copytree(core.BENCH / sub, bench / sub)
    traffic = dict(core.load_json(core.traffic_path("bulk")), batch=40,
                   pool=1, keys=4, flipped=2, malleated=1, sample_plain=2)
    (bench / "traffic" / "bulk_small.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "calls.bulk_small.py").write_text(
        "def read(layer):\n    return layer.get('calls')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "firehose.bulk_small",
                              "config": "firehose-verify",
                              "traffic": "bulk_small", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("firehose.bulk_small")
    spec["per_layer"].append({
        "name": "calls.bulk_small", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "test", "moves":
        "verified_sigs_per_s", "workloads": ["firehose.bulk_small"]})
    monkeypatch.setattr(core, "BENCH", bench)
    monkeypatch.setattr(core, "load_spec", lambda: spec)
    r = core.run_cell("firehose.bulk_small", 5, 1, True, device="cpu")
    assert r["correct"] and r["metrics"]["calls.bulk_small"]["value"] >= 1
    r = core.run_cell("firehose.bulk_small", 5, 1, False, device="cpu")
    assert set(r["metrics"]) == {"verified_sigs_per_s", "setup_s"}
