"""A tiny rehearsal of each driver on the CPU (the program's plain
versions): every cell runs, is correct, and reports its metrics."""

from __future__ import annotations

import pytest

from benchmark.harness import core
from benchmark.tests.helpers import TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_runs_correct_on_the_cpu(cell, trace):
    r = run_tiny(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert list(r["checks"]) and all(
        c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    if trace:
        assert "busy_s" in r["device"] and "window_s" in r["device"]
    else:
        names = {m["name"] for m in core.cell_metrics(
            core.load_spec(), cell, "end_to_end")}
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_build_seconds_reads_the_programs_build_clocks(monkeypatch):
    """nvcc builds run in parallel (the longest counts), gcc builds one
    after another (they add); nothing loaded reads 0."""
    import sys
    import types

    from benchmark.harness import card

    monkeypatch.delitem(sys.modules, "corda_tpu_torch.ops._build",
                        raising=False)
    monkeypatch.delitem(sys.modules, "corda_tpu_torch.native", raising=False)
    assert card.build_seconds() == 0.0
    monkeypatch.setitem(sys.modules, "corda_tpu_torch.ops._build",
                        types.SimpleNamespace(BUILD_SECONDS={"a": 3.0,
                                                             "b": 5.0}))
    monkeypatch.setitem(sys.modules, "corda_tpu_torch.native",
                        types.SimpleNamespace(BUILD_SECONDS={"c": 1.5,
                                                             "d": 0.5}))
    assert card.build_seconds() == 7.0
