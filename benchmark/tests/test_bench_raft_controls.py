"""The faults of controls_raft.py, each planted in the sidecar of a tiny
``raft.fh32`` run on the CPU: every one must come out incorrect, caught by
the judge's count of wrong outcomes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.cluster.sidecar_host import FAULTS, broken
from benchmark.tests.raft_tiny import run_tiny


@pytest.mark.parametrize("kind", FAULTS)
def test_fault_is_caught(kind):
    r = run_tiny(fault=kind)["result"]
    assert not r["correct"]
    c = r["checks"]["flows_wrong_outcome"]
    assert c["value"] > c["limit"]


def test_each_fault_breaks_a_batch_as_described():
    out = np.array([True, False, True, True])
    assert broken(out, "flip").tolist() == [False, False, True, True]
    assert broken(out, "half").tolist() == [True, False, True, True]
    assert broken(np.array([False] * 4), "half").tolist() == [
        False, False, True, True]
    assert broken(out, "stale").all()
    assert broken(np.zeros(3, bool), "flip").tolist() == [False] * 3
