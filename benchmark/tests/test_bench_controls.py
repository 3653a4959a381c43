"""The controls and the planted faults of controls.py, each driven through
a whole tiny run on the CPU: every one must come out incorrect, naming the
number that caught it."""

from __future__ import annotations

import pytest

from benchmark.controls import prepare_for
from benchmark.tests.helpers import run_tiny

CASES = [
    ("firehose.bulk", "control", "lanes_wrong_vs_oracle"),
    ("firehose.bulk", "flip", "lanes_wrong_vs_labels"),
    ("firehose.bulk", "half", "lanes_wrong_vs_labels"),
    ("firehose.bulk", "stale", "lanes_wrong_vs_labels"),
]


@pytest.mark.parametrize("cell,kind,caught_by", CASES,
                         ids=[f"{c}-{k}" for c, k, _ in CASES])
def test_fault_is_caught(cell, kind, caught_by):
    r = run_tiny(cell, then=prepare_for(kind, "cpu"))
    assert not r["correct"]
    assert r["checks"][caught_by]["value"] > r["checks"][caught_by]["limit"]
