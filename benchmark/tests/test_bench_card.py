"""Checks that need the card (run on it with
``python -m pytest benchmark/tests/test_bench_card.py``)."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark.harness import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.card
def test_the_benchmark_alone_fails(card, tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ has no
    program to measure: the command exits non-zero and prints nothing."""
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "firehose.bulk",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
