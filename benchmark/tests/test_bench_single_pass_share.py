"""The reader of ``provider.single_pass_share.bulk``: the share of device
batches the provider's native pass packed, from its ``PACKS`` counter, and
nothing from a program without the counter."""

from __future__ import annotations

import pytest

from benchmark.harness import core
from benchmark.tests.helpers import run_tiny

NAME = "provider.single_pass_share.bulk"


TRACED = {"trace": {"busy_s": 1.0, "window_s": 30.0}, "calls": 1}


def _read(layer=TRACED):
    return core.load_reader(NAME).read(layer)


def test_reads_the_share_of_batches_the_pass_packed(monkeypatch):
    from corda_tpu_torch.crypto import provider

    monkeypatch.setattr(provider, "PACKS", {"single_pass": 3, "fallback": 1})
    assert _read() == pytest.approx(75.0)
    monkeypatch.setattr(provider, "PACKS", {"single_pass": 0, "fallback": 2})
    assert _read() == 0.0


def test_none_without_the_counter_or_a_packed_batch(monkeypatch):
    from corda_tpu_torch.crypto import provider

    monkeypatch.setattr(provider, "PACKS", {"single_pass": 3, "fallback": 1})
    assert _read({"calls": 1}) is None              # an untraced run
    monkeypatch.setattr(provider, "PACKS", {"single_pass": 0, "fallback": 0})
    assert _read() is None
    monkeypatch.delattr(provider, "PACKS")
    assert _read() is None


def test_a_traced_tiny_run_reads_every_batch_packed_by_the_pass(monkeypatch):
    from corda_tpu_torch import native
    from corda_tpu_torch.crypto import provider

    if native.load_cverify() is None:
        pytest.skip("no native core on this host: no batch takes the pass")
    monkeypatch.setattr(provider, "PACKS", {"single_pass": 0, "fallback": 0})
    r = run_tiny("firehose.bulk", trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME] == {"value": 100.0, "unit": "%"}
