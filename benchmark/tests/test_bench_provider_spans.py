"""The readers of the provider's spans (``provider.*_ms_per_batch.bulk``,
benchmark/provider_spans.py) on a synthetic ``VERIFY`` ring, and once on a
traced tiny run of the cell on the CPU."""

from __future__ import annotations

import pytest

from benchmark import provider_spans
from benchmark.harness import core
from benchmark.tests.helpers import run_tiny

READERS = ("provider.dispatch_ms_per_batch.bulk",
           "provider.pack_ms_per_batch.bulk",
           "provider.copy_in_ms_per_batch.bulk",
           "provider.device_wait_ms_per_batch.bulk")


def _batch(ring, t0, pack, copy, wait, dispatch, complete=True):
    """Records one batch as the provider does: the stages under the outer
    span's id, then the outer span. Returns the batch's end."""
    from corda_tpu_torch.obs import trace

    tid, sid = trace.new_trace_id(), trace.new_span_id()
    t = t0 + dispatch / 2
    parts = [("provider_pack", pack), ("provider_copy_in", copy),
             ("provider_device_wait", wait)]
    for name, d in parts if complete else parts[:2]:
        ring.record(name, t, t + d, trace_id=tid, parent=sid)
        t += d
    end = t + dispatch / 2
    ring.record("provider_verify", t0, end, trace_id=tid, span_id=sid)
    return end


@pytest.fixture
def ring(monkeypatch):
    from corda_tpu_torch.obs import trace

    rec = trace.SpanRecorder("", 64)
    monkeypatch.setattr(trace, "VERIFY", rec)
    return rec


def _read(name, layer):
    return core.load_reader(name).read(layer)


def _window(ring, n, warm=True):
    """A warm-up batch far slower than the rest, a stray stage span with
    no outer span (as a call that raised leaves), then ``n`` window
    batches whose k-th spends k ms in each part."""
    t = 1e9
    if warm:
        t = _batch(ring, t, 0.5, 0.5, 0.5, 0.5)
    from corda_tpu_torch.obs import trace

    tid = trace.new_trace_id()
    ring.record("provider_pack", t, t + 1.0, trace_id=tid)
    for k in range(1, n + 1):
        t = _batch(ring, t, k / 1e3, k / 1e3, k / 1e3, k / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_reads_the_window_only(ring, name):
    """The warm-up batch and the stray span are left out: the mean
    of the window's 1..4 ms is 2.5 ms in every part."""
    _window(ring, 4)
    layer = {"calls": 4, "trace": {}}
    assert _read(name, layer) == pytest.approx(2.5, abs=1e-3)


@pytest.mark.parametrize("name", READERS)
def test_takes_the_last_calls_batches(ring, name):
    _window(ring, 4)
    assert _read(name, {"calls": 2, "trace": {}}) == pytest.approx(
        3.5, abs=1e-3)


def test_dispatch_is_the_outer_span_less_its_stages(ring):
    _batch(ring, 10.0, 0.010, 0.002, 0.005, 0.040)
    batches = provider_spans.window_batches({"calls": 1, "trace": {}})
    assert batches[0]["dispatch"] == pytest.approx(0.040)
    assert batches[0]["provider_pack"] == pytest.approx(0.010)
    total = sum(_read(n, {"calls": 1, "trace": {}}) for n in READERS)
    assert total == pytest.approx(57.0)


@pytest.mark.parametrize("name", READERS)
def test_none_when_fewer_batches_than_calls(ring, name):
    _window(ring, 3, warm=False)
    assert _read(name, {"calls": 4, "trace": {}}) is None
    assert _read(name, {"calls": 3, "trace": {}}) is not None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace(ring, name):
    _window(ring, 3)
    assert _read(name, {"calls": 3}) is None
    assert _read(name, {"trace": {}}) is None
    assert _read(name, {}) is None


def test_none_when_a_window_batch_lacks_a_stage(ring):
    t = _batch(ring, 1e9, 1e-3, 1e-3, 1e-3, 1e-3)
    _batch(ring, t, 1e-3, 1e-3, 1e-3, 1e-3, complete=False)
    for name in READERS:
        assert _read(name, {"calls": 2, "trace": {}}) is None
        assert _read(name, {"calls": 1, "trace": {}}) is None


def test_none_on_a_program_without_the_ring(monkeypatch):
    from corda_tpu_torch.obs import trace

    monkeypatch.delattr(trace, "VERIFY")
    for name in READERS:
        assert _read(name, {"calls": 1, "trace": {}}) is None


def test_a_traced_tiny_run_reports_the_parts_of_its_calls():
    """On the CPU's plain versions: each part reads, and the four add up
    to the window's time a call (the outer span is the whole call)."""
    r = run_tiny("firehose.bulk", trace=True)
    assert r["correct"], r["checks"]
    parts = [r["metrics"][name]["value"] for name in READERS]
    assert all(p > 0 for p in parts)
    per_call = 1e3 * r["detail"]["window_s"] / r["detail"]["calls"]
    assert sum(parts) == pytest.approx(per_call, rel=0.05)
