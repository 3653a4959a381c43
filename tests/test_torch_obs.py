"""The port's observability copies (corda_tpu_torch/obs/) held to the JAX
package's: the same seeded metric traffic gives equal registry snapshots,
byte-equal Prometheus text (the ``corda_tpu_`` prefix kept), the same
parse and merge results, and the same span recorder behaviour. Exact
comparisons: everything here is integers, strings and recorded floats.
"""

import json
import random

import pytest

from corda_tpu.obs import export as jexport
from corda_tpu.obs import telemetry as jtm
from corda_tpu.obs import trace as jtrace
from corda_tpu_torch.obs import export, telemetry, trace


def _traffic(seed: int):
    """A seeded sequence of (kind, name, value) metric updates over every
    registered name."""
    rng = random.Random(seed)
    ops = []
    for _ in range(400):
        kind = rng.choice(("inc", "observe", "round"))
        if kind == "inc":
            ops.append(("inc", rng.choice(telemetry.COUNTER_NAMES),
                        rng.choice((1.0, 2.0, rng.random() * 10))))
        elif kind == "observe":
            name = rng.choice(telemetry.HISTOGRAM_NAMES)
            value = (rng.random() * 0.5 if name.endswith("_seconds")
                     else rng.randrange(0, 70000))
            ops.append(("observe", name, value))
        else:
            ops.append(("round", rng.random() * 0.1,
                        {p: rng.random() * 0.01
                         for p in telemetry.ROUND_PHASES}))
    return ops


def _apply(reg, ops):
    for kind, a, b in ops:
        if kind == "inc":
            reg.counter(a).add(b)
        elif kind == "observe":
            reg.histogram(a).observe(b)
        else:
            reg.observe_round(a, b)
    return reg


def test_metric_names_equal_jax():
    assert telemetry.COUNTER_NAMES == jtm.COUNTER_NAMES
    assert telemetry.HISTOGRAM_NAMES == jtm.HISTOGRAM_NAMES
    assert telemetry.ROUND_PHASES == jtm.ROUND_PHASES
    assert telemetry.FLIGHT_ENV == jtm.FLIGHT_ENV
    assert export.PREFIX == jexport.PREFIX == "corda_tpu_"
    assert export.CONTENT_TYPE == jexport.CONTENT_TYPE


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_snapshot_equal_to_jax(seed):
    ops = _traffic(seed)
    ours = _apply(telemetry.TelemetryRegistry(), ops).snapshot()
    theirs = _apply(jtm.TelemetryRegistry(), ops).snapshot()
    assert ours == theirs
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)


@pytest.mark.parametrize("seed", [4, 5])
def test_render_prometheus_byte_equal_to_jax(seed):
    ops = _traffic(seed)
    ours = _apply(telemetry.TelemetryRegistry(), ops)
    theirs = _apply(jtm.TelemetryRegistry(), ops)
    text = export.render_prometheus(ours)
    assert text == jexport.render_prometheus(theirs)
    # Either package renders the other's snapshot dict the same way.
    assert text == export.render_prometheus(theirs.snapshot())
    assert text == jexport.render_prometheus(ours.snapshot())
    for name in telemetry.METRIC_NAMES:
        assert f"corda_tpu_{name}" in text


def test_parse_prometheus_round_trip():
    reg = _apply(telemetry.TelemetryRegistry(), _traffic(6))
    snap = reg.snapshot()
    text = export.render_prometheus(reg)
    parsed = export.parse_prometheus(text)
    assert parsed == jexport.parse_prometheus(text)
    assert set(parsed["counters"]) == set(snap["counters"])
    for name, value in snap["counters"].items():
        assert parsed["counters"][name] == pytest.approx(value, abs=1e-9)
    for name, h in snap["histograms"].items():
        p = parsed["histograms"][name]
        assert p["count"] == h["count"]
        assert p["sum"] == pytest.approx(h["sum"], abs=1e-9)
        assert p["buckets"][-1] == (float("inf"), h["count"])
    with pytest.raises(ValueError):
        export.parse_prometheus("corda_tpu_x not-a-number\n")
    with pytest.raises(ValueError):
        export.parse_prometheus("other_prefix_x 1\n")


def test_disarmed_registry_renders_the_marker_and_ignores_updates():
    try:
        telemetry.disarm()
        assert export.render_prometheus() == "# telemetry disarmed\n"
        telemetry.inc("sidecar_requests_total")  # a no-op, not an error
        assert telemetry.snapshot() is None
    finally:
        telemetry.arm()
    assert telemetry.snapshot()["counters"]["sidecar_requests_total"] == 0
    with pytest.raises(ValueError, match="not registered"):
        telemetry.inc("no_such_metric_total")


def test_merge_and_collect_equal_jax():
    snaps = [_apply(telemetry.TelemetryRegistry(), _traffic(s)).snapshot()
             for s in (7, 8, 9)]
    assert export.merge_snapshots(snaps) == jexport.merge_snapshots(snaps)
    nodes = {"a": snaps[0], "b": None, "c": snaps[2]}
    assert export.collect_cluster(nodes) == jexport.collect_cluster(nodes)


def test_histogram_quantile_equal_jax():
    ours, theirs = (mod.Histogram("sidecar_batch_sigs")
                    for mod in (telemetry, jtm))
    rng = random.Random(10)
    for _ in range(500):
        v = rng.randrange(1, 65536)
        ours.observe(v)
        theirs.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)


def test_flight_recorder_dumps_once_per_reason(tmp_path):
    reg = telemetry.arm()
    try:
        flight = telemetry.ensure_flight(str(tmp_path), node="n1")
        assert flight is telemetry.ensure_flight()  # idempotent
        flight.tick({"x": 1, "y": 2.5})
        flight.tick({"x": 4, "y": 2.5})
        flight.note("slo", p99_ms=12.0)
        path = telemetry.flight_trigger("slo_breach", spans=[])
        assert path and telemetry.flight_trigger("slo_breach") == path
        with open(path) as f:
            art = json.load(f)
        assert art["reason"] == "slo_breach" and art["node"] == "n1"
        assert art["window"][1]["delta"] == {"x": 3, "y": 0.0}
        assert reg.counters["flight_dumps_total"].value == 1
        assert sorted(art) == sorted(
            ("reason", "ts", "node", "pid", "window", "metrics", "spans",
             "extra"))
    finally:
        telemetry.arm()


def test_span_recorder_equal_to_jax():
    ours, theirs = trace.SpanRecorder("n", capacity=4), \
        jtrace.SpanRecorder("n", capacity=4)
    for k in range(7):
        kw = dict(trace_id=bytes([k]) * 8, span_id=bytes([k + 1]) * 8,
                  parent=None if k % 2 else bytes([9]) * 8,
                  attrs={"sigs": k})
        ours.record(f"s{k}", float(k), k + 0.5, **kw)
        theirs.record(f"s{k}", float(k), k + 0.5, **kw)
    assert ours.snapshot() == theirs.snapshot()
    assert [s["name"] for s in ours.snapshot()] == ["s3", "s4", "s5", "s6"]
    assert ours.stats() == theirs.stats()
    ours.register_link(b"r", b"t" * 8, b"s" * 8)
    assert ours.pop_link(b"r") == (b"t" * 8, b"s" * 8)
    assert ours.pop_link(b"r") is None


def test_trace_arming_and_context():
    try:
        assert trace.record("x", 0.0, 1.0) is None  # disarmed: a no-op
        rec = trace.arm("node-a", capacity=8)
        assert trace.ACTIVE is rec
        span = trace.record("device_verify", 1.0, 2.0, attrs={"tier": "d"})
        assert span.node == "node-a" and len(span.trace_id) == 8
        trace.set_context(b"t" * 8, b"s" * 8)
        assert trace.get_context() == (b"t" * 8, b"s" * 8)
    finally:
        trace.disarm()
    assert trace.ACTIVE is None and trace.get_context() is None


def test_trace_arm_from_env(monkeypatch):
    try:
        monkeypatch.setenv(trace.ENV_VAR, "32")
        assert trace.arm_from_env("n").capacity == 32
        monkeypatch.setenv(trace.ENV_VAR, "junk")
        assert trace.arm_from_env("n") is None
    finally:
        trace.disarm()
    assert trace.ENV_VAR == jtrace.ENV_VAR


def test_format_breakdown_equal_jax():
    rng = random.Random(12)
    rp = {p: rng.random() for p in telemetry.ROUND_PHASES}
    rp.update(wall=sum(rp.values()) * 1.05, rounds=7, overlap_apply=0.2)
    assert telemetry.format_breakdown(rp) == jtm.format_breakdown(rp)
    assert telemetry.format_breakdown({"rounds": 0}) is None
