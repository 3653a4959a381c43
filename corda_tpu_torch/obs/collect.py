"""Driver-side trace collection: merge per-node span snapshots into one
Chrome trace-event / Perfetto JSON artifact and compute the per-stage
latency breakdown the bench report embeds.

Input shape: each node contributes a *snapshot* — either the dict served by
``/api/trace`` (``{"node": ..., "spans": [...], "stats": {...}}``) or a bare
list of span dicts (SpanRecorder.snapshot()). Span dicts are the JSON-safe
form from trace.Span.as_dict(): hex ids, epoch-second timestamps.

Stage attribution
-----------------
Per-transaction stages come from two kinds of spans:

  * per-trace spans carry the transaction's own trace_id directly
    (``verify_wait``, the ``flow:*`` roots, ``raft_commit``, ``notary_process``);
  * batch spans (``queue_wait``, ``device_verify``, ``raft_append``,
    ``fsync``, ``replication``) carry ``attrs["member_traces"]`` — every
    transaction that rode the batch inherits the batch span's duration,
    which is the honest cost model: a tx in a 64-wide device batch *waited*
    the whole batch wall time.

``reply`` is derived, not measured: root_end − max(end of any other stage
span attributed to the trace), clipped at 0 — the tail between the last
instrumented stage finishing and the client flow completing (reply
serialization + transport + final client-side validation). Deriving it makes
the stage sum track end-to-end by construction instead of leaving an
unattributed gap.

The port's own copy of ``corda_tpu/obs/collect.py``. Trace events keep
``"cat": "corda_tpu"``, as ``obs/export.PREFIX`` keeps ``corda_tpu_``: one
trace viewer or dashboard reads both packages' runs.
"""

from __future__ import annotations

import json

# Attribution tables come from the span-name registry (obs/stages.py) so
# the breakdown can never drift from the names recording sites are allowed
# to use (the trace-stage-registry analyzer rule enforces the other side).
from .stages import BATCH_STAGES, DIRECT_STAGES, MARKER_SPANS, STAGES


def _spans_of(snapshot) -> list[dict]:
    if isinstance(snapshot, dict):
        return list(snapshot.get("spans") or ())
    return list(snapshot or ())


def _node_of(snapshot, default: str) -> str:
    if isinstance(snapshot, dict):
        return str(snapshot.get("node") or default)
    return default


# ---------------------------------------------------------------------------
# Chrome trace-event merge
# ---------------------------------------------------------------------------


def merge_chrome_trace(snapshots) -> dict:
    """Merge node snapshots into one Chrome trace-event JSON object
    (loadable in chrome://tracing and ui.perfetto.dev). Nodes become
    processes; span names become named threads within each process so
    overlapping batch spans get their own rows instead of nesting wrongly."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    for i, snapshot in enumerate(snapshots):
        node = _node_of(snapshot, f"node-{i}")
        for span in _spans_of(snapshot):
            span_node = str(span.get("node") or node)
            pid = pids.setdefault(span_node, len(pids) + 1)
            name = str(span.get("name") or "span")
            lane = name.split(":", 1)[0]
            tid = tids.setdefault((pid, lane), len(tids) + 1)
            t0 = float(span.get("t_start") or 0.0)
            t1 = float(span.get("t_end") or t0)
            args = dict(span.get("attrs") or {})
            args["trace_id"] = span.get("trace_id")
            if span.get("parent"):
                args["parent"] = span.get("parent")
            events.append({
                "ph": "X",
                "name": name,
                "cat": "corda_tpu",
                "ts": t0 * 1e6,          # chrome ts unit is microseconds
                "dur": max(0.0, (t1 - t0)) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            })
    meta: list[dict] = []
    for node, pid in pids.items():
        meta.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                     "args": {"name": node}})
    for (pid, lane), tid in tids.items():
        meta.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                     "args": {"name": lane}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, snapshots) -> dict:
    doc = merge_chrome_trace(snapshots)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# Per-stage latency breakdown
# ---------------------------------------------------------------------------


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def stage_breakdown(snapshots) -> dict:
    """p50/p99/mean milliseconds per stage across all complete traces.

    A trace is *complete* when it has a root flow span (parent None,
    name ``flow:*``) — the end-to-end anchor. Stage durations missing from a
    trace count as 0.0 so per-stage percentiles stay comparable and the
    stage sum tracks end-to-end."""
    spans: list[dict] = []
    for snapshot in snapshots:
        spans.extend(_spans_of(snapshot))

    # trace_id -> {"root": span | None, stage -> accumulated seconds,
    #              "last_end": latest attributed stage end}
    traces: dict[str, dict] = {}

    def slot(trace_id: str) -> dict:
        entry = traces.get(trace_id)
        if entry is None:
            entry = {"root": None, "stages": dict.fromkeys(STAGES, 0.0),
                     "last_end": 0.0}
            traces[trace_id] = entry
        return entry

    for span in spans:
        name = span.get("name") or ""
        t0 = float(span.get("t_start") or 0.0)
        t1 = float(span.get("t_end") or t0)
        dur = max(0.0, t1 - t0)
        if name in BATCH_STAGES:
            for member in (span.get("attrs") or {}).get("member_traces") or ():
                entry = slot(member)
                entry["stages"][name] += dur
                entry["last_end"] = max(entry["last_end"], t1)
            continue
        trace_id = span.get("trace_id")
        if not trace_id:
            continue
        if name in DIRECT_STAGES:
            entry = slot(trace_id)
            entry["stages"][name] += dur
            entry["last_end"] = max(entry["last_end"], t1)
        elif name.startswith("flow:") and not span.get("parent"):
            entry = slot(trace_id)
            root = entry["root"]
            if root is None or t0 < float(root.get("t_start") or 0.0):
                entry["root"] = span
        elif name in MARKER_SPANS:
            # Stitch markers, not breakdown stages — but their ends bound
            # the derived reply tail.
            entry = slot(trace_id)
            entry["last_end"] = max(entry["last_end"], t1)

    per_stage: dict[str, list[float]] = {s: [] for s in STAGES}
    end_to_end: list[float] = []
    complete = 0
    for entry in traces.values():
        root = entry["root"]
        if root is None:
            continue
        complete += 1
        root_t0 = float(root.get("t_start") or 0.0)
        root_t1 = float(root.get("t_end") or root_t0)
        end_to_end.append(max(0.0, root_t1 - root_t0))
        last_end = entry["last_end"]
        entry["stages"]["reply"] = (
            max(0.0, root_t1 - last_end) if last_end else 0.0)
        for stage in STAGES:
            per_stage[stage].append(entry["stages"][stage])

    def summarize(values: list[float]) -> dict:
        return {
            "p50_ms": _percentile(values, 0.50) * 1e3,
            "p99_ms": _percentile(values, 0.99) * 1e3,
            "mean_ms": (sum(values) / len(values) * 1e3) if values else 0.0,
        }

    stages_out = {stage: summarize(per_stage[stage]) for stage in STAGES}
    return {
        "traces": complete,
        "spans": len(spans),
        "stages": stages_out,
        "end_to_end": summarize(end_to_end),
        # How well the attribution covers the measured end-to-end: the sum
        # of per-stage means over the end-to-end mean (reply is derived, so
        # this approaches 1.0 as instrumentation coverage improves).
        # sidecar_wait/sidecar_verify DECOMPOSE device_verify (same wall
        # window), so they stay out of the sum — counting them would push
        # coverage past 1.0 whenever the sidecar is active. Same for
        # shard_reserve/shard_commit: the 2PC phases wrap the underlying
        # per-group raft stages, not extend them.
        "stage_sum_over_e2e": (
            (sum(v["mean_ms"] for k, v in stages_out.items()
                 if k not in ("sidecar_wait", "sidecar_verify",
                              "shard_reserve", "shard_commit"))
             / max(1e-9, summarize(end_to_end)["mean_ms"]))
            if end_to_end else 0.0),
    }
