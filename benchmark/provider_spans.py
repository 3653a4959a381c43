"""The provider's spans of a run's window, per batch: what the readers of
``provider.*_ms_per_batch.*`` share.

While the torch profiler collects, the program records four spans for each
``TorchVerifier`` batch that takes the device into its always-present ring
``corda_tpu_torch.obs.trace.VERIFY``, under one trace id a batch:
``provider_verify`` over the whole call, and under it ``provider_pack``,
``provider_copy_in`` and ``provider_device_wait``. The window's calls are
the last ``calls`` ``provider_verify`` spans: the warm-up call runs before
the profiler starts, and nothing after the window calls the program. A
program without the ring or the spans reads nothing.
"""

from __future__ import annotations

OUTER = "provider_verify"
STAGES = ("provider_pack", "provider_copy_in", "provider_device_wait")


def _snapshot():
    from corda_tpu_torch.obs import trace

    ring = getattr(trace, "VERIFY", None)
    return None if ring is None else ring.snapshot()


def window_batches(layer: dict):
    """[{span name: seconds}] of each of the window's calls, oldest first,
    ``"dispatch"`` being the outer span's time outside its three stages;
    None without a traced run's ``trace`` and ``calls``, or when the ring
    holds fewer than ``calls`` complete batches."""
    calls = layer.get("calls")
    if "trace" not in layer or not calls:
        return None
    spans = _snapshot()
    if spans is None:
        return None
    outers = [s for s in spans if s["name"] == OUTER][-calls:]
    if len(outers) < calls:
        return None
    children: dict = {}
    for s in spans:
        if s["name"] in STAGES:
            children.setdefault((s["trace_id"], s["parent"]), {})[
                s["name"]] = s["t_end"] - s["t_start"]
    out = []
    for o in outers:
        stages = children.get((o["trace_id"], o["span_id"]), {})
        if len(stages) != len(STAGES):
            return None
        total = o["t_end"] - o["t_start"]
        out.append(dict(stages, dispatch=total - sum(stages.values())))
    return out


def ms_per_batch(layer: dict, part: str):
    """Mean milliseconds a window call spent in ``part`` (a stage's span
    name, or ``"dispatch"``), or None (see :func:`window_batches`)."""
    batches = window_batches(layer)
    if batches is None:
        return None
    return 1e3 * sum(b[part] for b in batches) / len(batches)
