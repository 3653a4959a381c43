"""Prometheus text exposition + the cluster collector.

The port's own copy of ``corda_tpu/obs/export.py``. ``PREFIX`` is the JAX
package's ``corda_tpu_`` byte for byte, so one scraper reads the metrics of
either package's sidecar (``OP_METRICS``) under the same series names.

The registry (obs/telemetry.py) stores; this module ships. Three
surfaces share the one renderer:

  * ``GET /metrics`` on every node webserver (node/webserver.py),
  * ``OP_METRICS`` on the sidecar stats port (crypto/sidecar.py),
  * ``collect_cluster`` — the harness-side collector that merges
    per-node registry snapshots into one cluster view for
    loadtest/bench artifacts.

Render format is Prometheus text exposition 0.0.4: ``# TYPE`` lines,
cumulative ``_bucket{le="..."}`` series ending in ``+Inf``, ``_sum`` and
``_count`` per histogram. ``parse_prometheus`` is the exact inverse for
the subset this renderer emits — it exists so tests (and
bench_telemetry's self-check) can prove the endpoint serves every
registered metric in valid form without a real Prometheus binary in the
container.
"""

from __future__ import annotations

import json
import struct
import urllib.request

from . import telemetry

__all__ = [
    "collect_cluster",
    "fetch_sidecar_metrics",
    "merge_snapshots",
    "parse_prometheus",
    "render_prometheus",
    "scrape",
]

PREFIX = "corda_tpu_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """Integral floats render as integers (Prometheus accepts either;
    integral keeps counter lines greppable)."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def render_prometheus(reg=None, prefix: str = PREFIX) -> str:
    """The active registry (or a snapshot dict from
    ``TelemetryRegistry.snapshot()``) as exposition text. Every
    registered metric is always present — a counter that never fired
    still exports 0, so dashboards never see series flap in and out."""
    if reg is None:
        reg = telemetry.ACTIVE
    if reg is None:
        return "# telemetry disarmed\n"
    snap = reg if isinstance(reg, dict) else reg.snapshot()
    out: list[str] = []
    for name in sorted(snap.get("counters", {})):
        value = snap["counters"][name]
        full = prefix + name
        out.append(f"# TYPE {full} counter")
        out.append(f"{full} {_fmt(float(value))}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        full = prefix + name
        scale = h.get("scale", 1)
        buckets = {int(i): n for i, n in (h.get("buckets") or {}).items()}
        out.append(f"# TYPE {full} histogram")
        run = 0
        for idx in sorted(buckets):
            run += buckets[idx]
            le = (1 << idx) / scale
            out.append(f'{full}_bucket{{le="{_fmt(float(le))}"}} {run}')
        out.append(f'{full}_bucket{{le="+Inf"}} {h.get("count", 0)}')
        out.append(f"{full}_sum {_fmt(float(h.get('sum', 0.0)))}")
        out.append(f"{full}_count {h.get('count', 0)}")
    return "\n".join(out) + "\n"


def parse_prometheus(text: str, prefix: str = PREFIX) -> dict:
    """Inverse of ``render_prometheus`` for the subset it emits ->
    {"counters": {name: value}, "histograms": {name: {"count", "sum",
    "buckets": [(le, cumulative_count), ...]}}}. Raises ValueError on a
    malformed sample line — that IS the validity check the tests rely
    on."""
    counters: dict = {}
    hists: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed sample line: {line!r}")
        value = float(value_part)  # ValueError on garbage = the check
        label = None
        if "{" in name_part:
            name_part, _, rest = name_part.partition("{")
            body = rest.rstrip("}")
            key, _, raw = body.partition("=")
            if key != "le":
                raise ValueError(f"unexpected label in {line!r}")
            label = raw.strip('"')
        if not name_part.startswith(prefix):
            raise ValueError(f"unprefixed metric: {line!r}")
        short = name_part[len(prefix):]
        if label is not None:
            base = short[:-len("_bucket")]
            le = float("inf") if label == "+Inf" else float(label)
            hists.setdefault(base, {"count": 0, "sum": 0.0,
                                    "buckets": []})
            hists[base]["buckets"].append((le, int(value)))
        elif short.endswith("_sum") and \
                types.get(name_part[:-len("_sum")]) == "histogram":
            base = short[:-len("_sum")]
            hists.setdefault(base, {"count": 0, "sum": 0.0,
                                    "buckets": []})
            hists[base]["sum"] = value
        elif short.endswith("_count") and \
                types.get(name_part[:-len("_count")]) == "histogram":
            base = short[:-len("_count")]
            hists.setdefault(base, {"count": 0, "sum": 0.0,
                                    "buckets": []})
            hists[base]["count"] = int(value)
        else:
            counters[short] = value
    for base, h in hists.items():
        les = [le for le, _ in h["buckets"]]
        if les != sorted(les) or not les or les[-1] != float("inf"):
            raise ValueError(
                f"histogram {base!r}: buckets not cumulative-ordered "
                "or missing +Inf")
        cums = [c for _, c in h["buckets"]]
        if cums != sorted(cums):
            raise ValueError(f"histogram {base!r}: non-monotonic buckets")
    return {"counters": counters, "histograms": hists}


# ---------------------------------------------------------------------------
# Cluster collection
# ---------------------------------------------------------------------------


def merge_snapshots(snapshots: list[dict]) -> dict:
    """Fold per-node ``TelemetryRegistry.snapshot()`` dicts into one:
    counters sum; histograms merge bucket-wise (the sparse power-of-two
    indices align across processes by construction, so the merge is
    exact, not approximate)."""
    out = {"counters": {}, "histograms": {}}
    for snap in snapshots:
        if not snap:
            continue
        for name, v in (snap.get("counters") or {}).items():
            out["counters"][name] = out["counters"].get(name, 0.0) + v
        for name, h in (snap.get("histograms") or {}).items():
            m = out["histograms"].setdefault(
                name, {"count": 0, "sum": 0.0,
                       "scale": h.get("scale", 1), "buckets": {}})
            m["count"] += h.get("count", 0)
            m["sum"] = round(m["sum"] + h.get("sum", 0.0), 9)
            for idx, n in (h.get("buckets") or {}).items():
                m["buckets"][idx] = m["buckets"].get(idx, 0) + n
    for h in out["histograms"].values():
        h["buckets"] = {i: h["buckets"][i]
                        for i in sorted(h["buckets"], key=int)}
    return out


def collect_cluster(snapshots: dict[str, dict | None]) -> dict:
    """{node_name: snapshot-or-None} -> {"nodes": per-node, "merged":
    the cluster fold, "missing": nodes that served nothing} — the shape
    loadtest/bench embed in artifacts."""
    present = {k: v for k, v in snapshots.items() if v}
    return {
        "nodes": present,
        "missing": sorted(k for k, v in snapshots.items() if not v),
        "merged": merge_snapshots(list(present.values())),
    }


def scrape(url: str, timeout: float = 5.0) -> dict:
    """GET a /metrics endpoint and parse it — the HTTP half of the
    collector (nodes with a webserver)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_prometheus(resp.read().decode())


def fetch_sidecar_metrics(address: str, timeout: float = 2.0) -> str:
    """One-shot OP_METRICS round trip on a fresh connection: the
    sidecar's stats port speaks frames, not HTTP, so its Prometheus
    text rides the same framing OP_STATS uses. Returns the exposition
    text; raises the client's SidecarError when unreachable (same
    contract as fetch_sidecar_stats)."""
    from ..crypto import sidecar as wire
    from ..node.verify_client import SidecarError

    try:
        sock = wire.connect(address, timeout=timeout)
        try:
            sock.settimeout(timeout)
            wire.send_frame(sock, wire._REQ_HDR.pack(wire.OP_METRICS, 1))
            payload = wire.recv_frame(sock)
            op, _, status = wire._REPLY_HDR.unpack_from(payload)
            if op != wire.OP_METRICS or status != wire.STATUS_OK:
                raise ValueError("bad sidecar metrics reply")
            return payload[wire._REPLY_HDR.size:].decode()
        finally:
            try:
                sock.close()
            except OSError:
                pass
    except (OSError, ConnectionError, ValueError, struct.error,
            json.JSONDecodeError) as exc:
        raise SidecarError(f"sidecar {address}: {exc}") from exc
