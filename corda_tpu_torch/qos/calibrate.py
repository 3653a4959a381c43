"""Measured-saturation admission calibration.

The port's own copy of ``corda_tpu/qos/calibrate.py``.

The admission rates were static TOML: an operator guessed each
lane's ceiling. This module closes the loop — it derives the
:class:`~corda_tpu_torch.qos.admission.AdmissionController` knobs from an
OBSERVED ``slo_sweep`` (tools/loadtest.run_slo_sweep), which already
measures, per offered rate, the per-lane committed throughput and the
interactive p99:

  * the **saturation rate** is the highest offered rate whose interactive
    p99 still met the SLO — one step past it the sweep measured the tail
    collapsing, so admitting that much again would break the SLO the
    controller exists to protect;
  * each lane's rate is its *measured committed share at the saturation
    point*, scaled by a safety factor (headroom for the calibration run
    and the protected run differing);
  * the bulk queue watermark follows Little's law: the backlog that can
    drain within one SLO window at the measured committed pace — any
    deeper and an interactive request admitted behind it has already
    missed its deadline while queued.

The output is a plain dict so it stamps straight into bench artifacts,
and :func:`apply_calibration` pushes it into a live controller via
``AdmissionController.reconfigure`` (each group of a sharded notary
calibrates from its own sweep — groups on asymmetric hosts get asymmetric
ceilings, which is the point).

Stdlib-only, like the rest of ``qos``.
"""

from __future__ import annotations

from .admission import AdmissionController

__all__ = ["calibrate_admission", "apply_calibration"]

# Floor under the Little's-law watermark: a watermark below the typical
# coalesce batch would shed bulk on ordinary micro-batch ripples.
MIN_WATERMARK = 8

# Floor under a derived lane rate: a sweep that measured ~0 committed for
# a lane (e.g. bulk_rate=0 in the calibration run) must not derive a
# 0-rate bucket, which means UNLIMITED to the token bucket — the one
# wrong direction. One tx/s keeps the lane alive but firmly capped.
MIN_RATE = 1.0


def _field(result, name: str, default: float = 0.0) -> float:
    """Read a lane result field from either a FirehoseResult-like object
    or a plain dict (bench artifacts round-trip through JSON)."""
    if isinstance(result, dict):
        value = result.get(name, default)
    else:
        value = getattr(result, name, default)
    try:
        return float(value)
    except (TypeError, ValueError):
        return float(default)


def calibrate_admission(results, slo_ms: float, safety: float = 0.8,
                        interactive_burst: float = 32.0,
                        bulk_burst: float = 32.0) -> dict:
    """Derive admission knobs from slo_sweep observations.

    ``results`` is the SweepResult.results mapping: offered rate ->
    {"interactive": lane-result, "bulk": lane-result} where a lane result
    carries at least ``p99_ms`` and ``tx_per_sec`` (object attributes or
    dict keys — JSON round-trips work).

    Scans offered rates in ascending order and stops at the first one
    whose interactive p99 misses ``slo_ms``: rates beyond a miss are past
    the knee, and a later rate that happens to sneak under the SLO again
    is measurement noise, not recovered capacity. Returns a dict with the
    derived knobs plus provenance — ``met_slo`` False means NO swept rate
    met the SLO and the calibration fell back to the lowest offered rate
    (maximally conservative; the operator should sweep lower).
    """
    saturation = None
    met_slo = False
    for rate in sorted(results):
        lanes = results[rate]
        inter = (lanes.get("interactive") if isinstance(lanes, dict)
                 else getattr(lanes, "interactive", None))
        if inter is None:
            continue
        if _field(inter, "p99_ms") <= float(slo_ms):
            saturation = rate
            met_slo = True
        else:
            break
    if saturation is None:
        rates = sorted(results)
        if not rates:
            raise ValueError("calibrate_admission: empty sweep results")
        saturation = rates[0]
    lanes = results[saturation]

    def lane(name):
        return (lanes.get(name) if isinstance(lanes, dict)
                else getattr(lanes, name, None))

    inter_tx = _field(lane("interactive"), "tx_per_sec")
    bulk_tx = _field(lane("bulk"), "tx_per_sec")
    total_tx = inter_tx + bulk_tx
    watermark = max(MIN_WATERMARK, int(total_tx * float(slo_ms) / 1e3))
    return {
        "interactive_rate": max(MIN_RATE, safety * inter_tx),
        "interactive_burst": float(interactive_burst),
        "bulk_rate": max(MIN_RATE, safety * bulk_tx),
        "bulk_burst": float(bulk_burst),
        "queue_watermark": watermark,
        # provenance — stamped into bench artifacts beside the knobs
        "saturation_rate": float(saturation),
        "measured_interactive_tx_per_sec": inter_tx,
        "measured_bulk_tx_per_sec": bulk_tx,
        "slo_ms": float(slo_ms),
        "safety": float(safety),
        "met_slo": met_slo,
    }


def apply_calibration(controller: AdmissionController,
                      calibration: dict) -> None:
    """Push calibrated knobs into a live controller (counters survive)."""
    controller.reconfigure(
        interactive_rate=calibration["interactive_rate"],
        interactive_burst=calibration.get("interactive_burst"),
        bulk_rate=calibration["bulk_rate"],
        bulk_burst=calibration.get("bulk_burst"),
        queue_watermark=calibration["queue_watermark"],
    )
