"""Admission control at the notarise entry point.

The port's own copy of ``corda_tpu/qos/admission.py``.

The QoS plane's third leg: priority lanes reorder work that is already
admitted; admission control keeps the backlog short enough that
reordering can still save the interactive p99. Policy, per request, at
``NotaryServiceFlow.call``:

  * every lane owns a token bucket (rate + burst; rate 0 = unlimited).
    An empty bucket sheds the request.
  * the BULK lane additionally sheds above a queue-depth watermark — when
    the notary's runnable backlog exceeds the watermark, bulk is turned
    away even with tokens in hand, because every admitted bulk step
    lengthens the queue interactive work must traverse.
  * interactive is never watermark-shed: its protection is its own bucket
    (operator-set ceiling), and the lanes' buckets are independent so a
    bulk flood can never starve interactive admission.

A shed becomes a retryable ``OverloadedError`` carrying ``retry_after_ms``
(time until the lane's bucket refills one token, bounded) — the client's
``notarise_with_retry`` backs off and retries, which under sustained
overload converts bulk load shedding into client-side pacing instead of
server-side queue collapse.

Unlabelled requests admit through the interactive bucket: arming QoS over
a tree that never marks a lane changes nothing (the interactive bucket
defaults to unlimited).
"""

from __future__ import annotations

import threading
import time

from ..obs import telemetry as _tm
from .context import LANE_BULK, LANE_INTERACTIVE

__all__ = ["AdmissionController", "TokenBucket"]

# Never tell a client to wait longer than this for one token; sustained
# overload is paced by repeated shed/retry rounds, not one giant sleep.
MAX_RETRY_AFTER_S = 2.0

# OverloadedError-spike detection for the flight recorder: this many
# sheds inside one sliding window triggers a (latched) "overload_spike"
# dump — the moment the controller starts turning work away in bulk is
# exactly the moment worth capturing, not reproducing.
SPIKE_WINDOW_S = 5.0
SPIKE_SHEDS = 50


class TokenBucket:
    """Classic token bucket; ``rate <= 0`` means unlimited (always
    admits). Not thread-safe on its own — the controller's lock covers
    refill + take."""

    def __init__(self, rate_per_s: float, burst: float):
        self.rate = float(rate_per_s)
        self.burst = max(1.0, float(burst)) if self.rate > 0 else 0.0
        self.tokens = self.burst
        self._t_last = time.monotonic()

    def try_take(self, now: float | None = None) -> bool:
        if self.rate <= 0:
            return True
        if now is None:
            now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until one token refills (post-``try_take`` estimate)."""
        if self.rate <= 0:
            return 0.0
        deficit = max(0.0, 1.0 - self.tokens)
        return min(MAX_RETRY_AFTER_S, deficit / self.rate)


class AdmissionController:
    """Per-lane token buckets + bulk queue-depth watermark."""

    def __init__(self, interactive_rate: float = 0.0,
                 interactive_burst: float = 32.0,
                 bulk_rate: float = 0.0, bulk_burst: float = 32.0,
                 queue_watermark: int = 0):
        self._lock = threading.Lock()
        self._buckets = {
            LANE_INTERACTIVE: TokenBucket(interactive_rate,
                                          interactive_burst),
            LANE_BULK: TokenBucket(bulk_rate, bulk_burst),
        }
        # Runnable-backlog ceiling above which bulk sheds; 0 disables.
        self.queue_watermark = int(queue_watermark)
        self.counters = {
            "admitted_interactive": 0,
            "admitted_bulk": 0,
            "shed_interactive": 0,
            "shed_bulk": 0,
            "watermark_sheds": 0,
        }
        # Shed-spike sliding window (flight recorder trigger state).
        self._spike_t0 = 0.0
        self._spike_n = 0

    def admit(self, lane: str, queue_depth: int = 0) -> float | None:
        """None when admitted; otherwise the suggested client retry-after
        in SECONDS (the shed verdict)."""
        if lane not in self._buckets:
            lane = LANE_INTERACTIVE
        with self._lock:
            bucket = self._buckets[lane]
            if (lane == LANE_BULK and self.queue_watermark > 0
                    and queue_depth > self.queue_watermark):
                self.counters["shed_bulk"] += 1
                self.counters["watermark_sheds"] += 1
                self._note_shed(queue_depth)
                # Depth drains at commit pace, not token pace: a short,
                # fixed pause is the honest hint.
                return min(MAX_RETRY_AFTER_S,
                           max(0.05, bucket.retry_after_s()))
            if bucket.try_take():
                self.counters[f"admitted_{lane}"] += 1
                if _tm.ACTIVE is not None:
                    _tm.inc("admission_admitted_total")
                return None
            self.counters[f"shed_{lane}"] += 1
            self._note_shed(queue_depth)
            return max(0.01, bucket.retry_after_s())

    def _note_shed(self, queue_depth: int) -> None:
        """Called under self._lock on every shed: count telemetry and
        detect an OverloadedError spike (>= SPIKE_SHEDS sheds within
        SPIKE_WINDOW_S) for the latched flight-recorder dump."""
        if _tm.ACTIVE is None:
            return
        _tm.inc("admission_shed_total")
        now = time.monotonic()
        if now - self._spike_t0 > SPIKE_WINDOW_S:
            self._spike_t0 = now
            self._spike_n = 0
        self._spike_n += 1
        if self._spike_n == SPIKE_SHEDS:
            # Latched inside the recorder: sustained overload dumps once.
            # trigger never raises and the artifact write happens at most
            # once per process, so doing it under the admission lock is a
            # bounded, once-ever cost.
            _tm.flight_trigger("overload_spike", extra={
                "window_s": SPIKE_WINDOW_S, "sheds_in_window": self._spike_n,
                "queue_depth": queue_depth, **self.counters})

    def reconfigure(self, interactive_rate: float | None = None,
                    interactive_burst: float | None = None,
                    bulk_rate: float | None = None,
                    bulk_burst: float | None = None,
                    queue_watermark: int | None = None) -> None:
        """Swap in new rates live (measured-saturation calibration: the
        rates come from an observed slo_sweep, qos/calibrate.py, not static
        TOML). Each lane's bucket is REPLACED, not mutated — a fresh bucket
        starts full at the new burst, so a recalibration never inherits a
        deficit accumulated under the old (possibly wrong) rate. ``None``
        keeps the current value for that knob; counters are preserved."""
        with self._lock:
            for lane, rate, burst in (
                    (LANE_INTERACTIVE, interactive_rate, interactive_burst),
                    (LANE_BULK, bulk_rate, bulk_burst)):
                if rate is None and burst is None:
                    continue
                old = self._buckets[lane]
                self._buckets[lane] = TokenBucket(
                    old.rate if rate is None else rate,
                    (old.burst or 32.0) if burst is None else burst)
            if queue_watermark is not None:
                self.queue_watermark = int(queue_watermark)

    def stats(self) -> dict:
        with self._lock:
            return {
                "queue_watermark": self.queue_watermark,
                "interactive_rate": self._buckets[LANE_INTERACTIVE].rate,
                "bulk_rate": self._buckets[LANE_BULK].rate,
                **self.counters,
            }
