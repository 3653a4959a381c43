"""Asynchronous pipelined verification: the verify pump's feeder thread.

The port's own copy of ``corda_tpu/crypto/async_verify.py``. The node's run
loop is single-threaded; this module gives it ONE owned crossing to the
verifier:

  run loop  --submit(jobs, context)-->  feeder thread  (owns the verifier)
  run loop  <--drain()---------------  completion queue (the only way back)

The run loop submits an accumulated batch and continues; the feeder thread
calls ``verifier.verify_batch`` (the GIL is released inside the native
host tier and while the card runs), and finished handles post to a
thread-safe completion queue that the next round drains. The feeder sees
only VerifyJob tuples and writes only to its own handle.

Bounded in-flight depth (default 2: one batch on the device, one filling)
lets batches accumulate across rounds without the backlog growing
unboundedly, which is what pushes real traffic over the device crossover.

Crash contract: a submitted batch lives only in memory. The waiting flows
were parked without a recorded outcome, so a crash replays them from their
last checkpoint and they verify again: lost in-flight results cost a
re-verify, never a wrong answer.

AdaptiveCrossover walks the verifier's effective crossover toward the tier
that is measured faster, from completed handles. Its one divergence from
the JAX package is documented on the class.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Sequence

from .provider import BatchVerifier, VerifyJob
from ..obs import trace as _obs
from ..testing import faults as _faults


class VerifyBatchHandle:
    """One submitted batch crossing the thread boundary. The submitting
    (run-loop) thread owns ``jobs``/``context``; the feeder thread fills
    ``ok``/``error``/timing and never touches the handle again after
    posting it to the completion queue."""

    __slots__ = ("jobs", "context", "submitted_at", "started_at",
                 "finished_at", "ok", "error", "tier")

    def __init__(self, jobs: Sequence[VerifyJob], context: Any):
        self.jobs = jobs
        self.context = context
        self.submitted_at = time.perf_counter()
        self.started_at = 0.0
        self.finished_at = 0.0
        self.ok = None  # bool[N] on success
        self.error: BaseException | None = None
        self.tier = "host"  # "device" when the verifier dispatched the kernel

    @property
    def queue_wait_s(self) -> float:
        """Time the batch sat behind earlier in-flight work."""
        return max(0.0, self.started_at - self.submitted_at)

    @property
    def verify_wall_s(self) -> float:
        """Wall time inside verify_batch on the feeder thread."""
        return max(0.0, self.finished_at - self.started_at)


class AdaptiveCrossover:
    """Tunes the verifier's effective device_min_sigs from OBSERVED rates.

    EWMA sigs/s per tier, fed at batch completion. With evidence on both
    tiers: a device measurably faster than the host lowers the crossover
    (feed it smaller batches); a device slower than the host raises it
    (stop paying the dispatch tax). Hysteresis bands (x1.25 up / x0.8
    down) and multiplicative steps keep it from oscillating; hard floor
    and ceiling keep a pathological sample from pinning routing.

    The one divergence from the JAX package: the floor is
    ``min(FLOOR, static device_min_sigs)``, not FLOOR. The JAX package's
    "device is faster" step sets ``max(FLOOR, current * 0.75)``, which from
    a static crossover under 64 RAISES it to 64 -- on an H100, whose
    measured crossover is 4 (provider.DEVICE_MIN_SIGS_DEFAULT), that would
    send batches of 4 to 63 signatures to a host tier the card beats.
    Bounded by the static value, the step never lifts the crossover above
    where the verifier started; from a static value of 64 or more every
    step is the JAX package's."""

    ALPHA = 0.3  # EWMA weight for the newest observation
    MIN_SAMPLE_SIGS = 32  # tiny batches measure overhead, not throughput
    FLOOR = 64

    def __init__(self, verifier: BatchVerifier):
        self.verifier = verifier
        static = getattr(verifier, "device_min_sigs", None)
        self.enabled = static is not None
        self.static_min_sigs = static if static else 0
        self.floor = min(self.FLOOR, self.static_min_sigs)
        self.ceiling = max(8 * (static or 0), 8192)
        self.host_rate = 0.0
        self.device_rate = 0.0
        self.adjustments = 0

    def observe(self, handle: VerifyBatchHandle) -> None:
        if not self.enabled or handle.error is not None:
            return
        n = len(handle.jobs)
        wall = handle.verify_wall_s
        if n < self.MIN_SAMPLE_SIGS or wall <= 0.0:
            return
        rate = n / wall
        if handle.tier == "device":
            self.device_rate = (rate if not self.device_rate else
                                self.ALPHA * rate
                                + (1 - self.ALPHA) * self.device_rate)
        else:
            self.host_rate = (rate if not self.host_rate else
                              self.ALPHA * rate
                              + (1 - self.ALPHA) * self.host_rate)
        self._retune()

    def _retune(self) -> None:
        if not (self.host_rate and self.device_rate):
            return  # no evidence on one tier yet: keep the static policy
        current = self.verifier.device_min_sigs
        if self.device_rate > 1.25 * self.host_rate:
            target = max(self.floor, int(current * 0.75))
        elif self.device_rate < 0.8 * self.host_rate:
            target = min(self.ceiling, int(current * 1.5))
        else:
            return
        if target != current:
            self.verifier.device_min_sigs = target
            self.adjustments += 1

    @property
    def effective_min_sigs(self) -> int | None:
        return (self.verifier.device_min_sigs if self.enabled else None)


_SENTINEL = object()


class AsyncVerifyService:
    """The feeder-thread pipeline between the run loop and the verifier.

    Threading model (the ONLY sanctioned crossings):
      * submit(): run loop -> submit queue. Increments the run-loop-owned
        in-flight counter (no lock needed: only the loop reads/writes it).
      * feeder thread: pops, calls verify_batch, posts the finished handle
        to the completion queue. It never touches flow or node state.
      * drain(): run loop pops completed handles non-blocking, decrements
        in-flight, feeds the adaptive crossover, returns the handles for
        delivery on the loop.

    The feeder thread starts lazily on first submit (an idle node never
    carries a thread) and is a daemon joined with a bounded timeout at
    close(), so close never hangs on a wedged device.
    """

    def __init__(self, verifier: BatchVerifier, depth: int = 2,
                 adaptive: bool = True):
        if depth < 1:
            raise ValueError(f"async verify depth must be >= 1, got {depth}")
        self.verifier = verifier
        self.depth = depth
        self.adaptive = AdaptiveCrossover(verifier) if adaptive else None
        self._submit_q: queue.SimpleQueue = queue.SimpleQueue()
        self._done_q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._closed = False
        # Run-loop-owned (single-threaded) pipeline accounting:
        self.in_flight = 0
        self.submitted_batches = 0
        self.submitted_sigs = 0
        self.completed_batches = 0
        self.completed_sigs = 0
        self.failed_batches = 0
        self.queue_wait_s = 0.0
        self.verify_wall_s = 0.0

    # -- run-loop side -----------------------------------------------------

    def can_submit(self) -> bool:
        """Is there pipeline room? False = keep accumulating this round."""
        return not self._closed and self.in_flight < self.depth

    def target_sigs(self, max_sigs: int) -> int:
        """The submit threshold for the accumulate-across-rounds gate: a
        READY device verifier wants batches at the (possibly adaptively
        tuned) crossover so submitted work actually engages the kernel;
        everything else keeps the classic max_sigs policy. The max-wait
        deadline still bounds accumulation either way."""
        min_sigs = getattr(self.verifier, "device_min_sigs", None)
        if min_sigs is None:
            return max_sigs
        gate = getattr(self.verifier, "device_gate", None)
        if gate is not None and not gate.is_set():
            return max_sigs  # cold device: batches host-route anyway
        return max(1, min(max_sigs, min_sigs))

    def submit(self, jobs: Sequence[VerifyJob], context: Any) -> VerifyBatchHandle:
        if self._closed:
            raise RuntimeError("AsyncVerifyService is closed")
        handle = VerifyBatchHandle(jobs, context)
        self.in_flight += 1
        self.submitted_batches += 1
        self.submitted_sigs += len(jobs)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._feeder, daemon=True, name="verify-feeder")
            self._thread.start()
        self._submit_q.put(handle)
        return handle

    def drain(self) -> list[VerifyBatchHandle]:
        """Pop every completed handle (non-blocking); caller delivers."""
        done: list[VerifyBatchHandle] = []
        while True:
            try:
                handle = self._done_q.get_nowait()
            except queue.Empty:
                break
            self.in_flight -= 1
            self.completed_batches += 1
            self.completed_sigs += len(handle.jobs)
            self.queue_wait_s += handle.queue_wait_s
            self.verify_wall_s += handle.verify_wall_s
            if handle.error is not None:
                self.failed_batches += 1
            elif self.adaptive is not None:
                self.adaptive.observe(handle)
            if _obs.ACTIVE is not None:
                self._record_batch_spans(handle)
            done.append(handle)
        return done

    def _record_batch_spans(self, handle: VerifyBatchHandle) -> None:
        """queue_wait + device_verify batch spans, fanned IN: one device
        batch serves many transactions, so the spans carry every member
        flow's trace id (attrs["member_traces"]) and the collector
        attributes the batch's wall time to each of them. The handle's
        perf_counter durations are re-anchored onto the epoch clock ending
        at drain time (the skew — the sub-ms the handle sat in the done
        queue — is noise next to a device batch)."""
        members = []
        for ctx in handle.context or ():
            fsm = ctx[0] if isinstance(ctx, tuple) else ctx
            tid = getattr(fsm, "trace_id", None)
            if tid is not None:
                members.append(tid.hex())
        if not members:
            return
        now = _obs.now()
        wall = handle.verify_wall_s
        wait = handle.queue_wait_s
        attrs = {"member_traces": members, "tier": handle.tier,
                 "sigs": len(handle.jobs)}
        _obs.record("queue_wait", now - wall - wait, now - wall, attrs=attrs)
        _obs.record("device_verify", now - wall, now, attrs=attrs)
        route_s = getattr(self.verifier, "last_route_s", None)
        if handle.tier == "device" and route_s is not None:
            # Federation tier: decompose the device window into the
            # routing decision and the winning host's round trip (which
            # itself contains that host's sidecar_wait/sidecar_verify).
            # Same newest-reply skew caveat as the sidecar spans below.
            route_s = min(float(route_s), wall)
            remote_s = min(float(getattr(self.verifier, "last_remote_s",
                                         0.0) or 0.0), wall)
            _obs.record("federation_route", now - wall,
                        now - wall + route_s, attrs=attrs)
            _obs.record("remote_verify", now - remote_s, now, attrs=attrs)
        sc_wait = getattr(self.verifier, "last_wait_s", None)
        if handle.tier == "device" and sc_wait is not None:
            # Sidecar tier: split the batch's device window into the
            # server-side coalesce wait and verify wall reported in the
            # newest reply (same fan-in attrs). With depth>1 the newest
            # reply can belong to a sibling batch — sub-ms skew on spans
            # whose job is attribution, not timing truth.
            sc_verify = float(getattr(self.verifier, "last_verify_s", 0.0)
                              or 0.0)
            sc_wait = min(float(sc_wait), max(wall - sc_verify, 0.0))
            _obs.record("sidecar_wait", now - wall, now - wall + sc_wait,
                        attrs=attrs)
            _obs.record("sidecar_verify", now - sc_verify, now, attrs=attrs)

    def stats(self) -> dict:
        """Pipeline counters for node_metrics / loadtest stamps."""
        out = {
            "depth": self.depth,
            "in_flight": self.in_flight,
            "submitted_batches": self.submitted_batches,
            "submitted_sigs": self.submitted_sigs,
            "completed_batches": self.completed_batches,
            "completed_sigs": self.completed_sigs,
            "failed_batches": self.failed_batches,
            "queue_wait_s": round(self.queue_wait_s, 6),
            "verify_wall_s": round(self.verify_wall_s, 6),
        }
        if self.adaptive is not None and self.adaptive.enabled:
            out["effective_min_sigs"] = self.adaptive.effective_min_sigs
            out["static_min_sigs"] = self.adaptive.static_min_sigs
            out["adaptive_adjustments"] = self.adaptive.adjustments
            out["host_sigs_per_sec"] = round(self.adaptive.host_rate, 1)
            out["device_sigs_per_sec"] = round(self.adaptive.device_rate, 1)
        return out

    def close(self, timeout: float = 30.0) -> bool:
        """Stop accepting work and join the feeder (bounded — close must
        never hang on a wedged device). Returns True when the thread is
        down (or never started). In-flight results may be lost; the
        at-least-once replay contract makes that safe."""
        self._closed = True
        thread = self._thread
        if thread is None:
            return True
        self._submit_q.put(_SENTINEL)
        thread.join(timeout=timeout)
        return not thread.is_alive()

    # -- feeder side -------------------------------------------------------

    def _feeder(self) -> None:
        while True:
            item = self._submit_q.get()
            if item is _SENTINEL:
                return
            item.started_at = time.perf_counter()
            # Tier attribution by counter delta: this thread is the only
            # verify_batch caller in async mode, so the delta is exact.
            before = getattr(self.verifier, "device_batches", 0) or 0
            try:
                if _faults.ACTIVE is not None:
                    act = _faults.ACTIVE.fire("verify.device")
                    if act is not None:
                        action, delay_s = act
                        if action == "slow" and delay_s > 0:
                            time.sleep(delay_s)
                        elif action in ("fail", "raise"):
                            raise RuntimeError(
                                "fault injected: device verifier failure")
                item.ok = self.verifier.verify_batch(item.jobs)
            except BaseException as e:  # noqa: BLE001 — crossed to the loop
                # The exception must cross back to the run loop and reject
                # the waiting flows; swallowing it would hang them forever.
                item.error = e
            after = getattr(self.verifier, "device_batches", 0) or 0
            item.tier = "device" if after > before else "host"
            item.finished_at = time.perf_counter()
            self._done_q.put(item)
