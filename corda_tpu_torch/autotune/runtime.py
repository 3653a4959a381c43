"""The autotune runtime leg: an opt-in, bounded controller thread that
feeds live telemetry ``round_breakdown`` deltas into the adaptive
policies that already exist — never a new optimizer in the hot path.

The contract, in order of importance:

  * **Off by default, bit-identical when disarmed.** A tuner built with
    ``armed=False`` (the default) constructs no thread, calls no
    snapshot function, touches no target — ``start()`` returns None and
    ``step()`` is a no-op. The running system with the leg disarmed is
    the running system without this module.
  * **Hard revert-on-regression.** The tuner scores each window as
    committed rounds per second of attributed wall (from the telemetry
    round profiler's snapshot deltas). A window that drops more than
    ``guard_pct`` below the best score seen counts one strike; after
    ``hysteresis`` consecutive strikes every target's ``revert()`` runs
    once, ``autotune_reverts_total`` increments, and the tuner latches
    disarmed — one bad tune never oscillates.
  * **Bounded.** The thread ticks at a fixed interval, stops on
    ``stop()`` or after the optional ``max_steps``, and only ever calls
    the injected targets — it owns no knob of its own.

Targets wrap the existing adaptive policies: :func:`coalesce_target`
rides the sidecar's own ``adaptive_coalesce`` window (PR 7) and reverts
by restoring the configured window via ``reset_window()``;
:func:`admission_target` applies a fresh ``calibrate_admission``
calibration to a live AdmissionController (PR 10) and reverts by
restoring the rates it saw at arm time. The clock is injected for
deterministic tests.

The port's own copy of ``corda_tpu/autotune/runtime.py``.
"""

from __future__ import annotations

import threading
import time

from ..obs import telemetry as _tm

__all__ = [
    "AdaptiveTarget",
    "RuntimeTuner",
    "admission_target",
    "coalesce_target",
]


class AdaptiveTarget:
    """One revert-able lever: ``observe(delta)`` feeds a window's
    breakdown delta into the underlying adaptive policy; ``revert()``
    restores the pre-arm state. Both injected so the tuner never knows
    subsystem internals."""

    def __init__(self, name: str, observe=None, revert=None):
        self.name = name
        self._observe = observe
        self._revert = revert

    def observe(self, delta: dict) -> None:
        if self._observe is not None:
            self._observe(delta)

    def revert(self) -> None:
        if self._revert is not None:
            self._revert()


def coalesce_target(server) -> AdaptiveTarget:
    """The sidecar's adaptive-coalesce policy already observes its own
    batches; the runtime leg's job is the guardrail — revert restores
    the configured window and zeroes the adaptation state."""
    return AdaptiveTarget("sidecar.adaptive_coalesce",
                          revert=server.reset_window)


def admission_target(controller, calibration: dict | None = None) -> AdaptiveTarget:
    """Apply a measured-saturation calibration (qos/calibrate) to a live
    AdmissionController once at arm time; revert restores the rates the
    controller carried before."""
    from ..qos import calibrate as _calibrate

    saved = controller.stats()

    def observe(_delta: dict) -> None:
        if calibration:
            _calibrate.apply_calibration(controller, calibration)

    def revert() -> None:
        controller.reconfigure(
            interactive_rate=saved.get("interactive_rate"),
            bulk_rate=saved.get("bulk_rate"),
            queue_watermark=saved.get("queue_watermark"))

    return AdaptiveTarget("qos.admission", observe=observe, revert=revert)


class RuntimeTuner:
    """The bounded loop. ``snapshot_fn() -> {"rounds": int, "wall_s":
    float}`` (telemetry round-profiler totals); scoring and the revert
    guard work on per-window DELTAS of that snapshot."""

    def __init__(self, snapshot_fn, targets=(), *, interval_s: float = 5.0,
                 guard_pct: float = 25.0, hysteresis: int = 2,
                 armed: bool = False, max_steps: int | None = None,
                 clock=time.monotonic):
        self.armed = bool(armed)
        self.reverted = False
        self.steps = 0
        self._snapshot_fn = snapshot_fn
        self._targets = tuple(targets)
        self._interval_s = float(interval_s)
        self._guard_pct = float(guard_pct)
        self._hysteresis = max(1, int(hysteresis))
        self._max_steps = max_steps
        self._clock = clock
        self._thread = None
        self._stop = threading.Event()
        self._last_snapshot = None
        self._best_score = None
        self._strikes = 0

    def start(self):
        """Spawn the tick thread — only when armed; disarmed start is a
        no-op returning None (the bit-identity contract)."""
        if not self.armed or self._thread is not None:
            return None
        self._thread = threading.Thread(
            target=self._run, name="autotune-runtime", daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval_s + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.step()
            if self.reverted or (self._max_steps is not None
                                 and self.steps >= self._max_steps):
                return

    def step(self) -> str:
        """One control tick (the thread calls this; tests call it
        directly). Returns what the tick did: "disarmed", "idle",
        "observed", or "reverted"."""
        if not self.armed or self.reverted:
            return "disarmed"
        snap = self._snapshot_fn() or {}
        last = self._last_snapshot
        self._last_snapshot = dict(snap)
        self.steps += 1
        if last is None:
            return "idle"
        rounds = (snap.get("rounds") or 0) - (last.get("rounds") or 0)
        wall = (snap.get("wall_s") or 0.0) - (last.get("wall_s") or 0.0)
        if rounds <= 0 or wall <= 0:
            return "idle"
        delta = {"rounds": rounds, "wall_s": wall}
        for target in self._targets:
            target.observe(delta)
        score = rounds / wall
        if self._best_score is None or score > self._best_score:
            self._best_score = score
            self._strikes = 0
            return "observed"
        if score < self._best_score * (1.0 - self._guard_pct / 100.0):
            self._strikes += 1
            if self._strikes >= self._hysteresis:
                for target in self._targets:
                    target.revert()
                _tm.inc("autotune_reverts_total")
                self.reverted = True
                self.armed = False
                return "reverted"
        else:
            self._strikes = 0
        return "observed"
