"""FederatedVerifier — the multi-host router over per-host sidecars.

The port's own copy of ``corda_tpu/crypto/federation.py``. What differs:
as everywhere in the port, no environment variable sets a default —
``device_min_sigs``, ``hedge_ms`` and ``reprobe_cooldown_s`` are
constructor arguments with the reference's defaults — and each host is
this package's ``SidecarVerifier`` (which talks to either package's
sidecar server).

One ``SidecarServer`` (crypto/sidecar.py) owns the device(s) of ONE host;
every node process on that host feeds it so micro-batches
coalesce across processes. This module adds the missing scale axis —
chips -> hosts: a router that owns N ``SidecarVerifier`` channels, one
per host-local sidecar, and spreads verify batches across them.

Why this scales near-linearly even before real multi-host hardware: each
channel serialises ONE framed round trip at a time (the client
``_io_lock``), and a sidecar's deadline scheduler anchors its coalesce
window on the oldest pending request — so a single-host feed is
window-limited (cycle = coalesce window + verify), not CPU-limited. K
federation channels run K windows CONCURRENTLY; aggregate sigs/s grows
with K until the verify work itself saturates the host(s). On one box
with K simulated hosts (the bench harness) that is latency-hiding; on a
real pod each channel's verify also lands on its own chips and the same
router is the seam (SNIPPETS [2]: "on multi-process platforms such as
TPU pods, pjit can be used to run computations across all available
devices across processes").

Routing policy (deterministic, so tests drive it directly):

  * interactive / unlabelled batches go to the healthy host with the
    LEAST client-tracked in-flight signatures — the earliest-served
    window, which is what an interactive deadline wants;
  * bulk batches (by their QoS lane hint) COALESCE-STICK: prefer the
    healthy host already holding the most in-flight work below a cap,
    so bulk rides an already-open coalesce window instead of opening a
    fresh one on an idle host (bulk may wait; interactive may not);
  * ties break on channel index — two equal depths can never flap a
    test.

Hedged re-dispatch: a primary that has not answered within ``hedge_ms``
gets ONE secondary dispatch on the next-ranked healthy host; first
answer wins, the loser's verdicts are discarded (verification is pure —
a duplicate answer is identical, never double-applied). Hedges are
counted per host and globally (``federation_hedges_total``).

Failure policy — the sidecar contract, federated:

  * a channel failure quarantines THAT host (per-host gate + cooldown
    ping re-probe that re-admits it); the failed batch answers from
    the oracle-exact local host tier and every SUBSEQUENT batch routes
    around the quarantined host — the answer is always exact.
  * only when NO healthy host remains does ``_verify_ed25519`` demote
    the whole federation tier through ``provider.degrade_device`` (gate
    + cooldown re-probe via ``_verify_ed25519_device``, which re-opens
    as soon as ANY re-admitted host answers) and serve the batch from
    the oracle-exact local host tier. Infra faults degrade; they never
    reject and never produce a wrong answer.
  * ``_verify_ed25519_device`` therefore RAISES on total failure — the
    same raise-don't-fallback rule verify_client.py documents, because
    the degrade re-probe interprets "no exception" as healthy.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..obs import telemetry as _tm
from .provider import (CpuVerifier, DeviceRoutedVerifier, VerifyJob,
                       degrade_device)
from ..node.verify_client import (SIDECAR_MIN_SIGS_DEFAULT, SidecarError,
                                  SidecarVerifier)
from .sidecar import LANE_CODE_BULK

# Re-dispatch threshold: a primary slower than this is hedged on the
# next healthy host. Generous by default — a hedge costs a duplicate
# verify, so it should fire on a sick host, not on an ordinary coalesce
# window (which the deadline scheduler bounds well under a second).
FEDERATION_HEDGE_MS_DEFAULT = 1000.0

# A bulk batch sticks to the busiest open window only while that host's
# in-flight backlog stays under this many signatures; above it the
# window is full enough and bulk spreads like interactive traffic.
BULK_STICK_CAP_SIGS = 8192

# Per-host quarantine re-probe cadence (ping over a fresh frame).
HOST_REPROBE_COOLDOWN_S_DEFAULT = 5.0

# Bounded routing-decision ring for the flight recorder: enough to show
# the routing shape at an SLO breach, small enough to ride a stamp.
ROUTING_RING = 64


class HostChannel:
    """One host's sidecar channel plus the router's bookkeeping for it.

    ``in_flight_sigs`` is the client-tracked queue depth routing ranks
    on — signatures dispatched to this host and not yet answered
    (including callers parked on the channel's ``_io_lock``). Mutated
    only under the router lock; the counters are monitoring-grade."""

    def __init__(self, index: int, client):
        self.index = index
        self.client = client
        self.address = client.address
        self.healthy = threading.Event()
        self.healthy.set()
        self.in_flight_sigs = 0
        self.in_flight_batches = 0
        self.dispatches = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.failures = 0
        self.quarantines = 0
        self.readmits = 0
        self.rpc_s_total = 0.0
        self._reprobe_thread: threading.Thread | None = None

    def stats(self) -> dict:
        return {
            "address": self.address,
            "healthy": self.healthy.is_set(),
            "in_flight_sigs": self.in_flight_sigs,
            "in_flight_batches": self.in_flight_batches,
            "dispatches": self.dispatches,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "failures": self.failures,
            "quarantines": self.quarantines,
            "readmits": self.readmits,
            "rpc_s_total": round(self.rpc_s_total, 6),
            "server": self.client._server_stats_maybe(),
        }


class FederatedVerifier(DeviceRoutedVerifier):
    """Routes verify batches across N host-local sidecars (module doc)."""

    name = "federation"  # like "sidecar": must NOT start with "jax"

    def __init__(self, hosts: Sequence[str], deadline_ms: float = 2000.0,
                 device_min_sigs: int = SIDECAR_MIN_SIGS_DEFAULT,
                 hedge_ms: float = FEDERATION_HEDGE_MS_DEFAULT,
                 connect_timeout_s: float = 1.0,
                 reprobe_cooldown_s: float = HOST_REPROBE_COOLDOWN_S_DEFAULT,
                 devices: int | None = None):
        if not hosts:
            raise ValueError("federation needs at least one host address")
        super().__init__(device_min_sigs=device_min_sigs)
        self.hedge_s = float(hedge_ms) / 1e3
        self.deadline_s = float(deadline_ms) / 1e3
        self.reprobe_cooldown_s = reprobe_cooldown_s
        self.devices = devices or None
        self.channels = [
            HostChannel(i, SidecarVerifier(
                addr, deadline_ms=deadline_ms,
                device_min_sigs=0,  # routing is decided HERE, once
                connect_timeout_s=connect_timeout_s,
                devices=devices))
            for i, addr in enumerate(hosts)]
        # Router state lock: depth bookkeeping and the decision ring
        # only — never held across a socket round trip.
        self._lock = threading.Lock()
        # Pre-spawned dispatch pool: a fresh thread per batch costs tens
        # of ms at p90 on a loaded box (measured), which lands straight
        # in the request cycle; pool threads amortise the spawn. Sized
        # for one in-flight + one hedge per host.
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.channels)),
            thread_name_prefix="fed-dispatch")
        self.fallbacks = 0
        self.hedges = 0
        self.host_degraded = 0
        self.last_tier: str | None = None
        # Server-reported timings of the newest answered batch (the
        # async feeder's sidecar_wait/sidecar_verify spans), plus the
        # federation decomposition: routing-decision wall and the
        # remote round-trip wall (federation_route / remote_verify).
        self.last_wait_s: float | None = None
        self.last_verify_s: float | None = None
        self.last_route_s: float | None = None
        self.last_remote_s: float | None = None
        # Advisory QoS hint, same contract as SidecarVerifier.qos_hint:
        # set by the SMM right before a flush, racy-by-design (a stale
        # hint costs one routing choice, never correctness).
        self.qos_hint: tuple[int, int] | None = None
        self.routing_decisions: deque[dict] = deque(maxlen=ROUTING_RING)

    # -- routing policy ----------------------------------------------------

    def pick_host(self, n_sigs: int,
                  lane_code: int | None = None) -> HostChannel | None:
        """The deterministic routing choice (module doc). Returns None
        when no host is healthy. Pure ranking — depth accounting happens
        at dispatch."""
        healthy = [c for c in self.channels if c.healthy.is_set()]
        if not healthy:
            return None
        if lane_code == LANE_CODE_BULK:
            open_windows = [c for c in healthy if 0 < c.in_flight_sigs
                            and c.in_flight_sigs + n_sigs
                            <= BULK_STICK_CAP_SIGS]
            if open_windows:
                # Stick to the busiest open window (ties -> lowest index).
                return min(open_windows,
                           key=lambda c: (-c.in_flight_sigs, c.index))
        # Interactive / unlabelled / no window to stick to: least depth.
        return min(healthy, key=lambda c: (c.in_flight_sigs, c.index))

    def _record_decision(self, channel: HostChannel, n_sigs: int,
                         lane_code: int | None, hedged: bool) -> None:
        self.routing_decisions.append({
            "host": channel.address,
            "n_sigs": n_sigs,
            "lane": lane_code,
            "hedged": hedged,
            "depths": {c.address: c.in_flight_sigs
                       for c in self.channels},
        })

    # -- dispatch ----------------------------------------------------------

    def _channel_verify(self, channel: HostChannel,
                        jobs: Sequence[VerifyJob],
                        hint: tuple[int, int] | None) -> np.ndarray:
        """One channel round trip — the seam tests stub. The hint hand-
        off shares SidecarVerifier.qos_hint's advisory/racy contract."""
        channel.client.qos_hint = hint
        return channel.client._verify_ed25519_device(jobs)

    def _dispatch(self, channel: HostChannel, jobs: Sequence[VerifyJob],
                  hint: tuple[int, int] | None, slot: dict,
                  slot_lock: threading.Lock, done: threading.Event,
                  pending: list[int]) -> None:
        """Run one attempt and publish the outcome. First success wins
        ``slot``; ``done`` fires on success OR when every launched
        attempt has failed (so the waiter never hangs)."""
        n = len(jobs)
        with self._lock:
            channel.dispatches += 1
            channel.in_flight_batches += 1
            channel.in_flight_sigs += n
        _tm.inc("federation_dispatches_total")
        t0 = time.perf_counter()
        try:
            out = self._channel_verify(channel, jobs, hint)
        except Exception as exc:
            self._quarantine(channel, exc)
            with slot_lock:
                pending[0] -= 1
                exhausted = pending[0] <= 0
            if exhausted:
                done.set()
        else:
            with slot_lock:
                pending[0] -= 1
                if "ok" not in slot:
                    slot["ok"] = out
                    slot["winner"] = channel
                    slot["wall_s"] = time.perf_counter() - t0
            done.set()
        finally:
            with self._lock:
                channel.in_flight_batches -= 1
                channel.in_flight_sigs -= n
                channel.rpc_s_total += time.perf_counter() - t0

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """Route one batch across the federation. Raises (the channel
        client's SidecarError) only when no host answered — this method
        doubles as the whole-tier degrade re-probe, so an internal
        fallback would re-open the gate while every host is still dead."""
        hint = self.qos_hint
        lane_code = hint[0] if hint is not None else None
        t_route = time.perf_counter()
        primary = self.pick_host(len(jobs), lane_code)
        if primary is None:
            raise SidecarError("federation: no healthy host")
        route_s = time.perf_counter() - t_route
        self._record_decision(primary, len(jobs), lane_code, hedged=False)
        slot: dict = {}
        slot_lock = threading.Lock()
        done = threading.Event()
        pending = [1]
        t0 = time.perf_counter()
        self._pool.submit(self._dispatch, primary, jobs, hint, slot,
                          slot_lock, done, pending)
        hedged_to: HostChannel | None = None
        if not done.wait(self.hedge_s):
            # Slow primary: one hedged re-dispatch on the next-ranked
            # healthy host (never the primary itself). Runs inline —
            # this thread was going to block on the result anyway.
            with self._lock:
                candidates = [c for c in self.channels
                              if c is not primary and c.healthy.is_set()]
            if candidates:
                hedged_to = min(candidates,
                                key=lambda c: (c.in_flight_sigs, c.index))
                with self._lock:
                    primary.hedges += 1
                    self.hedges += 1
                _tm.inc("federation_hedges_total")
                self._record_decision(hedged_to, len(jobs), lane_code,
                                      hedged=True)
                with slot_lock:
                    pending[0] += 1
                self._dispatch(hedged_to, jobs, hint, slot, slot_lock,
                               done, pending)
        # Bounded: every attempt's socket carries the client deadline,
        # so the slowest attempt resolves within deadline_s.
        done.wait(self.deadline_s + 1.0)
        with slot_lock:
            out = slot.get("ok")
            winner = slot.get("winner")
        if out is None:
            raise SidecarError(
                f"federation: every dispatched host failed "
                f"(primary {primary.address}"
                + (f", hedge {hedged_to.address}" if hedged_to else "")
                + ")")
        if hedged_to is not None and winner is hedged_to:
            with self._lock:
                hedged_to.hedge_wins += 1
        self.last_route_s = route_s
        self.last_remote_s = time.perf_counter() - t0
        self.last_wait_s = winner.client.last_wait_s
        self.last_verify_s = winner.client.last_verify_s
        self.last_tier = winner.client.last_tier
        return out

    # -- the DeviceRoutedVerifier routing override -------------------------

    def _verify_ed25519(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        if (len(jobs) < self.device_min_sigs
                or (self.device_gate is not None
                    and not self.device_gate.is_set())):
            self.host_batches += 1
            return CpuVerifier._verify_ed25519_host(jobs)
        try:
            out = self._verify_ed25519_device(jobs)
        except Exception:
            # Every dispatched host failed. The batch still answers
            # exactly (oracle host tier); the WHOLE tier only degrades
            # when no healthy host remains — a transient single-host
            # loss must not close the gate on the survivors.
            self.fallbacks += 1
            if not any(c.healthy.is_set() for c in self.channels):
                degrade_device(self, cooldown_s=self.reprobe_cooldown_s)
            self.host_batches += 1
            return CpuVerifier._verify_ed25519_host(jobs)
        self.device_batches += 1
        return out

    # -- per-host quarantine + re-admission --------------------------------

    def _quarantine(self, channel: HostChannel, exc: Exception) -> None:
        """Demote ONE host and schedule its cooldown ping re-probe.
        Idempotent while a re-probe is already pending."""
        with self._lock:
            channel.failures += 1
            was_healthy = channel.healthy.is_set()
            channel.healthy.clear()
            probing = (channel._reprobe_thread is not None
                       and channel._reprobe_thread.is_alive())
            if not was_healthy and probing:
                return
            channel.quarantines += 1
            self.host_degraded += 1
        _tm.inc("federation_host_degraded_total")
        cooldown = self.reprobe_cooldown_s

        def _reprobe() -> None:
            while not channel.healthy.is_set():
                time.sleep(cooldown)
                try:
                    channel.client.warm()  # one ping round trip
                except Exception:
                    continue
                with self._lock:
                    channel.readmits += 1
                    channel.healthy.set()

        t = threading.Thread(target=_reprobe, daemon=True,
                             name=f"fed-reprobe-{channel.index}")
        channel._reprobe_thread = t
        t.start()

    # -- warm + stamping ----------------------------------------------------

    def warm(self) -> None:
        """Ping every host; healthy if ANY answers (the cluster can boot
        while one simulated host is still coming up). Raises only when
        the whole federation is unreachable."""
        errors = []
        reached = 0
        for channel in self.channels:
            try:
                channel.client.warm()
                reached += 1
            except SidecarError as exc:
                errors.append(str(exc))
        if not reached:
            raise SidecarError(
                f"federation: no host reachable: {'; '.join(errors)}")

    def sidecar_stats(self) -> dict:
        """Rides the same node_metrics seam the single-sidecar client
        does (rpc.py duck-types on this method); the ``federation``
        block is what stamp_attribution and the flight recorder read."""
        gate = self.device_gate
        return {
            "address": ",".join(c.address for c in self.channels),
            "deadline_ms": self.deadline_s * 1e3,
            "min_sigs": self.device_min_sigs,
            "batches": sum(c.client.sidecar_batches for c in self.channels),
            "sigs": sum(c.client.sidecar_sigs for c in self.channels),
            "fallbacks": self.fallbacks,
            "connects": sum(c.client.connects for c in self.channels),
            "rpc_s_total": round(
                sum(c.rpc_s_total for c in self.channels), 6),
            "last_wait_s": self.last_wait_s,
            "last_verify_s": self.last_verify_s,
            "last_tier": self.last_tier,
            "gate_open": gate.is_set() if gate is not None else None,
            "degraded": self.degraded,
            "reprobes_ok": self.reprobes_ok,
            "reprobes_failed": self.reprobes_failed,
            "devices": self.devices,
            "federation": self.federation_stats(),
        }

    def federation_stats(self) -> dict:
        """Per-host occupancy/queue-depth/routing counters + the bounded
        decision ring — node_metrics, the Prometheus cluster merge's
        per-node context, and the SLO-breach flight capture."""
        with self._lock:
            decisions = list(self.routing_decisions)
        # Channel counters are monitoring-grade ints (torn reads are
        # harmless), and stats() fetches a cached SERVER snapshot over
        # the wire — neither may run under the router lock.
        hosts = {c.address: c.stats() for c in self.channels}
        total = sum(h["dispatches"] for h in hosts.values())
        return {
            "hosts": hosts,
            "n_hosts": len(self.channels),
            "healthy_hosts": sum(1 for h in hosts.values() if h["healthy"]),
            "dispatches": total,
            "routing_share_by_host": (
                {a: round(h["dispatches"] / total, 4)
                 for a, h in hosts.items()} if total else {}),
            "hedges": self.hedges,
            "host_degraded": self.host_degraded,
            "hedge_ms": self.hedge_s * 1e3,
            "recent_decisions": decisions,
        }
