"""SidecarVerifier -- the node-side client of the verification sidecar.

Counterpart of ``corda_tpu/node/verify_client.py``. It plugs into the
BatchVerifier seam: it IS a DeviceRoutedVerifier whose "device" is the
host-local sidecar socket, so the verify pump (crypto/async_verify.py),
the degrade path and the adaptive crossover work with it unchanged. It
talks to either package's sidecar server (the wire format is the same).

The crossover default is deliberately low (SIDECAR_MIN_SIGS_DEFAULT, 16):
shipping a micro-batch to the sidecar costs one local-socket round trip,
and the sidecar amortises the real device dispatch across every node
process on the host, so small batches should flow out and coalesce
server-side rather than stay on each process's host tier. It is set only
through the constructor.

Failure policy -- never a wrong answer, never a hang:
  * Any transport, deadline or protocol failure raises SidecarError from
    ``_verify_ed25519_device``. The routing override catches it, demotes
    the sidecar tier through provider.degrade_device (gate plus cooldown
    re-probe), counts a fallback and answers the batch from the local
    host tier (CpuVerifier), which is oracle-exact.
  * The re-probe calls ``_verify_ed25519_device`` directly and takes "no
    exception" as healthy, which is why that method must raise on failure
    rather than fall back internally.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Sequence

import numpy as np

from ..crypto import sidecar as wire
from ..crypto.provider import (CpuVerifier, DeviceRoutedVerifier, VerifyJob,
                               degrade_device)

# Size crossover for the sidecar tier: low on purpose, since the client
# pays only a local socket round trip and the expensive device dispatch
# happens server-side, amortised across processes.
SIDECAR_MIN_SIGS_DEFAULT = 16


class SidecarError(RuntimeError):
    """The sidecar failed to answer: dead, deadline missed, or protocol
    error. Carries no verdicts -- the caller re-verifies on the host."""


class SidecarVerifier(DeviceRoutedVerifier):
    """Verifies ed25519 batches through the per-host sidecar server.

    ``qos_hint``: (lane_code, deadline_ns) set by the caller right before a
    batch whose requests carry an interactive deadline; while it is set,
    batches ship as OP_VERIFY_QOS so the sidecar's deadline scheduler can
    order and flush around them. A stale hint costs one early server
    flush, never correctness. ``device_min_sigs`` None takes
    ``CORDA_TPU_SIDECAR_MIN_SIGS`` (the autotuner's knob), else 16, as in
    the JAX package. ``reprobe_cooldown_s``: after a failed round
    trip, how long the degraded client waits between re-probes of the
    sidecar (5 s, the JAX package's default). ``devices``: the mesh width
    the configuration says the server owns ([batch] sidecar_devices),
    stamped for attribution; the server's snapshot carries the proven
    width."""

    name = "sidecar"

    def __init__(self, address: str, deadline_ms: float = 2000.0,
                 device_min_sigs: int | None = None,
                 connect_timeout_s: float = 1.0,
                 reprobe_cooldown_s: float = 5.0,
                 devices: int | None = None):
        if device_min_sigs is None:
            device_min_sigs = int(os.environ.get(
                "CORDA_TPU_SIDECAR_MIN_SIGS", SIDECAR_MIN_SIGS_DEFAULT))
        super().__init__(device_min_sigs=device_min_sigs)
        self.address = address
        self.deadline_s = float(deadline_ms) / 1e3
        self.connect_timeout_s = connect_timeout_s
        self.reprobe_cooldown_s = reprobe_cooldown_s
        self.devices = devices or None
        # Server-stats cache keyed by endpoint, so no sidecar's snapshot is
        # ever served as another's.
        self._server_snapshots: dict[str, tuple[float, dict | None]] = {}
        self._sock: socket.socket | None = None
        self._req_id = 0
        # Serialises the socket: the pump's feeder and the degrade re-probe
        # may both round-trip; one framed request/reply pair at a time.
        self._io_lock = threading.Lock()
        self.sidecar_batches = 0
        self.sidecar_sigs = 0
        self.fallbacks = 0
        self.connects = 0
        self.rpc_s_total = 0.0
        # Server-reported timings of the newest answered batch; the verify
        # pump turns them into sidecar_wait / sidecar_verify spans.
        self.last_wait_s: float | None = None
        self.last_verify_s: float | None = None
        self.last_tier: str | None = None
        self.qos_hint: tuple[int, int] | None = None

    def reset_window(self) -> None:
        """Drop every cached server snapshot, so the next stats fetch is
        fresh (the autotune controller calls this between candidates; the
        snapshot TTL would otherwise hand one candidate the last one's)."""
        self._server_snapshots.clear()

    # -- routing ------------------------------------------------------------

    def _verify_ed25519(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        if self._routes_to_host(len(jobs)):
            self.host_batches += 1
            return CpuVerifier._verify_ed25519_host(jobs)
        try:
            out = self._verify_ed25519_device(jobs)
        except SidecarError:
            # Demote the sidecar tier (gate + cooldown re-probe) and answer
            # from the oracle-exact host tier.
            self.fallbacks += 1
            degrade_device(self, cooldown_s=self.reprobe_cooldown_s)
            self.host_batches += 1
            return CpuVerifier._verify_ed25519_host(jobs)
        self.device_batches += 1
        return out

    # -- the sidecar round trip --------------------------------------------

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """One framed OP_VERIFY (or OP_VERIFY_QOS) round trip. Raises
        SidecarError on any failure; it doubles as the degrade re-probe, so
        it never falls back internally."""
        # Wrong-length keys and signatures cannot ride the fixed-width wire
        # columns; they reject locally, as on the kernel path.
        good_idx = [i for i, j in enumerate(jobs)
                    if len(j.pubkey) == 32 and len(j.sig) == 64]
        out = np.zeros(len(jobs), bool)
        if not good_idx:
            return out
        good = (list(jobs) if len(good_idx) == len(jobs)
                else [jobs[i] for i in good_idx])
        t0 = time.perf_counter()
        # lint: allow(no-blocking-under-lock) _io_lock exists to serialize request/reply framing on the one sidecar socket; callers that must not queue here use their own client instance
        with self._io_lock:
            deadline = time.perf_counter() + self.deadline_s
            try:
                sock = self._connect_maybe()
                self._req_id += 1
                req_id = self._req_id
                sock.settimeout(max(0.05, deadline - time.perf_counter()))
                hint = self.qos_hint
                if hint is not None:
                    lane_code, deadline_ns = hint
                    req = wire.encode_verify_request_qos(
                        req_id, good, lane_code, deadline_ns)
                else:
                    req = wire.encode_verify_request(req_id, good)
                wire.send_frame(sock, req)
                while True:
                    sock.settimeout(max(0.05,
                                        deadline - time.perf_counter()))
                    payload = wire.recv_frame(sock)
                    (op, rid, status, tier, wait_s,
                     verify_s) = wire._VERIFY_REPLY_HDR.unpack_from(payload)
                    if op == wire.OP_VERIFY and rid == req_id:
                        break  # anything else is a stale frame: skip it
                if status != wire.STATUS_OK:
                    detail = payload[wire._VERIFY_REPLY_HDR.size:].decode(
                        errors="replace")
                    raise SidecarError(
                        f"sidecar verify failed: {detail or 'error'}")
                flags = np.frombuffer(
                    payload, np.uint8,
                    offset=wire._VERIFY_REPLY_HDR.size).astype(bool)
                if len(flags) != len(good):
                    raise SidecarError("short sidecar reply")
            except (OSError, ConnectionError, socket.timeout, struct.error,
                    ValueError) as exc:
                # A half-answered stream cannot be resumed: reconnect next
                # time (which is also what makes the re-probe meaningful).
                self._drop_connection()
                raise SidecarError(
                    f"sidecar {self.address}: {exc}") from exc
        self.sidecar_batches += 1
        self.sidecar_sigs += len(good)
        self.rpc_s_total += time.perf_counter() - t0
        self.last_wait_s = float(wait_s)
        self.last_verify_s = float(verify_s)
        self.last_tier = "device" if tier else "host"
        if len(good_idx) == len(jobs):
            return flags
        out[good_idx] = flags
        return out

    def warm(self) -> None:
        """Ping the server (a connectivity check: the server owns the
        device and its warm-up)."""
        # lint: allow(no-blocking-under-lock) same socket-framing serialization lock as verify_batch: the ping must not interleave with an in-flight verify frame
        with self._io_lock:
            try:
                sock = self._connect_maybe()
                self._req_id += 1
                sock.settimeout(self.connect_timeout_s)
                wire.send_frame(
                    sock, wire._REQ_HDR.pack(wire.OP_PING, self._req_id))
                wire.recv_frame(sock)
            except (OSError, ConnectionError, struct.error) as exc:
                self._drop_connection()
                raise SidecarError(
                    f"sidecar {self.address}: {exc}") from exc

    def close(self) -> None:
        """Close the connection (the next round trip reconnects)."""
        with self._io_lock:
            self._drop_connection()

    def _connect_maybe(self) -> socket.socket:
        if self._sock is None:
            self._sock = wire.connect(self.address,
                                      timeout=self.connect_timeout_s)
            self.connects += 1
        return self._sock

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- stamping -----------------------------------------------------------

    def sidecar_stats(self) -> dict:
        """The client's view, with the server's snapshot beside it."""
        gate = self.device_gate
        return {
            "address": self.address,
            "deadline_ms": self.deadline_s * 1e3,
            "min_sigs": self.device_min_sigs,
            "batches": self.sidecar_batches,
            "sigs": self.sidecar_sigs,
            "fallbacks": self.fallbacks,
            "connects": self.connects,
            "rpc_s_total": round(self.rpc_s_total, 6),
            "last_wait_s": self.last_wait_s,
            "last_verify_s": self.last_verify_s,
            "last_tier": self.last_tier,
            "gate_open": gate.is_set() if gate is not None else None,
            "degraded": self.degraded,
            "reprobes_ok": self.reprobes_ok,
            "reprobes_failed": self.reprobes_failed,
            "devices": self.devices,
            "server": self._server_stats_maybe(),
        }

    def _server_stats_maybe(self) -> dict | None:
        """The server's stats over a fresh connection (never contending
        with an in-flight verify), cached 5 s per endpoint; None when the
        server is unreachable."""
        now = time.monotonic()
        hit = self._server_snapshots.get(self.address)
        if hit is not None and now - hit[0] < 5.0:
            return hit[1]
        try:
            snap = fetch_sidecar_stats(self.address, timeout=0.5)
        except SidecarError:
            snap = None
        self._server_snapshots[self.address] = (now, snap)
        return snap


def fetch_sidecar_stats(address: str, timeout: float = 2.0) -> dict:
    """One OP_STATS round trip on a fresh connection. Raises SidecarError
    when the server is unreachable or answers badly."""
    try:
        return wire.fetch_stats(address, timeout=timeout)
    except (OSError, ConnectionError, RuntimeError, ValueError,
            struct.error) as exc:
        raise SidecarError(f"sidecar {address}: {exc}") from exc
