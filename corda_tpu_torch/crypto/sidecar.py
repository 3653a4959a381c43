"""Device-owning verification sidecar: cross-process batch coalescing.

Counterpart of ``corda_tpu/crypto/sidecar.py``, speaking the same wire
protocol byte for byte, so either package's client
(``corda_tpu_torch.node.verify_client.SidecarVerifier`` or the JAX
package's) talks to this server unchanged. One server per host owns the
card; every node process sends its micro-batches here, and the server
merges requests from many processes into kernel-sized batches.

Server structure:
  reader threads   -- one per connection; decode framed requests into a
                      shared pending queue.
  scheduler thread -- holds the queue open from the OLDEST pending request
                      for up to coalesce_us, flushing early when pending
                      sigs reach max_sigs, or qos_guard_us before the
                      earliest interactive deadline (OP_VERIFY_QOS); whole
                      requests only, interactive and unlabelled ones first
                      when bulk requests wait too. It then runs the host
                      half of the device dispatch (pack_device), which
                      returns None for a batch the verifier routes to its
                      host tier (under device_min_sigs, gate closed, mixed
                      schemes, nothing well-formed).
  executor thread  -- runs verify_packed on the card, or verify_batch for a
                      batch that was not packed, splits the answers per
                      request, and (adaptive_coalesce) retunes coalesce_us
                      from the observed batch fill.
  depth-N buffering: a BoundedSemaphore(depth) between scheduler and
                      executor lets batch N+1 pack while batch N runs.

Wire protocol (little-endian, length-prefixed frames, unix path or
host:port):
  frame    := u32(len) payload
  request  := u8(op) u32(req_id) body
  OP_VERIFY  body:  u32(n)  pubkeys n*32  sigs n*64  u32 msg_len[n]  msgs
  OP_VERIFY_QOS body: u32(n) u8(lane) u64(deadline_ns, epoch; 0 = none)
                    then the OP_VERIFY body's columns; OP_VERIFY reply
  OP_VERIFY  reply: u8(op) u32(req_id) u8(status) u8(tier)
                    f32(wait_s) f32(verify_s)  u8 ok[n]
                    (tier: 1 = the batch ran on the device, 0 = host tier)
  OP_STATS   reply: u8(op) u32(req_id) u8(status)  json(stats) utf-8
  OP_METRICS reply: u8(op) u32(req_id) u8(status)  prometheus text utf-8
  OP_PING    reply: u8(op) u32(req_id) u8(status)

Device ownership: ``devices=N`` (``--devices N``) with N > 1 makes the
server's verifier a ``TorchMeshVerifier`` over N local cards, so each
coalesced batch is split into equal slices, one per card (ops/sharded.py);
the stats attribute the lanes dispatched and the pad lanes (device_lanes,
pad_lanes, per_device_batch_sigs_hist). The mesh is built in start(): a
host with fewer cards than asked for raises there (the CLI exits non-zero
before its banner), where the JAX package's server stays up on its host
tier. ``devices`` 1 or unset keeps the single-card verifier.

The sidecar holds no durable state; a client that gets an error or no
answer verifies on its own host tier.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import struct
import sys
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from ..obs import telemetry as _tm
from .provider import TorchMeshVerifier, VerifyJob, make_verifier

OP_VERIFY = 1
OP_STATS = 2
OP_PING = 3
# OP_VERIFY with a QoS prefix (lane code and the batch's earliest
# interactive deadline in epoch ns): the same columnar body and the same
# OP_VERIFY reply.
OP_VERIFY_QOS = 4
# Prometheus text of this process's telemetry registry (obs/export.py).
OP_METRICS = 5

STATUS_OK = 0
STATUS_ERR = 1

# Lane codes on the wire, as the JAX package's QoS plane numbers them.
LANE_CODE_INTERACTIVE = 0
LANE_CODE_BULK = 1

# One frame bounds one request: 64 MiB covers 65536 jobs with ~900-byte
# messages.
MAX_FRAME = 64 * 1024 * 1024

_FRAME_HDR = struct.Struct("<I")
_REQ_HDR = struct.Struct("<BI")
_VERIFY_REQ_HDR = struct.Struct("<BII")
# op, req_id, n, lane code, deadline_ns (epoch; 0 = no deadline).
_VERIFY_QOS_REQ_HDR = struct.Struct("<BIIBQ")
_REPLY_HDR = struct.Struct("<BIB")
_VERIFY_REPLY_HDR = struct.Struct("<BIBBff")

# The JAX package's padded-bucket ladder: the batch-size histogram keys by
# it, so stats read the same on both servers.
BUCKETS = (64, 256, 1024, 4096, 16384, 65536)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= max(n, n_devices) -- the arithmetic
    of ops/sharded.py, here so that pad attribution needs no torch."""
    return -(-max(n, 1) // max(n_devices, 1)) * max(n_devices, 1)


# Adaptive coalesce_us: every ADAPT_WINDOW executed batches, shrink the
# window when batches fill to half of max_sigs (it only adds latency) and
# grow it when they stay under a quarter while requests still coalesce
# (more company would arrive); between the two, no change.
ADAPT_WINDOW = 8        # executed batches per decision
ADAPT_GROW = 1.5
ADAPT_SHRINK = 0.75
ADAPT_SEED_US = 200     # first growth step out of coalesce_us=0
ADAPT_CEILING_US = 20_000


# ---------------------------------------------------------------------------
# Framing + codec
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_FRAME_HDR.pack(len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("sidecar connection closed")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> bytes:
    (ln,) = _FRAME_HDR.unpack(recv_exact(sock, _FRAME_HDR.size))
    if ln > MAX_FRAME:
        raise ConnectionError(f"sidecar frame too large: {ln}")
    return recv_exact(sock, ln)


def _encode_jobs(jobs: Sequence[VerifyJob]) -> bytes:
    """Columnar job body: keys, sigs, message lengths, messages."""
    n = len(jobs)
    return b"".join((
        b"".join(bytes(j.pubkey) for j in jobs),
        b"".join(bytes(j.sig) for j in jobs),
        np.fromiter((len(j.message) for j in jobs), "<u4", n).tobytes(),
        b"".join(bytes(j.message) for j in jobs),
    ))


def _decode_jobs(payload: bytes, off: int, n: int) -> list[VerifyJob]:
    pks = payload[off:off + 32 * n]
    off += 32 * n
    sigs = payload[off:off + 64 * n]
    off += 64 * n
    lens = np.frombuffer(payload, "<u4", n, off)
    off += 4 * n
    if len(pks) != 32 * n or len(sigs) != 64 * n:
        raise ValueError("short sidecar verify request")
    jobs = []
    for i in range(n):
        ln = int(lens[i])
        msg = payload[off:off + ln]
        if len(msg) != ln:
            raise ValueError("short sidecar verify request")
        off += ln
        jobs.append(VerifyJob(pks[32 * i:32 * i + 32], msg,
                              sigs[64 * i:64 * i + 64]))
    return jobs


def encode_verify_request(req_id: int, jobs: Sequence[VerifyJob]) -> bytes:
    """Well-formed ed25519 jobs (32-byte keys, 64-byte sigs) -> one
    OP_VERIFY payload."""
    return _VERIFY_REQ_HDR.pack(OP_VERIFY, req_id, len(jobs)) \
        + _encode_jobs(jobs)


def decode_verify_request(payload: bytes):
    """-> (req_id, [VerifyJob...]); raises on a malformed frame."""
    _op, req_id, n = _VERIFY_REQ_HDR.unpack_from(payload)
    return req_id, _decode_jobs(payload, _VERIFY_REQ_HDR.size, n)


def encode_verify_request_qos(req_id: int, jobs: Sequence[VerifyJob],
                              lane: int, deadline_ns: int) -> bytes:
    """OP_VERIFY_QOS: the OP_VERIFY body prefixed with the batch's lane and
    earliest interactive deadline (epoch ns; 0 = none)."""
    return _VERIFY_QOS_REQ_HDR.pack(
        OP_VERIFY_QOS, req_id, len(jobs), lane,
        deadline_ns & 0xFFFFFFFFFFFFFFFF) + _encode_jobs(jobs)


def decode_verify_request_qos(payload: bytes):
    """-> (req_id, [VerifyJob...], lane, deadline_ns); raises on junk."""
    _op, req_id, n, lane, deadline_ns = \
        _VERIFY_QOS_REQ_HDR.unpack_from(payload)
    if lane not in (LANE_CODE_INTERACTIVE, LANE_CODE_BULK):
        raise ValueError(f"unknown sidecar lane code {lane}")
    return (req_id, _decode_jobs(payload, _VERIFY_QOS_REQ_HDR.size, n),
            lane, deadline_ns)


def parse_address(address: str):
    """'host:port' -> ("tcp", (host, port)); anything else is a unix path."""
    if ":" in address and "/" not in address:
        host, port = address.rsplit(":", 1)
        return "tcp", (host or "127.0.0.1", int(port))
    return "unix", address


def connect(address: str, timeout: float | None = None) -> socket.socket:
    kind, addr = parse_address(address)
    if kind == "tcp":
        sock = socket.create_connection(addr, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(addr)
    return sock


# ---------------------------------------------------------------------------
# Client helper
# ---------------------------------------------------------------------------


def verify_remote(address: str, jobs: Sequence[VerifyJob],
                  timeout: float = 120.0, sock: socket.socket | None = None,
                  req_id: int = 1) -> np.ndarray:
    """Verify ``jobs`` on the sidecar at ``address`` -> bool[len(jobs)].

    Jobs that cannot ride the fixed-width wire arrays (wrong key or
    signature length, another scheme) reject locally. Raises RuntimeError
    on an error reply and OSError/ConnectionError on a dead server. Pass an
    open ``sock`` to reuse one connection across calls."""
    out = np.zeros(len(jobs), bool)
    good = [i for i, j in enumerate(jobs)
            if j.scheme == "ed25519" and len(j.pubkey) == 32
            and len(j.sig) == 64]
    if not good:
        return out
    own = sock is None
    if own:
        sock = connect(address, timeout=timeout)
    try:
        sock.settimeout(timeout)
        send_frame(sock, encode_verify_request(req_id,
                                               [jobs[i] for i in good]))
        while True:
            payload = recv_frame(sock)
            op, rid, status, _tier, _w, _v = \
                _VERIFY_REPLY_HDR.unpack_from(payload)
            if op == OP_VERIFY and rid == req_id:
                break
        body = payload[_VERIFY_REPLY_HDR.size:]
        if status != STATUS_OK:
            raise RuntimeError("sidecar verify failed: "
                               + body.decode(errors="replace"))
        flags = np.frombuffer(body, np.uint8).astype(bool)
        if len(flags) != len(good):
            raise RuntimeError("short sidecar reply")
    finally:
        if own:
            sock.close()
    out[good] = flags
    return out


def fetch_stats(address: str, timeout: float = 10.0) -> dict:
    """One OP_STATS round trip on a fresh connection."""
    sock = connect(address, timeout=timeout)
    try:
        send_frame(sock, _REQ_HDR.pack(OP_STATS, 1))
        payload = recv_frame(sock)
    finally:
        sock.close()
    op, _, status = _REPLY_HDR.unpack_from(payload)
    if op != OP_STATS or status != STATUS_OK:
        raise RuntimeError("bad sidecar stats reply")
    return json.loads(payload[_REPLY_HDR.size:].decode())


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _Client:
    """One accepted connection; the lock serialises reply frames from the
    executor and the connection's reader thread."""

    __slots__ = ("conn", "lock")

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.lock = threading.Lock()

    def reply(self, payload: bytes) -> None:
        # lint: allow(no-blocking-under-lock) this per-client lock EXISTS to serialize frames on one socket (executor vs reader thread); nothing else ever contends on it
        with self.lock:
            send_frame(self.conn, payload)


class _Pending:
    __slots__ = ("client", "req_id", "jobs", "received_at", "lane",
                 "deadline_ns")

    def __init__(self, client: _Client, req_id: int,
                 jobs: list[VerifyJob], lane: int | None = None,
                 deadline_ns: int = 0):
        self.client = client
        self.req_id = req_id
        self.jobs = jobs
        self.received_at = time.perf_counter()
        # The QoS prefix of OP_VERIFY_QOS; None / 0 for a plain OP_VERIFY,
        # which schedules as before.
        self.lane = lane
        self.deadline_ns = deadline_ns


_STOP = object()


class SidecarServer:
    """The per-host verification server; it owns the card (or cards)
    through its verifier (default: ``verifier_kind`` "torch" on
    ``device``, a ``TorchMeshVerifier`` over ``devices`` cards when
    devices > 1). ``device_min_sigs``, when given, is set on the verifier
    the server builds (its size crossover); a caller that brings its own
    verifier sets it there. ``adaptive_coalesce`` retunes ``coalesce_us``
    from the batch fill; ``qos_guard_us`` is how long before the earliest
    interactive deadline a coalescing batch flushes."""

    def __init__(self, address: str, verifier=None, device: str = "cuda",
                 coalesce_us: int = 2000, max_sigs: int = 4096,
                 depth: int = 2, device_min_sigs: int | None = None,
                 adaptive_coalesce: bool = False,
                 qos_guard_us: int = 2000, verifier_kind: str = "torch",
                 devices: int | None = None):
        self.address = address
        self.devices = int(devices or 0)
        if verifier is None:
            verifier = self._make_server_verifier(verifier_kind,
                                                  self.devices, device)
            if device_min_sigs is not None and hasattr(
                    verifier, "device_min_sigs"):
                verifier.device_min_sigs = device_min_sigs
        elif device_min_sigs is not None:
            raise ValueError("device_min_sigs applies to the verifier the "
                             "server builds: set it on the verifier passed in")
        if not self.devices:
            self.devices = int(getattr(verifier, "n_devices", None) or 0)
        self.verifier = verifier
        self.coalesce_us = int(coalesce_us)
        self.coalesce_us_initial = int(coalesce_us)
        self.adaptive_coalesce = bool(adaptive_coalesce)
        self.coalesce_adjustments = 0
        self._win_batches = 0
        self._win_requests = 0
        self._win_sigs = 0
        self.max_sigs = int(max_sigs)
        self.depth = int(depth)
        # The proven mesh width: set in start() once the verifier's mesh is
        # built (None for a single-device verifier).
        self.mesh_devices: int | None = None

        self._pending: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._exec_q: queue.SimpleQueue = queue.SimpleQueue()
        self._slots = threading.BoundedSemaphore(self.depth)
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._clients: list[_Client] = []
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()  # stats counters
        self.requests = 0
        self.batches = 0
        self.sigs = 0
        self.cross_request_batches = 0
        self.errors = 0
        self.batch_sigs_hist: dict[int, int] = {}
        self.packed_batches = 0
        self.pack_s_total = 0.0
        self.wait_s_total = 0.0
        self.verify_s_total = 0.0
        # Lanes dispatched on the device tier, the pad lanes among them
        # (the round-up to a multiple of the mesh width), and a histogram
        # keyed by each device's lane share per dispatch.
        self.device_lanes = 0
        self.pad_lanes = 0
        self.per_device_batch_sigs_hist: dict[int, int] = {}
        # QoS: flush this long before the earliest interactive deadline
        # (kept in ns), and count how the deadline scheduler behaved.
        self.qos_guard_ns = int(qos_guard_us) * 1000
        self.qos_early_flushes = 0
        self.qos_interactive_requests = 0
        self.qos_bulk_requests = 0

    @staticmethod
    def _make_server_verifier(kind: str, devices: int, device: str = "cuda"):
        """devices > 1 makes a "torch*" kind a TorchMeshVerifier over
        exactly that many cards (on device="cpu", that many copies of the
        CPU device: the plain versions, slice by slice); devices <= 1
        keeps the single-device verifier. Other kinds ignore devices --
        there is no device tier to split."""
        if devices > 1 and kind.startswith("torch"):
            shadow = 0.05 if kind == "torch-shadow" else 0.0
            if device == "cpu":
                return TorchMeshVerifier(devices=["cpu"] * devices,
                                         shadow_rate=shadow)
            return TorchMeshVerifier(n_devices=devices, shadow_rate=shadow)
        return make_verifier(kind, device=device)

    # -- lifecycle ----------------------------------------------------------

    def start(self, warm: bool = True) -> "SidecarServer":
        """Build the verifier's mesh (raises when the host has fewer cards
        than it asks for), optionally warm the verifier (builds the kernels
        before the first request is taken), listen, and start the
        threads."""
        if isinstance(self.verifier, TorchMeshVerifier):
            self.mesh_devices = len(self.verifier.mesh)
        if warm and hasattr(self.verifier, "warm"):
            self.verifier.warm()
        kind, addr = parse_address(self.address)
        if kind == "unix":
            try:
                os.unlink(addr)
            except FileNotFoundError:
                pass
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.bind(addr)
        else:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(addr)
            host, port = listener.getsockname()[:2]
            self.address = f"{host}:{port}"  # resolve port 0
        listener.listen(64)
        self._listener = listener
        for target, name in ((self._accept_loop, "sidecar-accept"),
                             (self._scheduler, "sidecar-scheduler"),
                             (self._executor, "sidecar-executor")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._exec_q.put(_STOP)
        if self._listener is not None:
            try:  # shutdown wakes a thread blocked in accept(); close alone may not
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        kind, addr = parse_address(self.address)
        if kind == "unix":
            try:
                os.unlink(addr)
            except OSError:
                pass

    # -- connection handling ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            if conn.family != socket.AF_UNIX:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            client = _Client(conn)
            with self._lock:
                self._clients.append(client)
            t = threading.Thread(target=self._serve_conn, args=(client,),
                                 daemon=True, name="sidecar-conn")
            t.start()

    def _serve_conn(self, client: _Client) -> None:
        try:
            while not self._stop.is_set():
                payload = recv_frame(client.conn)
                op, req_id = _REQ_HDR.unpack_from(payload)
                if op == OP_VERIFY:
                    _, jobs = decode_verify_request(payload)
                    self._enqueue(_Pending(client, req_id, jobs))
                elif op == OP_VERIFY_QOS:
                    _, jobs, lane, deadline_ns = \
                        decode_verify_request_qos(payload)
                    self._enqueue(_Pending(client, req_id, jobs, lane=lane,
                                           deadline_ns=deadline_ns))
                elif op == OP_STATS:
                    client.reply(_REPLY_HDR.pack(OP_STATS, req_id, STATUS_OK)
                                 + json.dumps(self.stats()).encode())
                elif op == OP_METRICS:
                    from ..obs.export import render_prometheus

                    client.reply(_REPLY_HDR.pack(OP_METRICS, req_id, STATUS_OK)
                                 + render_prometheus().encode())
                elif op == OP_PING:
                    client.reply(_REPLY_HDR.pack(OP_PING, req_id, STATUS_OK))
                else:
                    raise ValueError(f"unknown sidecar op {op}")
        except (ConnectionError, OSError, ValueError, struct.error):
            pass  # client went away or sent garbage: drop the connection
        finally:
            try:
                client.conn.close()
            except OSError:
                pass
            with self._lock:
                if client in self._clients:
                    self._clients.remove(client)

    def _enqueue(self, pend: _Pending) -> None:
        # Counters change under _lock (the lock stats() reads them under),
        # never under _cv: the two locks are never held together.
        with self._lock:
            self.requests += 1
            if pend.lane == LANE_CODE_INTERACTIVE:
                self.qos_interactive_requests += 1
            elif pend.lane == LANE_CODE_BULK:
                self.qos_bulk_requests += 1
        if _tm.ACTIVE is not None:
            _tm.inc("sidecar_requests_total")
        with self._cv:
            self._pending.append(pend)
            self._cv.notify_all()

    # -- coalescing scheduler ----------------------------------------------

    def _pending_sigs(self) -> int:
        return sum(len(p.jobs) for p in self._pending)

    def _min_interactive_deadline_ns(self) -> int:
        """Earliest interactive deadline among pending requests (0 = none).
        Called under _cv."""
        dl = 0
        for p in self._pending:
            if (p.lane == LANE_CODE_INTERACTIVE and p.deadline_ns > 0
                    and (dl == 0 or p.deadline_ns < dl)):
                dl = p.deadline_ns
        return dl

    def _form_batch(self) -> list[_Pending]:
        """Take up to max_sigs from pending. With no bulk request waiting
        this is the FIFO cut; when both classes wait, interactive (and
        unlabelled) requests pack first, FIFO within each class, so a full
        batch is cut from the latency-sensitive end and bulk rides the next
        one. Called under _cv."""
        if not any(p.lane == LANE_CODE_BULK for p in self._pending):
            batch: list[_Pending] = []
            total = 0
            while self._pending and total < self.max_sigs:
                p = self._pending.popleft()
                batch.append(p)
                total += len(p.jobs)
            return batch
        pending = list(self._pending)
        ordered = ([p for p in pending if p.lane != LANE_CODE_BULK]
                   + [p for p in pending if p.lane == LANE_CODE_BULK])
        batch, taken, total = [], set(), 0
        for p in ordered:
            if total >= self.max_sigs:
                break
            batch.append(p)
            taken.add(id(p))
            total += len(p.jobs)
        self._pending = deque(p for p in pending if id(p) not in taken)
        return batch

    def _scheduler(self) -> None:
        while True:
            qos_flush = False
            with self._cv:
                while not self._pending:
                    if self._stop.is_set():
                        return
                    self._cv.wait(0.1)
                # The window anchors on the OLDEST pending request: no
                # request waits longer than coalesce_us for company.
                deadline = (self._pending[0].received_at
                            + self.coalesce_us / 1e6)
                while (self._pending_sigs() < self.max_sigs
                       and not self._stop.is_set()):
                    limit = deadline
                    dl_ns = self._min_interactive_deadline_ns()
                    if dl_ns:
                        # The epoch-ns deadline on the perf_counter clock,
                        # less the guard, so verify and reply still fit.
                        qos_limit = (time.perf_counter()
                                     + (dl_ns - self.qos_guard_ns
                                        - time.time_ns()) / 1e9)
                        limit = min(limit, qos_limit)
                    remaining = limit - time.perf_counter()
                    if remaining <= 0:
                        # Cut while the coalescing window is still open:
                        # a deadline flush.
                        qos_flush = deadline - time.perf_counter() > 0
                        break
                    self._cv.wait(remaining)
                batch = self._form_batch()
            if qos_flush:
                with self._lock:
                    self.qos_early_flushes += 1
            # At most `depth` batches formed-or-running: backpressure that
            # keeps the scheduler one batch ahead of the executor.
            while not self._slots.acquire(timeout=0.2):
                if self._stop.is_set():
                    return
            if self._stop.is_set():
                self._slots.release()
                return
            jobs = [j for p in batch for j in p.jobs]
            pack_fn = getattr(self.verifier, "pack_device", None)
            t_pack = time.perf_counter()
            packed, err = None, None
            if pack_fn is not None:
                try:
                    packed = pack_fn(jobs)
                except Exception as exc:  # noqa: BLE001 -- becomes an ERR reply
                    err = exc
            self._exec_q.put((batch, jobs, packed, err,
                              time.perf_counter() - t_pack))

    # -- executor -----------------------------------------------------------

    def _executor(self) -> None:
        while True:
            item = self._exec_q.get()
            if item is _STOP:
                return
            batch, jobs, packed, err, pack_s = item
            before_dev = getattr(self.verifier, "device_batches", 0) or 0
            t0 = time.perf_counter()
            ok = None
            if err is None:
                try:
                    ok = (self.verifier.verify_packed(packed)
                          if packed is not None
                          else self.verifier.verify_batch(jobs))
                except Exception as exc:  # noqa: BLE001 -- ERR reply
                    err = exc
            verify_s = time.perf_counter() - t0
            # The tier that served the batch: the device ran it iff the
            # verifier counted a device batch for it.
            tier = 1 if err is None and (getattr(
                self.verifier, "device_batches", 0) or 0) > before_dev else 0
            if _tm.ACTIVE is not None:
                _tm.inc("sidecar_batches_total")
                _tm.inc("sidecar_sigs_total", len(jobs))
                _tm.observe("sidecar_batch_sigs", len(jobs))
            with self._lock:
                self.batches += 1
                self.sigs += len(jobs)
                if len(batch) > 1:
                    self.cross_request_batches += 1
                if err is not None:
                    self.errors += 1
                b = bucket_for(len(jobs))
                self.batch_sigs_hist[b] = self.batch_sigs_hist.get(b, 0) + 1
                self.verify_s_total += verify_s
                self.wait_s_total += sum(t0 - p.received_at for p in batch)
                if packed is not None:
                    self.packed_batches += 1
                    self.pack_s_total += pack_s
                if tier == 1:
                    # Pad attribution: a packed handle knows its dispatched
                    # lanes and mesh width; an unpacked device batch is
                    # reconstructed from the mesh width.
                    if packed is not None:
                        ndev = getattr(packed, "n_devices", 1)
                        real = len(packed.good)
                        lanes = getattr(packed, "bucket", real)
                    else:
                        ndev = self.mesh_devices or 1
                        real = len(jobs)
                        lanes = pad_to_devices(real, ndev)
                    self.device_lanes += lanes
                    self.pad_lanes += lanes - real
                    share = lanes // ndev
                    self.per_device_batch_sigs_hist[share] = (
                        self.per_device_batch_sigs_hist.get(share, 0) + 1)
                if self.adaptive_coalesce:
                    self._adapt_observe(len(batch), len(jobs))
            offset = 0
            for p in batch:
                n = len(p.jobs)
                head = _VERIFY_REPLY_HDR.pack(
                    OP_VERIFY, p.req_id,
                    STATUS_OK if err is None else STATUS_ERR, tier,
                    t0 - p.received_at, verify_s)
                if err is None:
                    body = np.asarray(ok[offset:offset + n],
                                      bool).astype(np.uint8).tobytes()
                else:
                    body = repr(err).encode()[:512]
                offset += n
                try:
                    p.client.reply(head + body)
                except OSError:
                    pass  # client died mid-batch: it re-verifies itself
            self._slots.release()

    # -- adaptive coalescing ------------------------------------------------

    def _adapt_observe(self, n_requests: int, n_sigs: int) -> None:
        """Retune coalesce_us from the observed batch fill; called under
        self._lock once per executed batch when adaptive_coalesce is on.
        Every ADAPT_WINDOW batches: a mean fill of at least max_sigs/2
        shrinks the window (it is only added latency); a mean under
        max_sigs/4 while several requests share a batch grows it toward
        ADAPT_CEILING_US (more company would arrive). Only the window's
        length changes: it still anchors on the oldest pending request
        and still flushes early at max_sigs."""
        self._win_batches += 1
        self._win_requests += n_requests
        self._win_sigs += n_sigs
        if self._win_batches < ADAPT_WINDOW:
            return
        mean = self._win_sigs / self._win_batches
        coalescing = self._win_requests > self._win_batches
        self._win_batches = self._win_requests = self._win_sigs = 0
        cur = self.coalesce_us
        if mean >= self.max_sigs / 2:
            new = int(cur * ADAPT_SHRINK)
        elif mean < self.max_sigs / 4 and coalescing:
            new = min(ADAPT_CEILING_US,
                      max(ADAPT_SEED_US, int(cur * ADAPT_GROW)))
        else:
            return
        if new != cur:
            self.coalesce_us = new
            self.coalesce_adjustments += 1

    def reset_window(self) -> None:
        """Restore the configured coalesce window and zero the adaptation
        window, so the next measurement's first ADAPT_WINDOW batches are
        judged on its own traffic. Cumulative stats (batches, sigs,
        coalesce_adjustments) survive."""
        with self._lock:
            self.coalesce_us = self.coalesce_us_initial
            self._win_batches = self._win_requests = self._win_sigs = 0

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        v = self.verifier
        kmod = sys.modules.get("corda_tpu_torch.ops.kernels")
        dev_b = getattr(v, "device_batches", None)
        host_b = getattr(v, "host_batches", None)
        occupancy = None
        if dev_b is not None and host_b is not None:
            total = dev_b + host_b
            occupancy = round(dev_b / total, 3) if total else 0.0
        with self._lock:
            hist = {str(k): self.batch_sigs_hist[k]
                    for k in sorted(self.batch_sigs_hist)}
            per_dev_hist = {str(k): self.per_device_batch_sigs_hist[k]
                            for k in sorted(self.per_device_batch_sigs_hist)}
            lanes, pad = self.device_lanes, self.pad_lanes
            return {
                "address": self.address,
                "verifier": getattr(v, "name", None),
                "kernel_backend": getattr(v, "kernel_backend", None),
                "requests": self.requests,
                "batches": self.batches,
                "sigs": self.sigs,
                "cross_request_batches": self.cross_request_batches,
                "errors": self.errors,
                "batch_sigs_hist": hist,
                "device_batches": dev_b,
                "host_batches": host_b,
                "device_min_sigs": getattr(v, "device_min_sigs", None),
                "device_occupancy": occupancy,
                # This process's kernel launches (ops/kernels.py), read
                # without importing the kernel module.
                "kernel_launches": (dict(kmod.LAUNCHES) if kmod is not None
                                    else None),
                "packed_batches": self.packed_batches,
                "pack_s_total": round(self.pack_s_total, 6),
                # Mesh ownership: the configured width, the proven one, and
                # the lanes dispatched. The port packs each batch to its
                # exact size (the kernels take any N), so pad lanes come
                # only from the round-up to a multiple of the mesh width.
                "devices": self.devices or None,
                "mesh_devices": self.mesh_devices,
                "device_lanes": lanes,
                "pad_lanes": pad,
                "pad_fraction": (round(pad / lanes, 4) if lanes else 0.0),
                "per_device_occupancy": (
                    round((lanes - pad) / lanes, 4) if lanes else 0.0),
                "per_device_batch_sigs_hist": per_dev_hist,
                "coalesce_us": self.coalesce_us,
                "coalesce_us_initial": self.coalesce_us_initial,
                "adaptive_coalesce": self.adaptive_coalesce,
                "coalesce_adjustments": self.coalesce_adjustments,
                "max_sigs": self.max_sigs,
                "depth": self.depth,
                "wait_s_total": round(self.wait_s_total, 6),
                "verify_s_total": round(self.verify_s_total, 6),
                "qos_guard_us": self.qos_guard_ns // 1000,
                "qos_early_flushes": self.qos_early_flushes,
                "qos_interactive_requests": self.qos_interactive_requests,
                "qos_bulk_requests": self.qos_bulk_requests,
            }


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="corda_tpu_torch verification sidecar: one "
                    "card-owning verify server per host")
    parser.add_argument("--socket", required=True,
                        help="unix socket path or host:port to listen on")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch versions)")
    parser.add_argument("--verifier", default="torch",
                        help="server-side provider (torch | torch-shadow | "
                             "torch-sharded | cpu | oracle)")
    parser.add_argument("--devices", type=int, default=None,
                        help="split each batch across this many local "
                             "cards (TorchMeshVerifier); 1 or unset keeps "
                             "the single-card verifier; more than the "
                             "host has exits non-zero")
    parser.add_argument("--coalesce-us", type=int, default=2000,
                        help="max time the oldest request waits for "
                             "cross-client company")
    parser.add_argument("--max-sigs", type=int, default=4096,
                        help="flush a coalesced batch early at this many "
                             "signatures")
    parser.add_argument("--depth", type=int, default=2,
                        help="batches formed-or-in-flight (double buffer)")
    parser.add_argument("--device-min-sigs", type=int, default=None,
                        help="size crossover of the server's verifier: "
                             "coalesced batches under this many sigs take "
                             "the host tier (0 = always the device; default: "
                             "the provider's measured crossover)")
    parser.add_argument("--adaptive-coalesce", action="store_true",
                        help="retune coalesce_us from the observed batch "
                             "fill (grow toward full batches, shrink when "
                             "batches fill early)")
    parser.add_argument("--qos-guard-us", type=int, default=2000,
                        help="flush a coalescing batch this long before "
                             "the earliest interactive deadline "
                             "(OP_VERIFY_QOS clients)")
    args = parser.parse_args(argv)
    server = SidecarServer(args.socket, device=args.device,
                           verifier_kind=args.verifier, devices=args.devices,
                           coalesce_us=args.coalesce_us,
                           max_sigs=args.max_sigs, depth=args.depth,
                           device_min_sigs=args.device_min_sigs,
                           adaptive_coalesce=args.adaptive_coalesce,
                           qos_guard_us=args.qos_guard_us)
    server.start()
    print(f"sidecar up at {server.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
