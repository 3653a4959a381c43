"""Device-owning verification sidecar: cross-process batch coalescing.

Counterpart of ``corda_tpu/crypto/sidecar.py``, speaking the same wire
protocol byte for byte, so the existing notary cluster's clients
(``corda_tpu.node.verify_client.SidecarVerifier``) talk to this server
unchanged. One server per host owns the card; every node process sends
its micro-batches here, and the server merges requests from many
processes into kernel-sized batches.

Server structure:
  reader threads   -- one per connection; decode framed requests into a
                      shared pending queue.
  scheduler thread -- holds the queue open from the OLDEST pending request
                      for up to coalesce_us, flushing early when pending
                      sigs reach max_sigs; whole requests only. It then runs
                      the host half of the device dispatch (pack_device),
                      which returns None for a batch the verifier routes to
                      its host tier (under device_min_sigs, gate closed,
                      mixed schemes, nothing well-formed).
  executor thread  -- runs verify_packed on the card, or verify_batch for a
                      batch that was not packed, and splits the answers per
                      request.
  depth-N buffering: a BoundedSemaphore(depth) between scheduler and
                      executor lets batch N+1 pack while batch N runs.

Wire protocol (little-endian, length-prefixed frames, unix path or
host:port):
  frame    := u32(len) payload
  request  := u8(op) u32(req_id) body
  OP_VERIFY  body:  u32(n)  pubkeys n*32  sigs n*64  u32 msg_len[n]  msgs
  OP_VERIFY  reply: u8(op) u32(req_id) u8(status) u8(tier)
                    f32(wait_s) f32(verify_s)  u8 ok[n]
                    (tier: 1 = the batch ran on the device, 0 = host tier)
  OP_STATS   reply: u8(op) u32(req_id) u8(status)  json(stats) utf-8
  OP_PING    reply: u8(op) u32(req_id) u8(status)
OP_VERIFY_QOS (QoS lanes) and OP_METRICS (Prometheus text) are not served
in this package yet: each gets a STATUS_ERR reply, never silence.

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
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from .provider import TorchVerifier, VerifyJob

OP_VERIFY = 1
OP_STATS = 2
OP_PING = 3
OP_VERIFY_QOS = 4
OP_METRICS = 5

STATUS_OK = 0
STATUS_ERR = 1

# One frame bounds one request: 64 MiB covers 65536 jobs with ~900-byte
# messages.
MAX_FRAME = 64 * 1024 * 1024

_FRAME_HDR = struct.Struct("<I")
_REQ_HDR = struct.Struct("<BI")
_VERIFY_REQ_HDR = struct.Struct("<BII")
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
        with self.lock:
            send_frame(self.conn, payload)


class _Pending:
    __slots__ = ("client", "req_id", "jobs", "received_at")

    def __init__(self, client: _Client, req_id: int, jobs: list[VerifyJob]):
        self.client = client
        self.req_id = req_id
        self.jobs = jobs
        self.received_at = time.perf_counter()


_STOP = object()


class SidecarServer:
    """The per-host verification server; it owns the card through its
    verifier (default ``TorchVerifier(device)``). ``device_min_sigs``, when
    given, is passed to the TorchVerifier the server builds (its size
    crossover); a caller that brings its own verifier sets it there."""

    def __init__(self, address: str, verifier=None, device: str = "cuda",
                 coalesce_us: int = 2000, max_sigs: int = 4096,
                 depth: int = 2, device_min_sigs: int | None = None):
        self.address = address
        if verifier is None:
            kw = ({} if device_min_sigs is None
                  else {"device_min_sigs": device_min_sigs})
            verifier = TorchVerifier(device=device, **kw)
        elif device_min_sigs is not None:
            raise ValueError("device_min_sigs applies to the verifier the "
                             "server builds: set it on the verifier passed in")
        self.verifier = verifier
        self.coalesce_us = int(coalesce_us)
        self.max_sigs = int(max_sigs)
        self.depth = int(depth)

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
        self.unsupported_ops = 0
        self.batch_sigs_hist: dict[int, int] = {}
        self.packed_batches = 0
        self.pack_s_total = 0.0
        self.wait_s_total = 0.0
        self.verify_s_total = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self, warm: bool = True) -> "SidecarServer":
        """Listen, optionally warm the verifier (builds the kernels before
        the first request is taken), and start the threads."""
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
                    with self._lock:
                        self.requests += 1
                    with self._cv:
                        self._pending.append(_Pending(client, req_id, jobs))
                        self._cv.notify_all()
                elif op == OP_STATS:
                    client.reply(_REPLY_HDR.pack(OP_STATS, req_id, STATUS_OK)
                                 + json.dumps(self.stats()).encode())
                elif op == OP_PING:
                    client.reply(_REPLY_HDR.pack(OP_PING, req_id, STATUS_OK))
                elif op in (OP_VERIFY_QOS, OP_METRICS):
                    self._reply_unsupported(client, op, req_id)
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

    def _reply_unsupported(self, client: _Client, op: int,
                           req_id: int) -> None:
        """STATUS_ERR for an op this server does not serve yet. A QoS
        verify is answered in the OP_VERIFY reply shape its clients parse,
        so they see the error (and degrade) instead of waiting out their
        deadline."""
        with self._lock:
            self.unsupported_ops += 1
        detail = (f"sidecar op {op} is not supported by the "
                  "corda_tpu_torch server").encode()
        if op == OP_VERIFY_QOS:
            head = _VERIFY_REPLY_HDR.pack(OP_VERIFY, req_id, STATUS_ERR, 0,
                                          0.0, 0.0)
        else:
            head = _REPLY_HDR.pack(op, req_id, STATUS_ERR)
        client.reply(head + detail)

    # -- coalescing scheduler ----------------------------------------------

    def _pending_sigs(self) -> int:
        return sum(len(p.jobs) for p in self._pending)

    def _scheduler(self) -> None:
        while True:
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
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch: list[_Pending] = []
                total = 0
                while self._pending and total < self.max_sigs:
                    p = self._pending.popleft()
                    batch.append(p)
                    total += len(p.jobs)
            # At most `depth` batches formed-or-running: backpressure that
            # keeps the scheduler one batch ahead of the executor.
            while not self._slots.acquire(timeout=0.2):
                if self._stop.is_set():
                    return
            if self._stop.is_set():
                self._slots.release()
                return
            jobs = [j for p in batch for j in p.jobs]
            t_pack = time.perf_counter()
            try:
                packed = self.verifier.pack_device(jobs)
                err = None
            except Exception as exc:  # noqa: BLE001 -- becomes an ERR reply
                packed, err = None, exc
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
            offset = 0
            for p in batch:
                n = len(p.jobs)
                head = _VERIFY_REPLY_HDR.pack(
                    OP_VERIFY, p.req_id,
                    STATUS_OK if err is None else STATUS_ERR, tier,
                    t0 - p.received_at, verify_s)
                if err is None:
                    body = ok[offset:offset + n].astype(np.uint8).tobytes()
                else:
                    body = repr(err).encode()[:512]
                offset += n
                try:
                    p.client.reply(head + body)
                except OSError:
                    pass  # client died mid-batch: it re-verifies itself
            self._slots.release()

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        v = self.verifier
        with self._lock:
            hist = {str(k): self.batch_sigs_hist[k]
                    for k in sorted(self.batch_sigs_hist)}
            return {
                "address": self.address,
                "verifier": getattr(v, "name", None),
                "kernel_backend": getattr(v, "kernel_backend", None),
                "requests": self.requests,
                "batches": self.batches,
                "sigs": self.sigs,
                "cross_request_batches": self.cross_request_batches,
                "errors": self.errors,
                "unsupported_ops": self.unsupported_ops,
                "batch_sigs_hist": hist,
                "device_batches": getattr(v, "device_batches", None),
                "host_batches": getattr(v, "host_batches", None),
                "device_min_sigs": getattr(v, "device_min_sigs", None),
                "packed_batches": self.packed_batches,
                "pack_s_total": round(self.pack_s_total, 6),
                # The port packs each batch to its exact size (the kernels
                # take any N), so no lane is ever padding.
                "pad_lanes": 0,
                "coalesce_us": self.coalesce_us,
                "max_sigs": self.max_sigs,
                "depth": self.depth,
                "wait_s_total": round(self.wait_s_total, 6),
                "verify_s_total": round(self.verify_s_total, 6),
            }


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="corda_tpu_torch verification sidecar: one "
                    "card-owning verify server per host")
    parser.add_argument("--socket", required=True,
                        help="unix socket path or host:port to listen on")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch versions)")
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
    args = parser.parse_args(argv)
    server = SidecarServer(args.socket, device=args.device,
                           coalesce_us=args.coalesce_us,
                           max_sigs=args.max_sigs, depth=args.depth,
                           device_min_sigs=args.device_min_sigs)
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
