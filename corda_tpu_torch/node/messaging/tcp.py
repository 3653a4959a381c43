"""TCP transport: durable per-peer outboxes, at-least-once delivery, dedupe.

Capability match for the reference's Artemis tier (reference:
node/src/main/kotlin/net/corda/node/services/messaging/ArtemisMessagingServer.kt:
105-140,252-266 — durable per-peer queues + store-and-forward bridges — and
NodeMessagingClient.kt:102-113 — persistent UUID dedupe), without the broker:
each node listens on a plain TCP socket and drives its own outbox bridges.

Delivery contract:
  * send() appends to a durable outbox (sqlite when a NodeDatabase is given)
    and returns — the peer being down never blocks or drops;
  * a background bridge per peer connects, replays the outbox in order, and
    deletes entries only when the peer ACKs — at-least-once;
  * the receiver ACKs only after the message has been *processed* by the
    node's handlers (mirroring the reference's ack-after-DB-commit,
    NodeMessagingClient.kt:136-150), so a crash between receive and process
    redelivers;
  * processed unique ids are recorded durably; redeliveries are ACKed but not
    re-dispatched (dedupe).

Threading: socket I/O runs on daemon threads; handler dispatch happens ONLY
inside pump()/run_forever() on the caller's thread — the single-threaded SMM
contract is preserved (reference rationale: Node.kt:70-107).

Wire format: 4-byte big-endian length + canonical-codec frame,
  ("msg", topic, session_id, unique_id, sender_host, sender_port, data)
  ("ack", unique_id)
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from ...obs import trace as _obs
from ...qos import context as _qos
from ...serialization.codec import DeserializationError, deserialize, register, serialize
from ...testing import faults as _faults
from .api import (
    DEFAULT_SESSION_ID,
    Message,
    MessageHandlerRegistration,
    MessagingService,
    TopicSession,
    fresh_message_id,
)


@register
@dataclass(frozen=True, order=True)
class TcpAddress:
    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class _Handler(MessageHandlerRegistration):
    topic: str
    session_id: int
    callback: Callable[[Message], None]


class _Outbox:
    """Durable (sqlite) or in-memory per-peer FIFO of unacked frames."""

    def __init__(self, db=None):
        self._db = db
        self._mem: list[tuple[int, str, bytes, bytes]] = []
        self._mem_seq = 0
        self._retired: list[bytes] = []  # ACKed ids awaiting node-thread delete
        self._lock = threading.Lock()
        # Burst accounting (exported via transport_stats): how well callers
        # amortize the per-append INSERT+commit into executemany bursts.
        self.stats = {"appends": 0, "bursts": 0, "burst_frames": 0,
                      "max_burst": 0}

    def append(self, peer: str, unique_id: bytes, frame: bytes) -> None:
        if self._db is not None:
            # lint: allow(no-blocking-under-lock) the outbox lock's purpose IS serializing writes on the shared sqlite connection (node thread vs bridge replay); contenders are sqlite writers, not latency-sensitive readers
            with self._lock:
                self.stats["appends"] += 1
                self._db.conn.execute(
                    "INSERT INTO outbox (peer, unique_id, blob) VALUES (?, ?, ?)",
                    (peer, unique_id, frame))
                self._db.commit()
        else:
            with self._lock:
                self.stats["appends"] += 1
                self._mem_seq += 1
                self._mem.append((self._mem_seq, peer, unique_id, frame))

    def append_many(self, peer: str,
                    entries: "list[tuple[bytes, bytes]]") -> None:
        """Burst form of append(): [(unique_id, frame), ...] lands in ONE
        executemany + ONE commit instead of an INSERT+commit (fsync, outside
        a round batch) per frame. Atomic: a crash between the executemany
        and the commit durability point rolls the WHOLE burst back — the
        caller's at-least-once resend replays it in full, never a prefix."""
        if not entries:
            return
        if self._db is not None:
            # lint: allow(no-blocking-under-lock) same sqlite write-serialization lock as append(): one burst transaction under the outbox's designated I/O lock
            with self._lock:
                self._record_burst(len(entries))
                self._db.conn.executemany(
                    "INSERT INTO outbox (peer, unique_id, blob) "
                    "VALUES (?, ?, ?)",
                    [(peer, u, f) for u, f in entries])
                self._db.commit()
        else:
            with self._lock:
                self._record_burst(len(entries))
                for u, f in entries:
                    self._mem_seq += 1
                    self._mem.append((self._mem_seq, peer, u, f))

    def _record_burst(self, n: int) -> None:
        self.stats["bursts"] += 1
        self.stats["burst_frames"] += n
        self.stats["max_burst"] = max(self.stats["max_burst"], n)

    def pending(self, peer: str) -> list[tuple[int, bytes, bytes]]:
        """[(seq, unique_id, frame)] in order for one peer (rows already
        ACK-retired but not yet deleted by the node thread are excluded)."""
        if self._db is not None:
            with self._lock:
                retired = set(self._retired)
            with self._db.aux_lock:
                rows = self._db.aux_conn.execute(
                    "SELECT seq, unique_id, blob FROM outbox WHERE peer = ? "
                    "ORDER BY seq", (peer,)).fetchall()
            return [(s, bytes(u), bytes(b)) for s, u, b in rows
                    if bytes(u) not in retired]
        with self._lock:
            return [(s, u, f) for s, p, u, f in self._mem if p == peer]

    def pending_after(self, peer: str, after_seq: int,
                      limit: int = 512) -> list[tuple[int, bytes, bytes]]:
        """Incremental form of pending(): only rows newer than after_seq —
        the replay loop polls this every 200 ms, and re-materialising the
        whole backlog each poll was O(backlog) of blob copies per peer."""
        if self._db is not None:
            with self._lock:
                retired = set(self._retired)
            with self._db.aux_lock:
                # Over-fetch by the retired count: the filter below runs
                # AFTER the SQL limit, and a window of retired-but-undeleted
                # rows must not mask a live frame sitting just beyond it.
                rows = self._db.aux_conn.execute(
                    "SELECT seq, unique_id, blob FROM outbox WHERE peer = ? "
                    "AND seq > ? ORDER BY seq LIMIT ?",
                    (peer, after_seq, limit + len(retired))).fetchall()
            return [(s, bytes(u), bytes(b)) for s, u, b in rows
                    if bytes(u) not in retired][:limit]
        with self._lock:
            return [(s, u, f) for s, p, u, f in self._mem
                    if p == peer and s > after_seq][:limit]

    def has_live(self, peer: str) -> bool:
        """Any row for `peer` that is NOT ACK-retired? The bridge's drain
        check must use this, not count(): retired rows linger until the
        node thread's flush_retired() delete, and a drain check that sees
        them spins the replay loop at full CPU (observed ~10k sqlite
        polls/s, starving the node thread's GIL) for up to a whole round
        interval after every burst."""
        return bool(self.pending_after(peer, 0, limit=1))

    def count(self, peer: str) -> int:
        """Pending-frame count WITHOUT materialising blobs (polled per
        heartbeat by consensus backpressure). May briefly overcount by the
        ACK-retired rows awaiting the node thread's delete — harmless for
        a thresholded backpressure signal."""
        if self._db is not None:
            with self._db.aux_lock:
                (n,) = self._db.aux_conn.execute(
                    "SELECT COUNT(*) FROM outbox WHERE peer = ?",
                    (peer,)).fetchone()
            return n
        with self._lock:
            return sum(1 for _, p, _, _ in self._mem if p == peer)

    def peers(self) -> set[str]:
        if self._db is not None:
            with self._db.aux_lock:
                rows = self._db.aux_conn.execute(
                    "SELECT DISTINCT peer FROM outbox").fetchall()
            return {r[0] for r in rows}
        with self._lock:
            return {p for _, p, _, _ in self._mem}

    def ack(self, unique_id: bytes) -> None:
        self.ack_many((unique_id,))

    def ack_many(self, unique_ids) -> None:
        """Retire delivered frames. Durable mode NEVER writes sqlite from
        the calling (bridge) thread: a second writer connection fighting
        the node thread's round transactions drove sqlite into busy-retry
        episodes that starved the bridges' own reads — the observed
        permanent one-directional delivery stalls under election churn.
        Ids queue here and the NODE thread deletes them in flush_retired()
        (single-writer architecture). Crash before the delete persists is
        safe: rows resend, the receiver dedupes and re-ACKs."""
        if self._db is not None:
            with self._lock:
                self._retired.extend(unique_ids)
        else:
            drop = set(unique_ids)
            with self._lock:
                self._mem = [e for e in self._mem if e[2] not in drop]

    def flush_retired(self) -> None:
        """Delete ACK-retired rows on the NODE thread's connection (called
        from pump/flush_round; rides the round batch when one is open).

        Takes db.lock: outside a round batch the shared connection may be
        mid-transaction on a foreign thread (webserver upload), and a bare
        commit here would make its half-built writes durable. Errors are
        absorbed — the rows stay, the frames resend, the receiver dedupes
        and re-ACKs (the same at-least-once recovery every other outbox
        failure path leans on)."""
        if self._db is None:
            return
        with self._lock:
            retired, self._retired = self._retired, []
        if not retired:
            return
        import sqlite3

        try:
            with self._db.lock:
                self._db.conn.executemany(
                    "DELETE FROM outbox WHERE unique_id = ?",
                    [(u,) for u in retired])
                self._db.commit()
        except (sqlite3.OperationalError, sqlite3.ProgrammingError):
            pass  # busy or closing: redelivery + dedupe retire them later


class _Dedupe:
    """Durable (sqlite) or in-memory set of processed message ids.

    The durable form keeps a process-lifetime in-memory mirror of every id
    recorded OR looked up this process, so the per-message hot path costs a
    set lookup; sqlite is consulted only on a cold miss (ids recorded by a
    previous process) and remains the durable truth."""

    def __init__(self, db=None):
        self._db = db
        self._mem: set[bytes] = set()
        self._round_recorded: list[bytes] = []
        self._lock = threading.Lock()

    def seen(self, unique_id: bytes) -> bool:
        with self._lock:
            if unique_id in self._mem:
                return True
        if self._db is None:
            return False
        # lint: allow(no-blocking-under-lock) dedupe lock serializes the sqlite read against concurrent record() writes on the same connection — it is this table's designated I/O lock
        with self._lock:
            row = self._db.conn.execute(
                "SELECT 1 FROM dedupe WHERE message_id = ?",
                (unique_id,)).fetchone()
            if row is not None:
                self._mem.add(unique_id)
            return row is not None

    def record(self, unique_id: bytes) -> None:
        # lint: allow(no-blocking-under-lock) the mem-mirror insert and the sqlite insert must be atomic vs seen(); this lock is the dedupe table's designated I/O serialization lock
        with self._lock:
            self._mem.add(unique_id)
            if self._db is not None:
                if self._db.in_batch:
                    # The sqlite row rides the round transaction; if the
                    # round aborts, the mirror entry must go with it or a
                    # redelivery would be swallowed un-durably.
                    self._round_recorded.append(unique_id)
                self._db.conn.execute(
                    "INSERT OR IGNORE INTO dedupe (message_id) VALUES (?)",
                    (unique_id,))
                self._db.commit()

    def round_committed(self) -> None:
        self._round_recorded.clear()

    def round_aborted(self) -> None:
        with self._lock:
            for unique_id in self._round_recorded:
                self._mem.discard(unique_id)
            self._round_recorded.clear()


def _send_frame(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(struct.pack(">I", len(frame)) + frame)


def _recv_frame(sock: socket.socket) -> bytes | None:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    if n > 64 * 1024 * 1024:
        raise DeserializationError(f"frame too large: {n}")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpMessaging(MessagingService):
    """One node's TCP endpoint. Call start() to listen, pump() to dispatch."""

    RETRY_BACKOFF = (0.05, 0.1, 0.2, 0.5, 1.0)  # then every 1s
    POISON_RETRIES = 50  # failed deliveries before a message is dropped
    # A frame written to a live connection but un-ACKed for this long is
    # assumed lost (e.g. the receiver dropped it without acking while other
    # traffic keeps the connection busy): reconnect and resend. Without
    # this, a lost frame on a busy connection only redelivered after a
    # reconnect that steady ACK traffic never triggers.
    STALE_RESEND_S = 5.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0, db=None,
                 tls: dict | None = None):
        # tls: {"ca": Path, "cert": Path, "key": Path} PEMs — mutual TLS
        # chained to the network's shared dev CA (the reference's
        # Artemis-over-TLS capability, ArtemisMessagingComponent tcpTransport
        # + X509Utilities.kt:223-309). None = plaintext.
        self._listen_host, self._listen_port = host, port
        self._tls_server_ctx = self._tls_client_ctx = None
        if tls is not None:
            import ssl

            server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            server_ctx.load_cert_chain(str(tls["cert"]), str(tls["key"]))
            server_ctx.load_verify_locations(str(tls["ca"]))
            server_ctx.verify_mode = ssl.CERT_REQUIRED  # mutual auth
            client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            client_ctx.load_cert_chain(str(tls["cert"]), str(tls["key"]))
            client_ctx.load_verify_locations(str(tls["ca"]))
            client_ctx.check_hostname = False  # identity = CA membership;
            # addresses are ephemeral in dev networks
            self._tls_server_ctx, self._tls_client_ctx = server_ctx, client_ctx
        self._db = db
        self._outbox = _Outbox(db)
        self._dedupe = _Dedupe(db)
        self._handlers: list[_Handler] = []
        # (reply_socket | None, Message) pairs awaiting dispatch on pump().
        self._inbound: "queue.Queue[tuple[Any, Message]]" = queue.Queue()
        self._pending_no_handler: list[tuple[Any, Message]] = []
        self._poison: dict[bytes, int] = {}  # unique_id -> failed tries
        self._server: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._bridges: dict[str, threading.Thread] = {}
        self._bridge_wakeups: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._running = False
        self._address: TcpAddress | None = None
        # Round-deferral state (db.batch() rounds): ACKs for messages whose
        # processing rode a still-open round transaction, and bridge wakeups
        # for frames whose outbox rows are not yet committed. Flushed by
        # flush_round() AFTER the round commit.
        self._deferred_acks: list[tuple[Any, bytes]] = []
        self._deferred_bridge_peers: set[str] = set()
        # Bridge writev accounting (see transport_stats). Bumped from every
        # bridge thread, read from the node/bench thread: the += below are
        # read-modify-write races without a guard, so all access goes
        # through _stats_lock (never held across I/O — counter writes only).
        self._stats_lock = threading.Lock()
        self._flush_stats = {"flushes": 0, "frames": 0, "max_frames": 0}
        # Redelivery accounting (see transport_stats): frames the dedupe
        # layer absorbed (sender resent something we already processed),
        # and poison messages dropped at the retry cap. Node-thread-only.
        self._redeliveries = 0
        self._poison_drops = 0
        self._stale_resends = 0  # bridge threads; guarded by _stats_lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TcpMessaging":
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self._listen_host, self._listen_port))
        self._server.listen(64)
        host, port = self._server.getsockname()
        self._address = TcpAddress(host, port)
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"tcp-accept-{port}")
        t.start()
        self._threads.append(t)
        # Resume bridges for peers with queued outbox entries (store-and-
        # forward across restarts, ArtemisMessagingServer.kt:252-266).
        for peer in self._outbox.peers():
            self._ensure_bridge(peer)
        return self

    def stop(self) -> None:
        self._running = False
        if self._server is not None:
            # shutdown() wakes a thread blocked in accept(); close() alone
            # leaves the fd (and the port) held by that syscall on Linux.
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        for ev in self._bridge_wakeups.values():
            ev.set()
        # Give the accept thread a beat to leave accept() so the port frees.
        for t in self._threads[:1]:
            t.join(timeout=1.0)

    @property
    def my_address(self) -> TcpAddress:
        if self._address is None:
            raise RuntimeError("start() first")
        return self._address

    # -- sending -----------------------------------------------------------

    def _wire_tuple(self, topic_session: TopicSession, unique_id: bytes,
                    data: bytes) -> tuple:
        """The "msg" wire tuple. 7 fields normally; when tracing is armed
        AND the sending thread carries a context, two fields (trace_id,
        span_id) ride at the end; when the QoS plane is armed AND the
        thread carries a QosContext, ONE packed-bytes field follows.
        Widths therefore land on 7/8/9/10, each unambiguous — readers
        accept all four, so mixed armed/disarmed clusters interoperate and
        the disabled path never grows a frame."""
        base = (
            "msg", topic_session.topic, topic_session.session_id, unique_id,
            self.my_address.host, self.my_address.port, data,
        )
        if _obs.ACTIVE is not None:
            ctx = _obs.get_context()
            if ctx is not None:
                base = base + (ctx[0], ctx[1])
        if _qos.ACTIVE is not None:
            qctx = _qos.get_context()
            if qctx is not None:
                base = base + (qctx.to_wire(),)
        return base

    def send(self, topic_session: TopicSession, data: bytes, to: Any) -> None:
        if not isinstance(to, TcpAddress):
            raise TypeError(f"TcpMessaging can only send to TcpAddress, got {to!r}")
        unique_id = fresh_message_id()
        frame = serialize(self._wire_tuple(topic_session, unique_id, data)).bytes
        peer = str(to)
        self._outbox.append(peer, unique_id, frame)
        if _faults.ACTIVE is not None:
            # Partition cut, send side: the durable row stays (heal means
            # redeliver, same as wire loss) but the bridge is not woken —
            # the bridge loop itself parks while the cut covers this peer.
            if _faults.fire_partition(self.my_address, peer):
                return
            if self._fault_send(peer, unique_id, frame):
                return
        if self._db is not None and self._db.in_batch:
            # The row isn't committed yet; bridges read via the aux
            # connection and would see nothing. Wake them after the round.
            self._deferred_bridge_peers.add(peer)
        else:
            self._ensure_bridge(peer)

    def _fault_send(self, peer: str, unique_id: bytes, frame: bytes) -> bool:
        """transport.send injection on the durable path. Returns True when
        the bridge wakeup should be skipped: the outbox row STAYS, so a
        "dropped" or "delayed" frame is redelivered by the bridge's ~1s
        fallback re-poll — this models wire loss with the durable layer
        recovering, which is exactly the contract under test."""
        act = _faults.ACTIVE.fire("transport.send")
        if act is None:
            return False
        action, _delay_s = act
        if action in ("drop", "delay", "reorder"):
            return True
        if action == "duplicate" and frame is not None:
            # Second outbox row, same unique_id: the receiver's dedupe
            # must absorb it.
            self._outbox.append(peer, unique_id, frame)
        return False

    def send_many(self, topic_session: TopicSession, datas, to: Any) -> None:
        """Burst send: every payload in `datas` goes to ONE peer through one
        outbox executemany (one commit/fsync outside round batches) and one
        bridge wakeup, instead of an append+wake per frame. Same delivery
        contract as send() — each frame keeps its own unique_id, so ACK/
        dedupe/redelivery are per-frame."""
        if not isinstance(to, TcpAddress):
            raise TypeError(
                f"TcpMessaging can only send to TcpAddress, got {to!r}")
        if not datas:
            return
        entries = []
        for data in datas:
            unique_id = fresh_message_id()
            entries.append((unique_id, serialize(
                self._wire_tuple(topic_session, unique_id, data)).bytes))
        peer = str(to)
        self._outbox.append_many(peer, entries)
        if _faults.ACTIVE is not None:
            if _faults.fire_partition(self.my_address, peer):
                return  # cut: rows stay, bridge stays parked until heal
            if self._fault_send(peer, None, None):
                return  # whole burst "lost"; the fallback re-poll redelivers
        if self._db is not None and self._db.in_batch:
            self._deferred_bridge_peers.add(peer)
        else:
            self._ensure_bridge(peer)

    def outbox_backlog(self, to) -> int:
        """Undelivered (un-ACKed) frames queued for a peer — lets protocols
        that generate large resendable payloads (raft snapshots) avoid
        stuffing the durable outbox of an unreachable peer."""
        return self._outbox.count(str(to))

    def _note_flush(self, n_frames: int) -> None:
        """Bridge-thread writev accounting. Multiple bridges flush
        concurrently; dict += is a read-modify-write race, so the bump
        happens under the dedicated stats lock (counter-only critical
        section — the sendall stays outside any lock)."""
        with self._stats_lock:
            st = self._flush_stats
            st["flushes"] += 1
            st["frames"] += n_frames
            st["max_frames"] = max(st["max_frames"], n_frames)

    def _note_stale_resend(self) -> None:
        with self._stats_lock:
            self._stale_resends += 1

    def transport_stats(self) -> dict:
        """Self-describing burst stamps: outbox append amortization (bursts
        via append_many vs singleton appends) and the bridge's writev-style
        multi-frame flushes. Outbox counters are bumped under the outbox
        lock; bridge counters under _stats_lock — exact, not approximate."""
        ob = self._outbox.stats
        with self._stats_lock:
            fl = dict(self._flush_stats)
            stale = self._stale_resends
        return {
            "outbox_appends": ob["appends"],
            "outbox_bursts": ob["bursts"],
            "outbox_burst_frames": ob["burst_frames"],
            "outbox_max_burst": ob["max_burst"],
            "outbox_burst_avg": (round(ob["burst_frames"] / ob["bursts"], 3)
                                 if ob["bursts"] else None),
            "bridge_flushes": fl["flushes"],
            "bridge_flush_frames": fl["frames"],
            "bridge_max_flush": fl["max_frames"],
            "bridge_flush_avg": (round(fl["frames"] / fl["flushes"], 3)
                                 if fl["flushes"] else None),
            # Redelivery / retry-cap surfacing: how hard the at-least-once
            # machinery is working (and whether the poison cap is biting).
            "redeliveries": self._redeliveries,
            "stale_resends": stale,
            "poison_pending": len(self._poison),
            "poison_drops": self._poison_drops,
            "poison_retry_limit": self.POISON_RETRIES,
            # Total frames enqueued for the wire: singleton appends plus
            # every member of an append_many burst. Divided by the
            # firehose's requested tx count this is frames-per-tx — the
            # client-side wire amortization the ingest plane targets.
            "frames_sent_total": ob["appends"] + ob["burst_frames"],
        }

    def _ensure_bridge(self, peer: str) -> None:
        with self._lock:
            ev = self._bridge_wakeups.setdefault(peer, threading.Event())
            ev.set()
            t = self._bridges.get(peer)
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._bridge_loop, args=(peer, ev),
                                     daemon=True, name=f"bridge-{peer}")
                self._bridges[peer] = t
                t.start()

    def _bridge_loop(self, peer: str, wakeup: threading.Event) -> None:
        """Store-and-forward bridge: replay the peer's outbox until empty,
        deleting on ACK; reconnect with backoff forever while running."""
        import sqlite3

        host, port_s = peer.rsplit(":", 1)
        attempt = 0
        while self._running:
            # Park across a held partition cut instead of churning the
            # connect/replay/stale-resend cycle (each cycle resends the
            # whole un-ACKed outbox into a void that never ACKs). A pure
            # QUERY — polling here must not advance the cut schedule.
            if _faults.ACTIVE is not None and _faults.partitioned(
                    self._address, peer):
                wakeup.clear()
                wakeup.wait(timeout=0.25)
                continue
            try:
                pending = self._outbox.pending(peer)
            except sqlite3.ProgrammingError:
                return  # db closed: the node is shutting down
            except sqlite3.OperationalError:
                pending = None  # transient lock contention: back off, retry
            if pending is None:
                wakeup.clear()
                wakeup.wait(timeout=0.05)
                continue
            if not pending:
                wakeup.clear()
                wakeup.wait(timeout=1.0)
                if not self._running:
                    return
                continue
            try:
                # wrap_socket() detaches the raw socket, so close the WRAPPED
                # one explicitly — the with-block alone would leak TLS fds.
                import contextlib

                with socket.create_connection((host, int(port_s)),
                                              timeout=5.0) as raw:
                    raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    sock = raw
                    if self._tls_client_ctx is not None:
                        sock = self._tls_client_ctx.wrap_socket(
                            raw, server_hostname=host)
                    with contextlib.closing(sock):
                        attempt = 0
                        self._replay_outbox(peer, sock, wakeup)
            except sqlite3.ProgrammingError:
                return  # db closed mid-replay: the node is shutting down
            except OSError:
                backoff = self.RETRY_BACKOFF[
                    min(attempt, len(self.RETRY_BACKOFF) - 1)]
                attempt += 1
                wakeup.clear()
                wakeup.wait(timeout=backoff)

    def _replay_outbox(self, peer: str, sock: socket.socket,
                       wakeup: threading.Event | None = None) -> None:
        """Stream outbox frames and consume ACKs concurrently (no head-of-line
        blocking: frames enqueued while earlier ones await ACK still go out).
        Raises OSError to trigger reconnect + redeliver when the peer stalls
        or drops. When the outbox drains, the connection is KEPT and the
        loop parks on the wakeup event: tearing it down per burst was
        measured at ~70 fresh TCP(+TLS) handshakes/s on a loaded raft
        leader — handshake latency and accept-thread churn on both sides of
        every hop.

        Frames are fetched INCREMENTALLY (seq > last sent) so steady-state
        polls touch only new rows; un-ACKed frames from this connection are
        tracked in `sent` and re-sent only after a reconnect."""
        sock.settimeout(0.2)
        sent: dict[bytes, float] = {}  # unique_id -> monotonic write time
        last_seq = 0
        idle_polls = 0
        last_stale_check = time.monotonic()
        while self._running:
            # Stale-resend guard: a frame can be lost AFTER the socket write
            # (receiver dropped it without acking) while steady ACK traffic
            # for other frames keeps idle_polls at zero — without this check
            # such a frame would only redeliver on a reconnect that never
            # comes. Checked at most once a second.
            now = time.monotonic()
            if sent and now - last_stale_check > 1.0:
                last_stale_check = now
                # A cut that armed while this connection was warm: exit to
                # the bridge loop's partition park NOW (plain OSError, not
                # a stale resend — the cut is known, not suspected; without
                # this the loop would burn a full STALE_RESEND_S window
                # resending the outbox into the void once per window).
                if _faults.ACTIVE is not None and _faults.partitioned(
                        self._address, peer):
                    raise OSError("partition cut covers peer")
                if now - min(sent.values()) > self.STALE_RESEND_S:
                    self._note_stale_resend()
                    raise OSError("frames un-ACKed past stale-resend window")
            batch = self._outbox.pending_after(peer, last_seq)
            if not batch and not sent:
                # Clear BEFORE the liveness check: a frame enqueued (and
                # the event set) between has_live() and clear() would be
                # erased and sit undelivered until the fallback re-poll.
                if wakeup is not None:
                    wakeup.clear()
                if not self._outbox.has_live(peer):
                    # Drained: every remaining row is ACK-retired and only
                    # awaits the node thread's delete. (count() would see
                    # those rows and spin this loop at full CPU.) Park on
                    # the wakeup with the connection warm; fall back to a
                    # liveness re-check every second.
                    if wakeup is None:
                        return
                    wakeup.wait(timeout=1.0)
                    continue
                # Live rows at/below last_seq remain un-ACKed from a
                # PREVIOUS connection: resend them once from scratch.
                last_seq = 0
                sent.clear()
                continue
            # writev-style flush: the whole un-sent batch concatenates into
            # one buffer and hits the socket with ONE sendall per bridge
            # wakeup — a burst previously paid a syscall (and, pre-Nagle-off,
            # a potential segment) per frame.
            buf = bytearray()
            n_frames = 0
            write_at = time.monotonic()
            for seq, unique_id, frame in batch:
                if unique_id not in sent:
                    buf += struct.pack(">I", len(frame))
                    buf += frame
                    n_frames += 1
                    sent[unique_id] = write_at
                last_seq = max(last_seq, seq)
            if buf:
                sock.sendall(buf)
                self._note_flush(n_frames)
            try:
                frame = _recv_frame(sock)
                if frame is None:
                    raise OSError("peer closed during ack wait")
                decoded = deserialize(frame)
                if (isinstance(decoded, tuple) and len(decoded) == 2
                        and decoded[0] == "ack"
                        and isinstance(decoded[1], bytes)):
                    self._outbox.ack(decoded[1])
                    sent.pop(decoded[1], None)
                elif (isinstance(decoded, tuple) and len(decoded) == 2
                        and decoded[0] == "acks"
                        and isinstance(decoded[1], tuple)):
                    # Round-coalesced ACK frame (one per connection per
                    # receiver round): retired in one sqlite transaction.
                    ids = [u for u in decoded[1] if isinstance(u, bytes)]
                    self._outbox.ack_many(ids)
                    for u in ids:
                        sent.pop(u, None)
                idle_polls = 0
            except socket.timeout:
                idle_polls += 1
                if sent and idle_polls > 50:  # ~10s outstanding, no ACK
                    raise OSError("peer not acking")
            except DeserializationError as e:
                # A peer speaking garbage (unframeable stream or undecodable
                # frame) is as dead as a closed one: reconnect + redeliver
                # rather than killing the bridge thread.
                raise OSError(f"unreadable ack stream: {e}") from e

    # -- receiving ---------------------------------------------------------

    def _accept_loop(self) -> None:
        try:
            # Poll _running via timeout; also frees the port fast on stop.
            self._server.settimeout(0.5)
        except OSError:
            return  # stop() closed the socket before this thread ran
        while self._running:
            try:
                conn, _addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                # Frames are small and latency-sensitive (session messages,
                # ACKs): Nagle + delayed-ACK interplay would add up to 40 ms
                # per exchange on the notary round trip.
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            # TLS handshake (if any) happens on the per-connection reader
            # thread — a stalled peer must not head-of-line block accept().
            t = threading.Thread(target=self._serve_connection, args=(conn,),
                                 daemon=True)
            t.start()
            # Prune finished reader threads so repeated connect/drop cycles
            # (port scanners) don't grow this list without bound.
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_connection(self, conn: socket.socket) -> None:
        if self._tls_server_ctx is not None:
            try:
                conn.settimeout(5.0)
                conn = self._tls_server_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (OSError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass
                return  # plaintext/un-CA'd peers are refused
        self._reader_loop(conn)

    def _reader_loop(self, conn: socket.socket) -> None:
        try:
            while self._running:
                frame = _recv_frame(conn)
                if frame is None:
                    return
                try:
                    decoded = deserialize(frame)
                    kind = decoded[0]
                    if kind != "msg":
                        continue
                    # 7 fields plain; +2 (trace_id/span_id) when the sender
                    # had tracing armed; +1 packed QosContext when the QoS
                    # plane was armed. Widths 7/8/9/10 are all valid and
                    # unambiguous (trace always precedes qos).
                    width = len(decoded)
                    trace = None
                    qos = None
                    (_, topic, session_id, unique_id, shost, sport,
                     data) = decoded[:7]
                    if width in (9, 10):
                        w_trace, w_span = decoded[7], decoded[8]
                        if not (isinstance(w_trace, bytes)
                                and isinstance(w_span, bytes)):
                            continue
                        trace = (w_trace, w_span)
                    if width in (8, 10):
                        qos = _qos.QosContext.from_wire(decoded[width - 1])
                        if qos is None:
                            continue  # malformed QoS field: junk frame
                    elif width not in (7, 9):
                        continue
                    # Field TYPES are part of the wire contract: hostile
                    # well-formed frames with wrong-typed fields must die
                    # here, not on the node's pump thread (dedupe hashes
                    # unique_id; TopicSession expects str/int).
                    if not (isinstance(topic, str)
                            and isinstance(session_id, int)
                            and isinstance(unique_id, bytes)
                            and isinstance(shost, str)
                            and isinstance(sport, int)):
                        continue
                except (DeserializationError, ValueError, IndexError,
                        TypeError, KeyError):
                    # Junk from the wire — including well-framed frames that
                    # decode to a non-sequence — drop, never crash.
                    continue
                message = Message(
                    topic_session=TopicSession(topic, session_id),
                    data=data,
                    unique_id=unique_id,
                    sender=TcpAddress(shost, sport),
                    trace=trace,
                    qos=qos,
                )
                self._inbound.put((conn, message))
        except (OSError, DeserializationError):
            # Unreadable socket or unframeable stream (port scanners,
            # oversized length prefixes): drop the connection, never the
            # thread — the finally below closes it.
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- dispatch (caller thread) ------------------------------------------

    def add_message_handler(
        self,
        topic: str,
        session_id: int = DEFAULT_SESSION_ID,
        callback: Callable[[Message], None] = None,
    ) -> MessageHandlerRegistration:
        assert callback is not None
        handler = _Handler(topic, session_id, callback)
        self._handlers.append(handler)
        # Requeue messages that arrived before this handler registered.
        pending, self._pending_no_handler = self._pending_no_handler, []
        for item in pending:
            self._inbound.put(item)
        return handler

    def remove_message_handler(self, registration: MessageHandlerRegistration) -> None:
        self._handlers.remove(registration)

    def pump(self, timeout: float = 0.0, max_messages: int | None = None,
             coalesce: float = 0.0) -> int:
        """Dispatch queued inbound messages on THIS thread; ACK after
        processing. Returns number dispatched. timeout>0 blocks for the
        first message. max_messages bounds one pump call so a round (and its
        db transaction, which holds the sqlite write lock) stays short under
        firehose load — leftover messages are dispatched next round.

        coalesce>0: once the first message wakes the round, keep draining
        (blocking) for up to that many seconds from its arrival — each
        round costs a commit/fsync, per-connection ACK frames and (leader)
        an AppendEntries broadcast, and wake-per-message pays all three per
        message under trickle load."""
        self._outbox.flush_retired()  # node thread: the ONE sqlite writer
        n = attempts = 0
        window_end = None
        while True:
            if max_messages is not None and attempts >= max_messages:
                return n
            first_blocking = attempts == 0 and timeout > 0
            if first_blocking:
                block, wait = True, timeout
            elif window_end is not None:
                wait = window_end - time.monotonic()
                if wait <= 0:
                    block, wait = False, None
                else:
                    block = True
            else:
                block, wait = False, None
            try:
                conn, message = self._inbound.get(block=block, timeout=wait)
            except queue.Empty:
                return n
            if attempts == 0 and coalesce > 0:
                window_end = time.monotonic() + coalesce
            attempts += 1
            if self._dispatch(conn, message):
                n += 1

    def _dispatch(self, conn, message: Message) -> bool:
        if _faults.ACTIVE is not None:
            # Partition cut, recv side — the authoritative enforcement (a
            # frame that slipped out before the cut armed still dies
            # here). No ack, no dedupe record: after heal the sender's
            # durable outbox redelivers, preserving at-least-once.
            if message.sender is not None and _faults.fire_partition(
                    message.sender, self._address):
                return False
            act = _faults.ACTIVE.fire("transport.recv")
            if act is not None:
                action, delay_s = act
                if action == "drop":
                    # No ack, no dedupe record: the sender's stale-resend
                    # window (STALE_RESEND_S) redelivers it.
                    return False
                if action == "delay" and delay_s > 0:
                    time.sleep(delay_s)  # slow-consumer fault: stalls pump
        if self._dedupe.seen(message.unique_id):
            self._redeliveries += 1
            self._ack(conn, message.unique_id)  # redelivery: ack, don't re-run
            return False
        handlers = [h for h in self._handlers
                    if h.topic == message.topic_session.topic
                    and h.session_id == message.topic_session.session_id]
        if not handlers:
            # Park until a handler registers — but ACK now, mirroring the
            # in-memory tier's semantics (parked messages live in RAM there
            # too) and the reference's consume-then-discard of unroutable
            # session messages (StateMachineManager.kt "unknown session").
            # Without the ACK a dead session's trailing SessionEnd would
            # wedge the sender's bridge behind an ACK that never comes.
            self._pending_no_handler.append((conn, message))
            self._ack(conn, message.unique_id)
            return False
        import logging

        succeeded = failed = 0
        for h in handlers:  # per-handler isolation: one failure must not
            try:            # skip later handlers or kill the node's pump
                h.callback(message)
                succeeded += 1
            except Exception:
                failed += 1
                logging.getLogger(__name__).exception(
                    "handler failed for %s", message.topic_session)
        if failed and not succeeded:
            # Nothing processed: do NOT ack — the sender redelivers, giving
            # transient failures (e.g. a SessionInit arriving before the
            # network map knows the peer) time to resolve. A poison message
            # that fails deterministically is dropped after a retry budget
            # instead of redelivering forever.
            tries = self._poison.get(message.unique_id, 0) + 1
            if tries < self.POISON_RETRIES:
                self._poison[message.unique_id] = tries
                return False
            logging.getLogger(__name__).error(
                "dropping poison message on %s after %d failed deliveries",
                message.topic_session, tries)
            self._poison.pop(message.unique_id, None)
            self._poison_drops += 1
        # Processed (or poison-dropped): record id durably, THEN ack (crash
        # before this point means the sender redelivers; crash after means
        # dedupe swallows it). If SOME handlers succeeded and others failed,
        # we still ack — re-running the successful ones would duplicate side
        # effects, which is worse than dropping the failed delivery (every
        # production topic here has exactly one handler anyway).
        self._poison.pop(message.unique_id, None)
        self._dedupe.record(message.unique_id)
        if self._db is not None and self._db.in_batch:
            # The dedupe record (and everything processing wrote) commits at
            # round end; ACKing before that commit would let a crash lose
            # the message with the sender believing it delivered.
            self._deferred_acks.append((conn, message.unique_id))
        else:
            self._ack(conn, message.unique_id)
        return succeeded > 0

    def flush_round(self) -> None:
        """Release round-deferred effects. MUST be called after the round's
        db.batch() commit: sends the ACKs for every message processed in the
        round and wakes bridges for frames the round enqueued.

        ACKs COALESCE per connection — one ("acks", ids...) frame instead of
        up to max_messages frames: at firehose load the per-ACK serialize +
        sendall was the single hottest item in the round profile."""
        self._dedupe.round_committed()
        self._outbox.flush_retired()
        acks, self._deferred_acks = self._deferred_acks, []
        by_conn: dict[int, tuple[Any, list[bytes]]] = {}
        for conn, unique_id in acks:
            if conn is None:
                continue
            by_conn.setdefault(id(conn), (conn, []))[1].append(unique_id)
        for conn, ids in by_conn.values():
            try:
                if len(ids) == 1:
                    _send_frame(conn, serialize(("ack", ids[0])).bytes)
                else:
                    _send_frame(conn, serialize(("acks", tuple(ids))).bytes)
            except OSError:
                pass  # sender gone; it will reconnect and redeliver
        peers, self._deferred_bridge_peers = self._deferred_bridge_peers, set()
        for peer in peers:
            self._ensure_bridge(peer)

    def abort_round(self) -> None:
        """Discard round-deferred effects after a ROLLED-BACK round: the
        deferred ACKs must never be sent (their messages' processing was
        rolled back — the senders must redeliver) and the dedupe mirror
        unwinds the round's entries."""
        self._dedupe.round_aborted()
        self._deferred_acks.clear()
        self._deferred_bridge_peers.clear()

    def _ack(self, conn, unique_id: bytes) -> None:
        if conn is None:
            return
        try:
            _send_frame(conn, serialize(("ack", unique_id)).bytes)
        except OSError:
            pass  # sender gone; it will reconnect and redeliver
