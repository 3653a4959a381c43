"""The node's HTTP API: status, metrics, attachment upload/download.

The port's own copy of ``corda_tpu/node/webserver.py``.

Capability match for the reference's web tier (reference:
node/src/main/kotlin/net/corda/node/internal/Node.kt:66-250 Jetty+Jersey,
node/.../api/APIServer.kt:27, servlets/DataUploadServlet.kt,
servlets/AttachmentDownloadServlet.kt, and the node-administration
endpoints): a small threaded HTTP server exposing

  GET  /api/status                 -> {"name", "address", "flows_in_flight"}
  GET  /api/metrics                -> the SMM metric registry + per-flow
                                      completion timings
  GET  /api/metrics/history        -> bounded counters time-series, newest
                                      first (the JMX/Jolokia capability,
                                      Node.kt:313)
  GET  /metrics                    -> the always-on telemetry registry in
                                      Prometheus text exposition format
                                      (obs/telemetry.py via obs/export.py)
  GET  /api/trace                  -> this node's span buffer (obs/trace.py)
                                      for the driver-side trace collector
  GET  /api/info                   -> identity + advertised services
  POST /upload/attachment          -> attachment id (content-addressed)
  GET  /attachments/<hex id>       -> the blob

Reads touch only thread-safe snapshots (metrics dict copies, sqlite-backed
attachment storage), so serving from the HTTP thread is safe next to the
node's single-threaded flow pump.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto.hashes import SecureHash


class NodeWebServer:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                try:
                    outer._get(self)
                except Exception as e:
                    self.send_error(500, str(e))

            def do_POST(self):
                try:
                    outer._post(self)
                except Exception as e:
                    self.send_error(500, str(e))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"web-{self.port}")
        self._thread.start()

    def _json(self, handler, payload, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _get(self, handler) -> None:
        node = self.node
        path = handler.path.rstrip("/")
        if path == "/api/status":
            self._json(handler, {
                "name": node.config.name,
                "address": str(node.messaging.my_address),
                "flows_in_flight": node.smm.in_flight_count,
            })
        elif path == "/api/metrics":
            # dict() is one atomic C-level copy; iterating the live dict
            # from this (webserver) thread while the node thread inserts
            # a new flow name would raise mid-comprehension.
            timings = dict(node.smm.flow_timings)
            self._json(handler, dict(node.smm.metrics)
                       | {"flow_timings": {k: dict(v)
                                           for k, v in timings.items()}})
        elif path == "/api/metrics/history":
            # Bounded time-series ring sampled by the run loop (the
            # JMX/Jolokia counters-over-time capability, Node.kt:313).
            # Newest-first: a dashboard polling "what just happened"
            # reads element 0, not element N, and a truncating client
            # keeps the recent half.
            self._json(handler, list(node.metrics_history)[::-1])
        elif path == "/metrics":
            # Prometheus text exposition (obs/export.py): the always-on
            # telemetry registry — every registered counter/histogram,
            # including series that have not fired yet.
            from ..obs.export import CONTENT_TYPE, render_prometheus

            body = render_prometheus().encode()
            handler.send_response(200)
            handler.send_header("Content-Type", CONTENT_TYPE)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path == "/api/trace":
            # This node's span buffer (obs/trace.py), JSON-safe; the
            # driver-side collector merges many of these into one Chrome
            # trace artifact. Empty shell when tracing is disarmed so
            # pollers need no special case.
            from ..obs import trace as _obs

            rec = _obs.ACTIVE
            self._json(handler, {
                "node": node.config.name,
                "armed": rec is not None,
                "spans": rec.snapshot() if rec is not None else [],
                "stats": rec.stats() if rec is not None else None,
            })
        elif path == "/api/info":
            self._json(handler, {
                "legal_identity": node.identity.name,
                "owning_key": node.identity.owning_key.to_base58_string(),
                "advertised_services": [
                    str(s.type) for s in node.info.advertised_services],
            })
        elif path.startswith("/attachments/"):
            try:
                att_id = SecureHash.parse(path.rsplit("/", 1)[1])
            except ValueError:
                handler.send_error(400, "bad attachment id")
                return
            att = node.services.storage_service.attachments \
                .open_attachment(att_id)
            if att is None:
                handler.send_error(404, "no such attachment")
                return
            blob = att.open()
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Content-Length", str(len(blob)))
            handler.end_headers()
            handler.wfile.write(blob)
        else:
            handler.send_error(404)

    def _post(self, handler) -> None:
        if handler.path.rstrip("/") != "/upload/attachment":
            handler.send_error(404)
            return
        length = int(handler.headers.get("Content-Length", 0))
        if length <= 0 or length > 64 * 1024 * 1024:
            handler.send_error(400, "bad Content-Length")
            return
        blob = handler.rfile.read(length)
        att_id = self.node.services.storage_service.attachments \
            .import_attachment(blob)
        self._json(handler, {"id": att_id.hex()})

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
