"""Network permissioning: CSR submission, approval, and polling.

The port's own copy of ``corda_tpu/crypto/certsigning.py``.

Capability match for the reference's certificate-signing utilities
(reference: node/src/main/kotlin/net/corda/node/utilities/certsigning/
CertificateSigner.kt:28-80 — submit a PKCS#10 CSR to the network's
permissioning server, poll until approved, install the returned chain;
HTTPCertificateSigningService.kt — the HTTP wire protocol: POST
/api/certificate -> request id, GET /api/certificate/<id> -> 204 until
approved / the chain once approved / 401 when rejected;
CertificateSigningService.kt — the service interface).

This module supplies BOTH halves so a dev network is self-contained:

- :class:`CertificateSigningServer` — the authority. Holds the (dev) CA key,
  queues CSRs for approval (auto-approve for dev networks, explicit
  ``approve``/``reject`` for the doorman workflow the reference polls
  against), and serves signed chains as a PEM bundle (client cert first,
  root last — the chain order CertificateSigner.kt assumes).
- :class:`HttpCertificateSigningService` — the client-side service.
- :class:`CertificateSigner` — the node-side driver: create-or-load the
  node's TLS key, submit a CSR for its legal name, poll, install
  ``tls-cert.pem`` + ``ca.pem`` into the node directory (the same file
  layout ``x509.generate_dev_tls_material`` produces, so a node can swap
  dev-mode self-provisioning for doorman-issued certificates without any
  other change).
"""

from __future__ import annotations

import datetime
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib import error as urlerror
from urllib import request as urlrequest

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

_VALIDITY = datetime.timedelta(days=365)
CLIENT_VERSION = "1.0"


class CertificateRequestRejected(Exception):
    """The authority rejected the CSR (HTTP 401 in the reference protocol)."""


class CertificateSigningServer:
    """The permissioning authority (the reference's 'doorman' that
    HTTPCertificateSigningService talks to)."""

    def __init__(self, ca_cert_path: str | Path, ca_key_path: str | Path,
                 host: str = "127.0.0.1", port: int = 0,
                 auto_approve: bool = False):
        self._ca_cert = x509.load_pem_x509_certificate(
            Path(ca_cert_path).read_bytes())
        self._ca_key = serialization.load_pem_private_key(
            Path(ca_key_path).read_bytes(), password=None)
        self._lock = threading.Lock()
        self._pending: dict[str, x509.CertificateSigningRequest] = {}
        self._issued: dict[str, bytes] = {}
        self._rejected: set[str] = set()
        self.auto_approve = auto_approve
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                if self.path != "/api/certificate":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    request_id = server.submit(self.rfile.read(length))
                except Exception as e:
                    self.send_error(400, str(e)[:200])
                    return
                body = request_id.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                prefix = "/api/certificate/"
                if not self.path.startswith(prefix):
                    self.send_error(404)
                    return
                request_id = self.path[len(prefix):]
                status, body = server.poll(request_id)
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.address[0]}:{self.address[1]}"

    # -- authority operations ---------------------------------------------

    def submit(self, csr_der: bytes) -> str:
        csr = x509.load_der_x509_csr(csr_der)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        request_id = uuid.uuid4().hex
        with self._lock:
            self._pending[request_id] = csr
            if self.auto_approve:
                self._approve_locked(request_id)
        return request_id

    def approve(self, request_id: str) -> None:
        with self._lock:
            self._approve_locked(request_id)

    def reject(self, request_id: str) -> None:
        with self._lock:
            self._pending.pop(request_id, None)
            self._rejected.add(request_id)

    def pending_requests(self) -> dict[str, str]:
        """request id -> subject common name, for a doorman operator UI.
        A CSR without a CN (submit only checks the signature) lists as its
        full RFC4514 subject rather than crashing the whole listing."""
        out = {}
        with self._lock:
            for rid, csr in self._pending.items():
                cns = csr.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
                out[rid] = cns[0].value if cns else csr.subject.rfc4514_string()
        return out

    def _approve_locked(self, request_id: str) -> None:
        csr = self._pending.pop(request_id, None)
        if csr is None:
            raise KeyError(f"unknown or already-handled request {request_id}")
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self._ca_cert.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now).not_valid_after(now + _VALIDITY)
            .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                           critical=True)
            .add_extension(x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.SERVER_AUTH,
                 ExtendedKeyUsageOID.CLIENT_AUTH]), critical=False)
            .sign(self._ca_key, hashes.SHA256())
        )
        # Chain order per CertificateSigner.kt: client first, root last.
        chain = cert.public_bytes(serialization.Encoding.PEM) \
            + self._ca_cert.public_bytes(serialization.Encoding.PEM)
        self._issued[request_id] = chain

    def poll(self, request_id: str) -> tuple[int, bytes]:
        """(http status, body) per the reference protocol."""
        with self._lock:
            if request_id in self._issued:
                return 200, self._issued[request_id]
            if request_id in self._rejected:
                return 401, b""
            if request_id in self._pending:
                return 204, b""
        return 404, b""

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)


class HttpCertificateSigningService:
    """Client half (HTTPCertificateSigningService.kt)."""

    def __init__(self, server_url: str):
        self.server_url = server_url.rstrip("/")

    def submit_request(self, csr_der: bytes) -> str:
        req = urlrequest.Request(
            f"{self.server_url}/api/certificate", data=csr_der,
            headers={"Content-Type": "application/octet-stream",
                     "Client-Version": CLIENT_VERSION}, method="POST")
        with urlrequest.urlopen(req, timeout=10) as resp:
            return resp.read().decode()

    def retrieve_certificates(self, request_id: str) -> list | None:
        """Signed chain once approved; None while pending; raises
        CertificateRequestRejected on 401."""
        try:
            with urlrequest.urlopen(
                    f"{self.server_url}/api/certificate/{request_id}",
                    timeout=10) as resp:
                if resp.status == 204:
                    return None
                return x509.load_pem_x509_certificates(resp.read())
        except urlerror.HTTPError as e:
            if e.code == 401:
                raise CertificateRequestRejected(
                    "certificate signing request has been rejected; contact "
                    "the network administrator") from None
            raise


class CertificateSigner:
    """Node-side provisioning loop (CertificateSigner.kt buildKeyStore)."""

    def __init__(self, node_dir: str | Path, legal_name: str,
                 service: HttpCertificateSigningService,
                 poll_interval: float = 1.0):
        self.node_dir = Path(node_dir)
        self.legal_name = legal_name
        self.service = service
        self.poll_interval = poll_interval

    def build_key_store(self, timeout: float = 60.0) -> dict[str, Path]:
        """Ensure tls-key/tls-cert/ca PEMs exist, obtaining the certificate
        from the signing service if absent. Idempotent across restarts."""
        self.node_dir.mkdir(parents=True, exist_ok=True)
        key_path = self.node_dir / "tls-key.pem"
        cert_path = self.node_dir / "tls-cert.pem"
        ca_path = self.node_dir / "ca.pem"
        if key_path.exists() and cert_path.exists() and ca_path.exists():
            return {"key": key_path, "cert": cert_path, "ca": ca_path}

        if key_path.exists():  # crashed mid-provisioning: reuse the key
            key = serialization.load_pem_private_key(
                key_path.read_bytes(), password=None)
        else:
            key = ec.generate_private_key(ec.SECP256R1())
            key_path.write_bytes(key.private_bytes(
                serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))

        csr = (
            x509.CertificateSigningRequestBuilder()
            .subject_name(x509.Name([
                x509.NameAttribute(NameOID.COMMON_NAME, self.legal_name),
                x509.NameAttribute(NameOID.ORGANIZATION_NAME, "corda_tpu"),
            ]))
            .sign(key, hashes.SHA256())
        )
        request_id = self.service.submit_request(
            csr.public_bytes(serialization.Encoding.DER))
        deadline = time.monotonic() + timeout
        while True:
            chain = self.service.retrieve_certificates(request_id)
            if chain is not None:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"certificate request {request_id} not approved within "
                    f"{timeout}s")
            time.sleep(self.poll_interval)
        cert_path.write_bytes(
            chain[0].public_bytes(serialization.Encoding.PEM))
        ca_path.write_bytes(
            chain[-1].public_bytes(serialization.Encoding.PEM))
        return {"key": key_path, "cert": cert_path, "ca": ca_path}
