"""X.509 certificates + dev-mode TLS material for the transport.

The port's own copy of ``corda_tpu/crypto/x509.py``.

Capability match for the reference's X509Utilities (reference:
core/src/main/kotlin/net/corda/core/crypto/X509Utilities.kt:44-48,223-309 —
ECDSA secp256r1 self-signed CA + TLS server certs, with dev-mode keystore
auto-generation at config/ConfigUtilities.kt configureWithDevSSLCertificate).
Here the same shape on Python's `cryptography`: a per-node self-signed CA
signs a TLS cert for the node's legal name; PEMs land in the node's base_dir
and feed ssl.SSLContext on both ends of the TCP transport.

Note the deliberate split the reference also has: ledger signatures are
Ed25519 (corda_tpu_torch/crypto/keys.py); ECDSA P-256 appears ONLY here, in
the transport-security layer. The certificates' names are the JAX
package's ("corda_tpu"), so a node of either package can mint the shared
dev CA that the other's nodes chain to.
"""

from __future__ import annotations

import datetime
import ipaddress
from pathlib import Path

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID


def _name(common_name: str) -> x509.Name:
    return x509.Name([
        x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "corda_tpu"),
    ])


_VALIDITY = datetime.timedelta(days=3650)


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(path)


def ensure_dev_ca(shared_dir: str | Path) -> tuple[Path, Path]:
    """Create (once) the network's shared dev root CA; returns
    (ca_cert_pem, ca_key_pem). All nodes of a dev network chain to this one
    root — the reference ships a well-known dev root the same way."""
    import os
    import time

    shared = Path(shared_dir)
    shared.mkdir(parents=True, exist_ok=True)
    ca_cert_path = shared / "dev-ca.pem"
    ca_key_path = shared / "dev-ca-key.pem"
    if ca_cert_path.exists() and ca_key_path.exists():
        return ca_cert_path, ca_key_path
    # Exactly ONE process may generate the CA: concurrent node starts racing
    # here would mint different roots and brick every TLS handshake. O_EXCL
    # elects the generator; losers wait for the files to appear.
    lock_path = shared / "dev-ca.lock"
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if ca_cert_path.exists() and ca_key_path.exists():
                return ca_cert_path, ca_key_path
            time.sleep(0.05)
        raise TimeoutError(
            f"dev CA generation by another process never finished "
            f"(stale {lock_path}? delete it to retry)")
    try:
        return _generate_ca(ca_cert_path, ca_key_path)
    except BaseException:
        # A crashed generation must not brick every later node start: drop
        # the lock so the next starter retries.
        try:
            os.unlink(lock_path)
        except OSError:
            pass
        raise


def _generate_ca(ca_cert_path: Path, ca_key_path: Path) -> tuple[Path, Path]:
    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = _name("corda_tpu Dev Root CA")
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name).issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now).not_valid_after(now + _VALIDITY)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    _write_atomic(ca_key_path, ca_key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    _write_atomic(ca_cert_path, ca_cert.public_bytes(
        serialization.Encoding.PEM))  # cert last: waiters key off it
    return ca_cert_path, ca_key_path


def generate_dev_tls_material(node_dir: str | Path, shared_dir: str | Path,
                              legal_name: str,
                              host: str = "127.0.0.1") -> dict[str, Path]:
    """Dev-mode TLS for one node: a cert for `legal_name` signed by the
    network's shared dev CA. Returns PEM paths {ca, cert, key}. Idempotent —
    existing files are reused (configureWithDevSSLCertificate capability)."""
    ca_cert_path, ca_key_path = ensure_dev_ca(shared_dir)
    base = Path(node_dir) / "certificates"
    base.mkdir(parents=True, exist_ok=True)
    paths = {"ca": ca_cert_path, "cert": base / "tls-cert.pem",
             "key": base / "tls-key.pem"}
    if paths["cert"].exists() and paths["key"].exists():
        return paths

    ca_cert = x509.load_pem_x509_certificate(ca_cert_path.read_bytes())
    ca_key = serialization.load_pem_private_key(
        ca_key_path.read_bytes(), password=None)
    now = datetime.datetime.now(datetime.timezone.utc)
    tls_key = ec.generate_private_key(ec.SECP256R1())
    san = [x509.IPAddress(ipaddress.ip_address(host))
           if _is_ip(host) else x509.DNSName(host)]
    tls_cert = (
        x509.CertificateBuilder()
        .subject_name(_name(legal_name)).issuer_name(ca_cert.subject)
        .public_key(tls_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now).not_valid_after(now + _VALIDITY)
        .add_extension(x509.SubjectAlternativeName(san), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    _write_atomic(paths["cert"],
                  tls_cert.public_bytes(serialization.Encoding.PEM))
    _write_atomic(paths["key"], tls_key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return paths


def _is_ip(host: str) -> bool:
    try:
        ipaddress.ip_address(host)
        return True
    except ValueError:
        return False
