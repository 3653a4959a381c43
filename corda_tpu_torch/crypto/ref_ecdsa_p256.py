"""Pure-Python ECDSA secp256r1 (P-256) verification — the conformance oracle.

The port's own copy of ``corda_tpu/crypto/ref_ecdsa_p256.py`` (the port imports
nothing of ``corda_tpu``); the two must stay identical in semantics.

Reference scope: the snapshot uses SHA256withECDSA on secp256r1 ONLY for
TLS/X.509 certificate signatures (reference: core/src/main/kotlin/net/corda/
core/crypto/X509Utilities.kt:44-48,223-233); every ledger signature is
Ed25519. BASELINE.json's north star nonetheless names mixed-scheme batches,
so the provider seam (crypto/provider.py VerifyJob.scheme) routes
"ecdsa-p256" jobs here. This module is the authoritative accept set —
dependency-free, like ref_ed25519 — with the OpenSSL path (when the
`cryptography` wheel is present) serving as an interop cross-check in tests.

Wire formats match the JCA/BouncyCastle usage the reference implies:
  * public key: SEC1 uncompressed point, 65 bytes 0x04 || X || Y;
  * signature: strict DER SEQUENCE { INTEGER r, INTEGER s } (the encoding
    JCA emits); any malformation REJECTS — never raises;
  * message: hashed with SHA-256 (SHA256withECDSA).
Any s in [1, n-1] is accepted (no low-s rule — JCA has none).
"""

from __future__ import annotations

import hashlib

# NIST P-256 / secp256r1 domain parameters (FIPS 186-4 D.1.2.3).
P = 0xffffffff00000001000000000000000000000000ffffffffffffffffffffffff
N = 0xffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551
A = P - 3
B = 0x5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b
GX = 0x6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945d898c296
GY = 0x4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb6406837bf51f5

_INF = None  # point at infinity


def _on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + A * x + B)) % P == 0


def _add(p1, p2):
    if p1 is _INF:
        return p2
    if p2 is _INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return _INF
        m = (3 * x1 * x1 + A) * pow(2 * y1, P - 2, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (m * m - x1 - x2) % P
    return (x3, (m * (x1 - x3) - y1) % P)


def _mul(k: int, point):
    acc = _INF
    addend = point
    while k:
        if k & 1:
            acc = _add(acc, addend)
        addend = _add(addend, addend)
        k >>= 1
    return acc


def _parse_point(pub: bytes):
    """SEC1 uncompressed point -> (x, y), or None if malformed/off-curve."""
    if len(pub) != 65 or pub[0] != 0x04:
        return None
    x = int.from_bytes(pub[1:33], "big")
    y = int.from_bytes(pub[33:65], "big")
    if x >= P or y >= P or not _on_curve(x, y):
        return None
    return (x, y)


def _parse_der_sig(sig: bytes):
    """Strict DER SEQUENCE{INTEGER r, INTEGER s} -> (r, s), or None."""

    def parse_int(buf: bytes, at: int):
        if at + 2 > len(buf) or buf[at] != 0x02:
            return None
        length = buf[at + 1]
        if length & 0x80 or length == 0:  # no long/empty form for 256-bit ints
            return None
        start = at + 2
        end = start + length
        if end > len(buf):
            return None
        body = buf[start:end]
        if body[0] & 0x80:
            return None  # negative: invalid for r/s
        if len(body) > 1 and body[0] == 0 and not body[1] & 0x80:
            return None  # non-minimal encoding
        return int.from_bytes(body, "big"), end

    if len(sig) < 8 or sig[0] != 0x30:
        return None
    total = sig[1]
    if total & 0x80 or 2 + total != len(sig):
        return None
    got = parse_int(sig, 2)
    if got is None:
        return None
    r, at = got
    got = parse_int(sig, at)
    if got is None:
        return None
    s, at = got
    if at != len(sig):
        return None
    return (r, s)


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """SHA256withECDSA verification; malformed anything rejects."""
    try:
        q = _parse_point(bytes(pubkey))
        if q is None:
            return False
        parsed = _parse_der_sig(bytes(sig))
        if parsed is None:
            return False
        r, s = parsed
        if not (1 <= r < N and 1 <= s < N):
            return False
        e = int.from_bytes(hashlib.sha256(bytes(msg)).digest(), "big")
        w = pow(s, N - 2, N)
        u1 = (e * w) % N
        u2 = (r * w) % N
        point = _add(_mul(u1, (GX, GY)), _mul(u2, q))
        if point is _INF:
            return False
        return point[0] % N == r
    except Exception:
        return False
