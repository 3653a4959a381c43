"""Frozen Ed25519 oracle: the benchmark's plain reference for every verdict.

A copy of the accept/reject semantics the system under test promises
(cofactorless ref10 verify, no S < L range check, y reduced mod p on
decompression, the recomputed R encoding compared with the raw R bytes),
kept here so that no change to the program can move the yardstick. It
imports nothing but hashlib. Slow by design (pure Python integers): the
benchmark runs it on a sample drawn from the seed, after the window.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "P", "L", "D", "B",
    "sign", "verify", "public_key", "decompress", "compress",
    "point_add", "point_double", "scalar_mult", "double_scalar_mult_sub",
]

# Curve constants (edwards25519): -x^2 + y^2 = 1 + d x^2 y^2 over F_p.
P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point B: y = 4/5, x recovered with even parity.
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """Recover x from y on edwards25519; None if y^2-1/(d y^2+1) is a non-residue.

    Mirrors ref10 ge_frombytes: candidate root via exponentiation by (p+3)/8,
    fix-up by sqrt(-1), no x==0/sign special case.
    """
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # x = u/v ^ ((p+3)/8) computed as u * v^3 * (u * v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P)) % P
    vxx = (v * x * x) % P
    if vxx == u:
        pass
    elif vxx == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x & 1 != sign:
        x = (-x) % P
    return x


_BX = _recover_x(_BY, 0)
B = (_BX, _BY)


# Extended coordinates (X:Y:Z:T) with x=X/Z, y=Y/Z, T=XY/Z — the same
# complete unified formulas the device kernels use (a=-1 twisted Edwards,
# complete because -1 is a square and d a non-square mod p).


def _to_ext(pt):
    x, y = pt
    return (x, y, 1, (x * y) % P)


def _from_ext(e):
    x, y, z, _ = e
    zi = pow(z, P - 2, P)
    return ((x * zi) % P, (y * zi) % P)


_EXT_ID = (0, 1, 1, 0)


def _ext_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % P
    b = ((y1 + x1) * (y2 + x2)) % P
    c = (2 * D * t1 * t2) % P
    dd = (2 * z1 * z2) % P
    e, f, g, h = (b - a) % P, (dd - c) % P, (dd + c) % P, (b + a) % P
    return ((e * f) % P, (g * h) % P, (f * g) % P, (e * h) % P)


def _ext_double(p):
    return _ext_add(p, p)


def point_add(p1, p2):
    """Affine twisted-Edwards addition (complete for edwards25519)."""
    return _from_ext(_ext_add(_to_ext(p1), _to_ext(p2)))


def point_double(p1):
    return point_add(p1, p1)


def scalar_mult(k: int, pt):
    """Double-and-add [k]pt; k may exceed L (reduced implicitly by group order)."""
    q = _EXT_ID
    e = _to_ext(pt)
    while k > 0:
        if k & 1:
            q = _ext_add(q, e)
        e = _ext_double(e)
        k >>= 1
    return _from_ext(q)


def double_scalar_mult_sub(s: int, h: int, a_pt):
    """[s]B - [h]A, the ref10 verification combination."""
    neg_a = ((-a_pt[0]) % P, a_pt[1])
    acc = _EXT_ID
    eb, ea = _to_ext(B), _to_ext(neg_a)
    while s > 0 or h > 0:
        if s & 1:
            acc = _ext_add(acc, eb)
        if h & 1:
            acc = _ext_add(acc, ea)
        eb, ea = _ext_double(eb), _ext_double(ea)
        s >>= 1
        h >>= 1
    return _from_ext(acc)


def compress(pt) -> bytes:
    x, y = pt
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(enc: bytes) -> tuple | None:
    """Decode a 32-byte point; reduces y mod p silently (ref10 semantics)."""
    if len(enc) != 32:
        return None
    n = int.from_bytes(enc, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


def _sha512_mod_l(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little") % L


def public_key(seed: bytes) -> bytes:
    """RFC 8032 public key derivation from a 32-byte seed."""
    if len(seed) != 32:
        raise ValueError(f"Ed25519 seed must be 32 bytes, got {len(seed)}")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return compress(scalar_mult(a, B))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signature (R_enc || S), 64 bytes."""
    if len(seed) != 32:
        raise ValueError(f"Ed25519 seed must be 32 bytes, got {len(seed)}")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    a_enc = compress(scalar_mult(a, B))
    r = _sha512_mod_l(prefix + msg)
    r_enc = compress(scalar_mult(r, B))
    s = (r + _sha512_mod_l(r_enc + a_enc + msg) * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless ref10-style verification. Never raises on malformed input.

    Matches the accept set of the reference's EdDSAEngine.verify (reference:
    core/.../crypto/CryptoUtilities.kt:90-96 wraps it; a `false`/exception both
    surface as rejection at SignedTransaction.verifySignatures, reference:
    core/.../transactions/SignedTransaction.kt:83-87).
    """
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    a_pt = decompress(pubkey)
    if a_pt is None:
        return False
    r_enc, s_enc = sig[:32], sig[32:]
    s = int.from_bytes(s_enc, "little")  # deliberately NO s < L check
    h = _sha512_mod_l(r_enc + pubkey + msg)
    r_check = double_scalar_mult_sub(s, h, a_pt)
    return compress(r_check) == r_enc
