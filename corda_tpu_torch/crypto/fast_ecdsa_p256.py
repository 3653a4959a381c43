"""OpenSSL-accelerated host ECDSA P-256 verify with oracle-exact semantics.

The port's own copy of ``corda_tpu/crypto/fast_ecdsa_p256.py`` (the port imports
nothing of ``corda_tpu``); the two must stay identical in semantics.

The pure-Python oracle (`ref_ecdsa_p256`) defines the authoritative
accept/reject set for the "ecdsa-p256" scheme tag but costs ~1 ms per
operation (textbook double-and-add), which would crawl on the mixed-scheme
batches the provider seam advertises (BASELINE.json north star; reference
scheme usage: core/src/main/kotlin/net/corda/core/crypto/
X509Utilities.kt:44-48). This is the host fast path, with a stricter
semantics argument than fast_ed25519 needs:

* **Structural gate is oracle-owned.** DER strictness differs between
  parsers in corner cases (long-form lengths, non-minimal integers,
  trailing bytes), and relying on OpenSSL's parser would make the accept
  set "whatever this OpenSSL build accepts". Instead every job is
  pre-parsed with the ORACLE's own parsers (`_parse_point`,
  `_parse_der_sig`, the [1, n-1] range checks). Anything they reject is
  rejected outright — bit-identical to the oracle, OpenSSL never consulted.

* **Scalar math is delegated.** Once the structure passed the oracle's
  gate, the remaining question is the ECDSA equation itself, on which both
  implementations agree by construction (same curve, same hash, no low-s
  rule on either side — JCA has none). An OpenSSL accept is therefore
  final. An OpenSSL reject *should* be authoritative too, but rejects are
  exceptional on honest traffic, so they re-check on the oracle anyway —
  the fallback costs nothing where it matters and makes the equivalence
  argument unconditional rather than resting on the no-divergence claim.

If the `cryptography` wheel is missing, every call degrades to the oracle —
same results, oracle speed (fast_ed25519 already warned loudly at import).
"""

from __future__ import annotations

import functools

from . import ref_ecdsa_p256

try:  # pragma: no cover - exercised implicitly by every test run
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives import hashes as _hashes

    _ECDSA_SHA256 = ec.ECDSA(_hashes.SHA256())  # reusable algorithm object
    _AVAILABLE = True
except Exception:  # pragma: no cover
    _AVAILABLE = False


def available() -> bool:
    """True when the OpenSSL fast path is active."""
    return _AVAILABLE


@functools.lru_cache(maxsize=65536)
def _public_key_cached(pub: bytes):
    # A node re-verifies the same small signer set (its peers' TLS identity
    # keys) all day; parsing is the dominant per-call cost after the math.
    # Raises on malformed input: lru_cache does not cache exceptions, and
    # callers only reach this after the oracle's point parser accepted.
    return ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256R1(), pub)


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Oracle-equivalent SHA256withECDSA verification (see module doc)."""
    pubkey, msg, sig = bytes(pubkey), bytes(msg), bytes(sig)
    if not _AVAILABLE:
        return ref_ecdsa_p256.verify(pubkey, msg, sig)
    # Oracle-owned structural gate: these three checks are exactly the
    # oracle's preamble, so any reject here IS the oracle's answer.
    if ref_ecdsa_p256._parse_point(pubkey) is None:
        return False
    parsed = ref_ecdsa_p256._parse_der_sig(sig)
    if parsed is None:
        return False
    r, s = parsed
    if not (1 <= r < ref_ecdsa_p256.N and 1 <= s < ref_ecdsa_p256.N):
        return False
    try:
        _public_key_cached(pubkey).verify(sig, msg, _ECDSA_SHA256)
        return True  # structure passed the oracle's gate; math is shared
    except Exception:
        # Exceptional path (honest traffic rarely rejects): let the oracle
        # give the authoritative answer rather than trusting OpenSSL's no.
        return ref_ecdsa_p256.verify(pubkey, msg, sig)
