"""OpenSSL-accelerated host Ed25519 with oracle-exact semantics.

The port's own copy of ``corda_tpu/crypto/fast_ed25519.py`` (the port
imports nothing of ``corda_tpu``); the two must stay identical in
semantics.

The pure-Python oracle (`ref_ed25519`) defines the authoritative
accept/reject set, but costs ~4 ms per operation — which put host *signing*
(the notary's per-transaction signature, reference: NotaryFlow.kt:139) and
per-signature host checks on the framework's hot path at ~250 ops/s/core.
The reference's JVM stack ran the i2p EdDSA engine at 1-2k ops/s/core;
OpenSSL (via the `cryptography` wheel) does ~20k/s. This module is the host
fast path with semantics proofs:

* **sign / public_key** — RFC 8032 is fully deterministic, so OpenSSL's
  output is bit-identical to the oracle's; there is nothing to reconcile.

* **verify** — OpenSSL's accept set is a *subset* of the oracle's: both run
  the same cofactorless ref10 procedure (recompute R' = [S]B - [h]A,
  byte-compare against R), but OpenSSL additionally enforces S < L, which
  the oracle (matching i2p-eddsa 0.1.0) deliberately does not. Therefore:
  OpenSSL-accept ⇒ oracle-accept, so a fast accept is final; an OpenSSL
  reject might be an oracle-accept corner (S ≥ L), so rejects FALL BACK to
  the oracle for the authoritative answer. Valid signatures — the
  overwhelming common case — pay only the OpenSSL cost; invalid ones pay
  the oracle cost, which is acceptable (rejections are exceptional and the
  slow path is the authority).

If the `cryptography` wheel is missing, every call degrades to the oracle —
same results, reference speed.
"""

from __future__ import annotations

import functools

from . import ref_ed25519

try:  # pragma: no cover - exercised implicitly by every test run
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _AVAILABLE = True
except Exception:  # pragma: no cover
    _AVAILABLE = False
    import warnings

    # Degrading silently would be worse than crashing: host sign/verify
    # drops ~80x to the pure-Python oracle and nothing else would say why.
    # The operator should hear it exactly once.
    warnings.warn(
        "the 'cryptography' package is unavailable; corda_tpu_torch host "
        "signing/verification falls back to the pure-Python oracle "
        "(~80x slower)",
        RuntimeWarning,
        stacklevel=2,
    )


def available() -> bool:
    """True when the OpenSSL fast path is active."""
    return _AVAILABLE


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signature, bit-identical to ref_ed25519.sign. The parsed
    OpenSSL key object is memoised per seed: key parsing was measured at
    ~20% of a width-32 multi-sig build (one from_private_bytes per
    signature), and a loadgen client signs with the same handful of keys
    thousands of times."""
    if _AVAILABLE and len(seed) == 32:
        return _private_key_cached(bytes(seed)).sign(bytes(msg))
    return ref_ed25519.sign(seed, msg)


@functools.lru_cache(maxsize=4096)
def _private_key_cached(seed: bytes):
    return Ed25519PrivateKey.from_private_bytes(seed)


def public_key(seed: bytes) -> bytes:
    """RFC 8032 public-key derivation, bit-identical to the oracle."""
    if _AVAILABLE and len(seed) == 32:
        return (
            Ed25519PrivateKey.from_private_bytes(seed)
            .public_key()
            .public_bytes_raw()
        )
    return ref_ed25519.public_key(seed)


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Oracle-equivalent verification: fast accepts, authoritative rejects.

    The parsed public-key object is memoised: a node re-verifies the same
    small signer set all day (a width-32 multisig re-parses 32 keys per
    transaction), and from_public_bytes was measured at a large share of
    host verify cost under load."""
    if _AVAILABLE and len(pubkey) == 32 and len(sig) == 64:
        try:
            _public_key_cached(bytes(pubkey)).verify(bytes(sig), bytes(msg))
            return True  # OpenSSL-accept is a subset of oracle-accept
        # lint: allow(no-silent-except) the fallthrough IS the handler: any OpenSSL reject (bad sig or oracle-only corner) re-verifies against the authoritative oracle below
        except Exception:
            pass  # genuinely bad, or an oracle-only corner — ask the oracle
    return ref_ed25519.verify(pubkey, msg, sig)


@functools.lru_cache(maxsize=65536)
def _public_key_cached(pk: bytes):
    # Raises on a malformed key: lru_cache does not cache exceptions, and
    # verify()'s except-path hands those to the oracle for the
    # authoritative reject.
    return Ed25519PublicKey.from_public_bytes(pk)
