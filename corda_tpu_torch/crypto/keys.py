"""Key pairs and digital signatures (host control plane).

The port's own copy of ``corda_tpu/crypto/keys.py``; signing goes through
the port's ``fast_ed25519`` copy.

Capability match for the reference's signing helpers (reference:
core/src/main/kotlin/net/corda/core/crypto/CryptoUtilities.kt:27-110). As in
the reference snapshot, transaction signing is hardwired to Ed25519 — the
reference's helpers are (confusingly) named signWithECDSA/verifyWithECDSA but
construct an EdDSA engine (CryptoUtilities.kt:63-96). Here the naming is
honest: sign/verify, Ed25519.

The *batched* verification path — the notary hot loop — does not live here; it
is the CUDA kernel behind ops/ed25519.py and the provider seam in
crypto/provider.py. This module is the per-signature host path and shares
its accept/reject semantics with the kernel via the common oracle
(crypto/ref_ed25519.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable

from ..utils.bytes import OpaqueBytes
from . import fast_ed25519
from . import base58

if TYPE_CHECKING:  # circular: party -> composite -> keys
    from .party import Party


from ..utils.excheckpoint import register_flow_exception


@register_flow_exception
class SignatureError(Exception):
    """Raised when a signature fails to verify (reference: SignatureException)."""


@dataclass(frozen=True, order=True)
class PublicKey:
    """An Ed25519 public key: the 32-byte point encoding.

    Reference equivalent: EdDSAPublicKey (i2p) as used throughout
    CryptoUtilities.kt.
    """

    encoded: bytes
    algorithm: str = "Ed25519"

    def __post_init__(self):
        if self.algorithm == "Ed25519" and len(self.encoded) != 32:
            raise ValueError(f"Ed25519 public key must be 32 bytes, got {len(self.encoded)}")

    def to_base58(self) -> str:
        return base58.encode(self.encoded)

    def to_string_short(self) -> str:
        """'DL' + base58, as the reference renders keys (CryptoUtilities.kt:104-108)."""
        return "DL" + self.to_base58()

    @property
    def composite(self):
        """Wrap in a single-leaf CompositeKey (CryptoUtilities.kt:110)."""
        from .composite import CompositeKey

        return CompositeKey.leaf(self)

    def verify(self, content: bytes, signature: "DigitalSignature") -> None:
        """Verify or raise SignatureError (CryptoUtilities.kt:96-101 semantics).

        Host fast path (fast_ed25519: OpenSSL accept, oracle-authoritative
        reject) — bit-identical accept/reject to the ref_ed25519 oracle."""
        if not fast_ed25519.verify(self.encoded, content, signature.bytes):
            raise SignatureError("Signature did not match")

    def is_valid(self, content: bytes, signature: "DigitalSignature") -> bool:
        return fast_ed25519.verify(self.encoded, content, signature.bytes)

    def __repr__(self) -> str:
        return self.to_string_short()


NULL_PUBLIC_KEY = PublicKey(b"\x00", algorithm="NULL")


@dataclass(frozen=True)
class PrivateKey:
    """An Ed25519 private key (32-byte RFC 8032 seed)."""

    seed: bytes

    def __post_init__(self):
        if len(self.seed) != 32:
            raise ValueError(f"Ed25519 seed must be 32 bytes, got {len(self.seed)}")

    def sign(self, content: bytes) -> "DigitalSignature":
        # fast_ed25519.sign is bit-identical to the oracle (RFC 8032 is
        # deterministic) at ~50x the speed — the notary's per-commit
        # signature is on the framework hot path.
        return DigitalSignature(fast_ed25519.sign(self.seed, content))

    def sign_with_key(self, content: bytes, public_key: PublicKey) -> "DigitalSignature.WithKey":
        return DigitalSignature.WithKey(by=public_key, bytes=self.sign(content).bytes)

    def __repr__(self) -> str:
        return "PrivateKey(…)"


@dataclass(frozen=True)
class KeyPair:
    """A public/private Ed25519 key pair."""

    public: PublicKey
    private: PrivateKey

    @staticmethod
    def generate(entropy: bytes | None = None) -> "KeyPair":
        seed = entropy if entropy is not None else os.urandom(32)
        if len(seed) != 32:
            raise ValueError("entropy must be 32 bytes")
        return KeyPair(PublicKey(fast_ed25519.public_key(seed)), PrivateKey(seed))

    def sign(self, content: bytes) -> "DigitalSignature.WithKey":
        return self.private.sign_with_key(
            content if isinstance(content, bytes) else bytes(content), self.public
        )

    def sign_as(self, content: bytes, party: "Party") -> "DigitalSignature.LegallyIdentifiable":
        """Sign identifying the signing Party (CryptoUtilities.kt:85-90)."""
        if self.public not in party.owning_key.keys:
            raise ValueError("key pair does not belong to party")
        return DigitalSignature.LegallyIdentifiable(
            by=self.public, bytes=self.sign(content).bytes, signer=party
        )


@dataclass(frozen=True)
class DigitalSignature(OpaqueBytes):
    """A raw 64-byte Ed25519 signature (CryptoUtilities.kt:27-36)."""

    @dataclass(frozen=True)
    class WithKey(OpaqueBytes):
        """A signature together with the public key that (allegedly) made it."""

        by: PublicKey = None  # type: ignore[assignment]

        def verify(self, content: bytes) -> None:
            self.by.verify(
                content if isinstance(content, bytes) else bytes(content),
                DigitalSignature(self.bytes),
            )

        def is_valid(self, content: bytes) -> bool:
            return self.by.is_valid(
                content if isinstance(content, bytes) else bytes(content),
                DigitalSignature(self.bytes),
            )

    @dataclass(frozen=True)
    class LegallyIdentifiable(WithKey):
        """A signature attributed to a named Party (CryptoUtilities.kt:37)."""

        signer: "Party" = None  # type: ignore[assignment]


NULL_SIGNATURE = DigitalSignature.WithKey(bytes=b"\x00" * 32, by=NULL_PUBLIC_KEY)


def by_keys(sigs: Iterable[DigitalSignature.WithKey]) -> set[PublicKey]:
    """The set of public keys behind a collection of signatures."""
    return {sig.by for sig in sigs}
