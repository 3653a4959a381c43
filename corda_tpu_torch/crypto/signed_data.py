"""A serialized payload plus a signature over it.

The port's own copy of ``corda_tpu/crypto/signed_data.py``.

Capability match for the reference's SignedData (reference:
core/src/main/kotlin/net/corda/core/crypto/SignedData.kt): deserialization is
gated behind signature verification, so callers can only ever observe payloads
whose signature checked out. Used for network-map registrations, and
subclassable for extra payload validation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar

from ..serialization.codec import SerializedBytes
from .keys import DigitalSignature

T = TypeVar("T")


@dataclass(frozen=True)
class SignedData(Generic[T]):
    """Raw serialized data and an (unverified) signature over it."""

    raw: SerializedBytes
    sig: DigitalSignature.WithKey

    def verified(self) -> T:
        """Verify the signature, deserialize, run verify_data, return payload.

        Raises SignatureError if the signature is bad (reference:
        SignedData.kt:22-27).
        """
        self.sig.verify(self.raw.bytes)
        data = self.raw.deserialize()
        self.verify_data(data)
        return data

    def verify_data(self, data: Any) -> None:
        """Extension point for subclasses; default accepts anything."""
