"""Network identities.

The port's own copy of ``corda_tpu/crypto/party.py``.

Capability match for the reference's Party (reference:
core/src/main/kotlin/net/corda/core/crypto/Party.kt): an entity identified by
a legal name and a CompositeKey owning key, used both for node identities and
for (possibly distributed) service identities — a notary cluster advertises
one Party whose composite key contains every member's key.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.bytes import OpaqueBytes
from .composite import CompositeKey
from .keys import PublicKey


@dataclass(frozen=True)
class Party:
    """A named on-network identity that signs under a composite key."""

    name: str
    owning_key: CompositeKey

    @staticmethod
    def of(name: str, key: "PublicKey | CompositeKey") -> "Party":
        if isinstance(key, PublicKey):
            key = key.composite
        return Party(name, key)

    def ref(self, data: bytes | OpaqueBytes) -> "PartyAndReference":
        if isinstance(data, bytes):
            data = OpaqueBytes(data)
        return PartyAndReference(self, data)

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class PartyAndReference:
    """A Party plus an opaque reference it chose — e.g. an issuer plus its
    internal account id (reference: core/.../contracts/Structures.kt:331)."""

    party: Party
    reference: OpaqueBytes

    def __str__(self) -> str:
        return f"{self.party}{self.reference}"
