"""Wire-format whitelist registrations for core types.

The port's own copy of ``corda_tpu/serialization/wire.py``.

The analogue of the reference's central Kryo registration block (reference:
core/src/main/kotlin/net/corda/core/serialization/Kryo.kt:400-507): one place
that whitelists every type allowed on the wire / in checkpoints. Importing
this module (via corda_tpu_torch/__init__.py, as the JAX package does in
its own __init__) makes the core types serializable; higher layers register
their own types at definition with @register. The set is the JAX package's.
"""

from __future__ import annotations

from ..crypto.composite import CompositeKeyLeaf, CompositeKeyNode
from ..crypto.hashes import SecureHash
from ..crypto.keys import DigitalSignature, PrivateKey, PublicKey
from ..crypto.merkle import (
    PartialIncludedLeaf,
    PartialLeaf,
    PartialMerkleTree,
    PartialNode,
)
from ..crypto.party import Party, PartyAndReference
from ..crypto.signed_data import SignedData
from ..utils.bytes import OpaqueBytes
from .codec import SerializedBytes, mark_cacheable, register_class

for _cls in (
    SecureHash,
    OpaqueBytes,
    SerializedBytes,
    PublicKey,
    PrivateKey,
    DigitalSignature,
    DigitalSignature.WithKey,
    DigitalSignature.LegallyIdentifiable,
    CompositeKeyLeaf,
    CompositeKeyNode,
    Party,
    PartyAndReference,
    SignedData,
    PartialIncludedLeaf,
    PartialLeaf,
    PartialNode,
    PartialMerkleTree,
):
    register_class(_cls)

# Deeply-immutable plain-data types on the checkpoint/message hot path:
# their canonical encoding is memoized per instance (codec._CACHEABLE).
mark_cacheable(
    SecureHash,
    SerializedBytes,
    PublicKey,
    DigitalSignature,
    DigitalSignature.WithKey,
    DigitalSignature.LegallyIdentifiable,
    CompositeKeyLeaf,
    CompositeKeyNode,
    Party,
    PartyAndReference,
)
