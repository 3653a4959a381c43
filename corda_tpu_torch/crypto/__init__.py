"""Crypto layer of the port: host hashing, keys, composite keys, Merkle
proofs, the oracle copy, the verifier seam and the verify sidecar.
Importing it builds no kernel and loads no torch."""

from .hashes import SecureHash  # noqa: F401
from .keys import (  # noqa: F401
    DigitalSignature,
    KeyPair,
    NULL_PUBLIC_KEY,
    NULL_SIGNATURE,
    PrivateKey,
    PublicKey,
    SignatureError,
    by_keys,
)
from .composite import (  # noqa: F401
    CompositeKey,
    CompositeKeyLeaf,
    CompositeKeyNode,
    all_keys,
)
from .merkle import (  # noqa: F401
    MerkleDuplicatedLeaf,
    MerkleLeaf,
    MerkleNode,
    MerkleTree,
    MerkleTreeException,
    PartialMerkleTree,
)
from .party import Party, PartyAndReference  # noqa: F401
from .signed_data import SignedData  # noqa: F401
