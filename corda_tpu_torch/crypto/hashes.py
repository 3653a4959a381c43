"""Secure hashes — capability match for the reference's SecureHash.

The port's own copy of ``corda_tpu/crypto/hashes.py``.

Reference: core/src/main/kotlin/net/corda/core/crypto/SecureHash.kt:33 —
SHA-256 content addressing used for transaction ids, attachment ids and Merkle
leaves. Host-side single hashes live here; the batched/tree-structured hashing
used on the notary hot path is the CUDA kernel behind ops/sha256.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class SecureHash:
    """An immutable 32-byte SHA-256 digest."""

    bytes: bytes

    def __post_init__(self):
        if len(self.bytes) != 32:
            raise ValueError(f"SHA-256 digest must be 32 bytes, got {len(self.bytes)}")

    @staticmethod
    def sha256(data: bytes) -> "SecureHash":
        return SecureHash(hashlib.sha256(data).digest())

    @staticmethod
    def sha256_twice(data: bytes) -> "SecureHash":
        return SecureHash.sha256(hashlib.sha256(data).digest())

    @staticmethod
    def parse(hex_str: str) -> "SecureHash":
        return SecureHash(bytes.fromhex(hex_str))

    @staticmethod
    def zero() -> "SecureHash":
        return SecureHash(b"\x00" * 32)

    @staticmethod
    def random() -> "SecureHash":
        import os

        return SecureHash(os.urandom(32))

    def hex(self) -> str:
        return self.bytes.hex()

    def prefix_chars(self, n: int = 6) -> str:
        return self.hex()[:n].upper()

    def hash_concat(self, other: "SecureHash") -> "SecureHash":
        """Node hash for Merkle trees: sha256(left || right)."""
        return SecureHash.sha256(self.bytes + other.bytes)

    def __str__(self) -> str:
        return self.hex().upper()

    def __repr__(self) -> str:
        return f"SecureHash({self.hex()[:16]}…)"
