"""Opaque byte-array wrappers.

The port's own copy of ``corda_tpu/utils/bytes.py``.

Capability match for the reference's OpaqueBytes (reference:
core/src/main/kotlin/net/corda/core/serialization/ByteArrays.kt) — a typed
wrapper that stops raw byte arrays being confused with one another in
signatures, references and payloads.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class OpaqueBytes:
    """An immutable, comparable wrapper around a byte string."""

    bytes: bytes

    def __post_init__(self):
        if not isinstance(self.bytes, bytes):
            object.__setattr__(self, "bytes", bytes(self.bytes))

    @staticmethod
    def of(*values: int) -> "OpaqueBytes":
        return OpaqueBytes(bytes(values))

    @property
    def size(self) -> int:
        return len(self.bytes)

    def __len__(self) -> int:
        return len(self.bytes)

    def __bytes__(self) -> bytes:
        return self.bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.bytes.hex()[:32]})"
