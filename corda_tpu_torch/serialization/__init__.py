"""Canonical deterministic serialization (wire + checkpoint format)."""

from .codec import (  # noqa: F401
    SerializedBytes,
    register,
    register_class,
    serialize,
    deserialize,
    serialized_hash,
    DeserializationError,
)
