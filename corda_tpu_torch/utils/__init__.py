"""Utility primitives of the port (own copies of corda_tpu/utils)."""

from .bytes import OpaqueBytes  # noqa: F401
