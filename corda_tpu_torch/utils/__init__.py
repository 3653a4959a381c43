"""Utility primitives of the port (own copies of corda_tpu/utils)."""

from .bytes import OpaqueBytes  # noqa: F401
from .clock import Clock  # noqa: F401
from .progress import ProgressTracker, Step  # noqa: F401
