"""PyTorch/CUDA port of corda_tpu for NVIDIA Hopper GPUs: the notary's
verify path, the transaction layer and the resolve path's hashing.

Imports neither jax nor corda_tpu; see README.md, "PyTorch/CUDA port".
"""

from .serialization import wire as _wire  # noqa: E402,F401  (whitelist core types)
