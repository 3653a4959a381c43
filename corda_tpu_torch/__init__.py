"""PyTorch/CUDA port of corda_tpu's verify path for NVIDIA Hopper GPUs.

Imports neither jax nor corda_tpu; see README.md, "PyTorch/CUDA port".
"""
