"""PyTorch/CUDA data plane of corda_tpu_torch.

Counterpart of ``corda_tpu/ops``: batched GF(2^255-19) arithmetic
(fe25519), Ed25519 signature verification (ed25519) and the SHA-512
challenge (sha512). Each function that reaches a hand-written CUDA kernel
(csrc/*.cu, built by _build.py, bound by kernels.py) keeps a plain PyTorch
version beside it: a CPU tensor takes the plain version, a CUDA tensor
takes the kernel, and nothing falls back from one to the other.
"""

from __future__ import annotations

import os as _os
import sys as _sys

# Build outputs live under <repo>/build/corda_tpu_torch/<sha256 of sources>/.
BUILD_ROOT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), "build", "corda_tpu_torch")


def last_backend_if_loaded():
    """Which backend ("cuda" | "torch-cpu" | None) served the newest verify
    call, read WITHOUT importing the kernel module or touching torch state:
    stamping must never be what pulls torch or a CUDA context into a
    host-only process."""
    mod = _sys.modules.get("corda_tpu_torch.ops.ed25519")
    if mod is None:
        return None
    return mod.last_backend()


def require_cuda(device="cuda"):
    """Resolve ``device`` to a torch.device; raise if it names CUDA and no
    CUDA device is present. Entry points call this so that asking for the
    card on a host without one is an error, never a silent CPU run."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev
