"""ctypes wrappers of the CUDA kernels (csrc/*.cu, built by _build.py).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current CUDA stream without synchronising, raises if the launch is
refused (the C entry point returns ``cudaGetLastError()``), and adds one
to its launch count. The dispatching functions (ed25519.verify_arrays,
sha512.challenge_words) send CPU tensors to the plain versions instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# Launches per kernel, counted where the launch happens and nowhere else.
LAUNCHES = {"ed25519_verify": 0, "sha512_challenge": 0}

_VP = ctypes.c_void_p
_BTAB: dict[torch.device, torch.Tensor] = {}
_FNS: dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(src: str, name: str, nptr: int):
    """The C launcher ``name`` from ``csrc/<src>``: nptr pointers, an int
    N and the stream, returning an int error code."""
    key = f"{src}:{name}"
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(_build.load(src), name)
        fn.argtypes = [_VP] * nptr + [ctypes.c_int, _VP]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def _check_words(name: str, *tensors: torch.Tensor) -> int:
    n = tensors[0].shape[-1]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 words, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != 8 or t.shape[1] != n:
            raise ValueError(f"{name}: expected (8, {n}) words, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: words must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")
    if n >= 2**31 // 8:
        raise ValueError(f"{name}: batch {n} too large for one launch")
    return n


def _raise_if(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def b_table_niels() -> np.ndarray:
    """[1..8]B in niels form (y+x, y-x, 2d*x*y mod p), 8 little-endian
    32-bit words each: (8, 3, 8) uint32, the layout ed25519_verify.cu
    stages in shared memory (signed digits need no more entries). Built
    from the port's oracle copy."""
    from ..crypto import ref_ed25519 as ref
    from .ed25519 import b_table_ints

    p = ref.P
    d2 = 2 * ref.D % p
    out = np.zeros((8, 3, 8), np.uint32)
    for k, (x, y, t) in enumerate(b_table_ints()[1:9]):
        for c, val in enumerate(((y + x) % p, (y - x) % p, d2 * t % p)):
            out[k, c] = [(val >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return out


def _btab(device: torch.device) -> torch.Tensor:
    tab = _BTAB.get(device)
    if tab is None:
        host = b_table_niels().view(np.int32).reshape(-1)
        tab = torch.from_numpy(host.copy()).to(device)
        _BTAB[device] = tab
    return tab


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ed25519_verify_cuda(a, r, s, h) -> torch.Tensor:
    """Kernel 1: (8, N) int32 words of A, raw R, S, h on the card -> int32
    accept mask (N,), 1 = valid."""
    n = _check_words("ed25519_verify", a, r, s, h)
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    fn = _fn("ed25519_verify.cu", "ed25519_verify_launch", 6)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), r.data_ptr(), s.data_ptr(), h.data_ptr(),
                 _btab(a.device).data_ptr(), out.data_ptr(), n,
                 _stream(a.device))
    _raise_if("ed25519_verify", err)
    LAUNCHES["ed25519_verify"] += 1
    return out


def fe_op_cuda(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The verify kernel's field operation ``op`` (0 mul, 1 sq, 2 add,
    3 sub, 4 neg, 5 freeze, 6 invert, 7 pow22523) on (n, 8) int32 words of
    GF(2^255 - 19) elements on the card: a check of its PTX carry chains,
    off the main path, so it counts no launches."""
    for t in (a, b):
        if t.device.type != "cuda" or t.dtype != torch.int32 or \
                t.dim() != 2 or t.shape[1] != 8 or not t.is_contiguous():
            raise ValueError("fe_op: expected contiguous (n, 8) int32 CUDA "
                             f"words, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("fe_op: operands differ in shape or device")
    out = torch.empty_like(a)
    fn = _build.load("ed25519_verify.cu").fe_op_launch
    fn.argtypes = [ctypes.c_int, _VP, _VP, _VP, ctypes.c_int, _VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(op, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                 _stream(a.device))
    _raise_if("fe_op", err)
    return out


def sha512_challenge_cuda(r, a, m) -> torch.Tensor:
    """Kernel 2: (8, N) int32 words of R, A, M on the card -> (8, N) int32
    words of SHA-512(R||A||M) mod L."""
    n = _check_words("sha512_challenge", r, a, m)
    out = torch.empty((8, n), dtype=torch.int32, device=r.device)
    fn = _fn("sha512_challenge.cu", "sha512_challenge_launch", 4)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), a.data_ptr(), m.data_ptr(), out.data_ptr(), n,
                 _stream(r.device))
    _raise_if("sha512_challenge", err)
    LAUNCHES["sha512_challenge"] += 1
    return out
