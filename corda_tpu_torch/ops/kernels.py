"""ctypes wrappers of the CUDA kernels (csrc/*.cu, built by _build.py).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current CUDA stream without synchronising, raises if the launch is
refused (the C entry point returns ``cudaGetLastError()``), and adds one
to its launch count. The dispatching functions (ed25519.verify_arrays,
sha512.challenge_words, sha256.sha256_flat, sha256.merkle_reduce) send CPU
tensors to the plain versions instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .sha256 import (MERKLE_DEPTH, MERKLE_MAX_NODES, SHA256_MAX_BYTES,
                     SHA256_MAX_MESSAGES)

# Launches per kernel, counted where the launch happens and nowhere else.
LAUNCHES = {"ed25519_verify": 0, "sha512_challenge": 0, "sha256_many": 0,
            "sha256_pair": 0}

_VP = ctypes.c_void_p
_BTAB: dict[torch.device, torch.Tensor] = {}
_FNS: dict[str, object] = {}
_SMS: dict[torch.device, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(src: str, name: str, nptr: int, nint: int = 1, extra=()):
    """The C launcher ``name`` from ``csrc/<src>``: nptr pointers, nint ints,
    the ``extra`` argument types and the stream, returning an int error
    code."""
    key = f"{src}:{name}"
    fn = _FNS.get(key)
    if fn is None:
        # lint: allow(no-jit-in-hotpath) keyed launcher cache: the library is looked up once per (source, launcher) and memoised in _FNS; per-batch calls read the cache
        fn = getattr(_build.load(src), name)
        fn.argtypes = ([_VP] * nptr + [ctypes.c_int] * nint + list(extra)
                       + [_VP])
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
    # lint: allow(no-jit-in-hotpath) _build.load is the memoised library cache (a dict lookup once built); fe_op is a check of the field arithmetic off the main path
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


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int
                ) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def sha256_many_cuda(data: torch.Tensor, offsets: torch.Tensor
                     ) -> torch.Tensor:
    """Kernel 3: message i = data[offsets[i]:offsets[i + 1]] (uint8 bytes
    and N + 1 int64 offsets on the card) -> (8, N) int32 SHA-256 state words
    (big-endian digest words); the kernel pads each message itself. The
    offsets must rise from 0 to at most len(data), as pack_flat makes them
    (not checked here: that would synchronise with the card). ``data`` may
    be a view at any byte offset; one launch takes fewer than
    SHA256_MAX_BYTES bytes and SHA256_MAX_MESSAGES messages
    (sha256.sha256_flat splits larger buffers)."""
    _check_cuda("sha256_many", data, torch.uint8, 1)
    _check_cuda("sha256_many", offsets, torch.int64, 1)
    if data.device != offsets.device:
        raise ValueError("sha256_many: tensors on different devices")
    n = offsets.shape[0] - 1
    if n < 0 or n >= SHA256_MAX_MESSAGES:
        raise ValueError(f"sha256_many: {n} messages: expected 0 <= N < 2^28")
    if data.numel() >= SHA256_MAX_BYTES:
        raise ValueError(f"sha256_many: {data.numel()} bytes: expected under "
                         "2^31 in one launch")
    out = torch.empty((8, n), dtype=torch.int32, device=data.device)
    fn = _fn("sha256.cu", "sha256_many_launch", 3, nint=1,
             extra=[ctypes.c_int64])
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), offsets.data_ptr(), out.data_ptr(), n,
                 data.numel(), _stream(data.device))
    _raise_if("sha256_many", err)
    LAUNCHES["sha256_many"] += 1
    return out


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = n
    return n


def merkle_reduce_cuda(level: torch.Tensor, depth: int = MERKLE_DEPTH
                       ) -> torch.Tensor:
    """Kernel 4: ``depth`` Merkle levels in one launch. (8, m, width) int32
    digest words of m trees on the card -> (8, m, ceil(width / 2^depth)):
    each aligned chunk of 2^depth nodes of a tree reduces to one, node j of
    a level being sha256(node 2j || node 2j + 1) of the level below, the
    last node paired with itself when that level's width is odd. Depth 1 is
    one level (merkle_level); a tree of at most 2^depth leaves reaches its
    root when depth = ceil(log2(width)) (merkle_roots)."""
    _check_cuda("sha256_pair", level, torch.int32, 3)
    if level.shape[0] != 8 or level.shape[2] < 1:
        raise ValueError(f"sha256_pair: expected (8, m, width >= 1) words, "
                         f"got {tuple(level.shape)}")
    if not 1 <= depth <= MERKLE_DEPTH:
        raise ValueError(f"sha256_pair: depth {depth} not in 1..{MERKLE_DEPTH}")
    m, width = level.shape[1], level.shape[2]
    if m * width >= MERKLE_MAX_NODES:
        raise ValueError(f"sha256_pair: level {m} x {width} too large for "
                         "one launch")
    wout = -(-width // 2**depth)
    out = torch.empty((8, m, wout), dtype=torch.int32, device=level.device)
    fn = _fn("sha256.cu", "merkle_reduce_launch", 2, nint=4)
    with torch.cuda.device(level.device):
        err = fn(level.data_ptr(), out.data_ptr(), m, width, depth,
                 _sm_count(level.device), _stream(level.device))
    _raise_if("sha256_pair", err)
    LAUNCHES["sha256_pair"] += 1
    return out
