"""Batched GF(2^255-19) arithmetic in int32 limbs, plain PyTorch.

Counterpart of ``corda_tpu/ops/fe25519.py``, limb for limb: a field
element is 20 limbs of 13 bits in int32, **limb-major** (shape
``(20, *batch)``), values redundant (any value < 2^260 congruent mod p),
``freeze`` gives the canonical representative. Every function performs
the same integer operations in the same order as the JAX module, so the
two produce identical limbs (tests/test_torch_fe25519.py holds them to
that). This is the plain version the CPU path and the conformance tests
run; the CUDA kernel (csrc/ed25519_verify.cu) uses its own 8 x 32-bit
words and is held to the same accept set, not to these limbs.

torch int32 wraps silently and ``>>`` on int32 is arithmetic, as in JAX;
the bounds below are the JAX module's and keep every intermediate inside
int32.
"""

from __future__ import annotations

import numpy as np
import torch

RADIX = 13
NLIMBS = 20
MASK = (1 << RADIX) - 1
NCOEF = 2 * NLIMBS - 1  # 39
P = 2**255 - 19
FOLD = 608  # 2^260 mod p

I32 = torch.int32


def limbs_of_int(x: int) -> np.ndarray:
    """Python int (0 <= x < 2^260) -> (20,) int32 limb array (numpy, host)."""
    if not 0 <= x < 1 << (RADIX * NLIMBS):
        raise ValueError("value out of limb range")
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMBS)], np.int32)


def int_of_limbs(limbs) -> int:
    """(20, ...) limb array or tensor -> python int; host-side test helper."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs)
    return sum(int(arr[i]) << (RADIX * i) for i in range(arr.shape[0]))


def fill_limbs(value: int, batch_shape, device="cpu") -> torch.Tensor:
    """(20, *batch) constant of ``value`` (reduced mod 2^260)."""
    host = limbs_of_int(value % (1 << (RADIX * NLIMBS)))
    c = torch.as_tensor(host, dtype=I32, device=device)
    return c.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(
        (NLIMBS,) + tuple(batch_shape)).contiguous()


def _fill_like(value: int, x: torch.Tensor) -> torch.Tensor:
    return fill_limbs(value, x.shape[1:], x.device)


def _carry(x: torch.Tensor):
    """Signed carry propagation along axis 0 -> (limbs in [0, 2^13),
    carry_out). Arithmetic ``>>`` gives floor semantics for negatives."""
    out = []
    c = torch.zeros(x.shape[1:], dtype=I32, device=x.device)
    for i in range(x.shape[0]):
        t = x[i] + c
        out.append(t & MASK)
        c = t >> RADIX
    return torch.stack(out), c


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Exact weak reduction: signed bounded limbs -> limbs in [0, 2^13),
    value congruent mod p and < 2^260 (two folds of the carry-out)."""
    limbs, c = _carry(x)
    for _ in range(2):
        v = torch.cat([(limbs[0] + FOLD * c)[None], limbs[1:]])
        limbs, c = _carry(v)
    return limbs


def _settle(x: torch.Tensor) -> torch.Tensor:
    """One lazy-carry round: split off the 13-bit residue, push carries up
    one limb, fold the top carry (weight 2^260 == 608) back to limb 0.
    Bound: |x| <= M -> output in (-609*M/8192, 8192 + 609*M/8192)."""
    hi = x >> RADIX
    lo = x & MASK
    top = x.shape[0] - 1
    up = torch.cat([(hi[top] * FOLD)[None], hi[0:top]])
    return lo + up


# Lazy-arithmetic contract (the JAX module's, unchanged):
#   * every op below returns limbs bounded by ~|9500| (usually ~8900);
#   * `mul` accepts limb magnitudes up to 10000 (20 * 10000^2 < 2^31);
#   * canonical form exists only after normalize()/freeze().


def add(a, b):
    return _settle(_settle(a + b))


def sub(a, b):
    return _settle(_settle(a - b))


def neg(a):
    return _settle(_settle(-a))


def _conv_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(39, *batch) schoolbook convolution: coefficient k sums a[i]*b[k-i].

    Skew trick: the (20, 20) outer product padded to (20, 40) and read back
    as (20, 39) shifts row i right by i, so a sum over rows gives the
    convolution. Integer sums of the same terms: identical to the JAX
    module's gather form."""
    batch = a.shape[1:]
    outer = a[:, None] * b[None, :]                       # (20, 20, *batch)
    pad = torch.zeros((NLIMBS, NLIMBS) + tuple(batch), dtype=I32,
                      device=a.device)
    wide = torch.cat([outer, pad], dim=1)                  # (20, 40, *batch)
    flat = wide.reshape((NLIMBS * 2 * NLIMBS,) + tuple(batch))
    skew = flat[:NLIMBS * NCOEF].reshape((NLIMBS, NCOEF) + tuple(batch))
    return skew.sum(dim=0, dtype=I32)


def mul(a, b):
    """Field multiply: limbs |.| <= 10000 in, limbs in (-1500, 8900) out."""
    acc = _conv_sum(a, b)                                  # (39, *batch)
    zeros2 = torch.zeros((2,) + acc.shape[1:], dtype=I32, device=acc.device)
    ext = torch.cat([acc, zeros2])                         # (41, *batch)
    zero1 = torch.zeros((1,) + acc.shape[1:], dtype=I32, device=acc.device)
    for _ in range(2):
        hi = ext >> RADIX
        ext = (ext & MASK) + torch.cat([zero1, hi[0:ext.shape[0] - 1]])
    v = ext[:NLIMBS] + FOLD * ext[NLIMBS:2 * NLIMBS]
    top = torch.cat([(FOLD * FOLD * ext[2 * NLIMBS])[None],
                     torch.zeros((NLIMBS - 1,) + v.shape[1:], dtype=I32,
                                 device=v.device)])
    v = v + top
    for _ in range(5):
        v = _settle(v)
    return v


def sq(a):
    return mul(a, a)


def mul_small(a, k: int):
    """Multiply by a small host constant k (|k| <= 16)."""
    v = a * k
    for _ in range(3):
        v = _settle(v)
    return v


def _pow_bits(x, exponent: int):
    """x^exponent by MSB-first square-and-multiply: the JAX fori_loop as a
    Python loop. A step whose exponent bit is 0 keeps the squared value,
    which is what the JAX select gives, so the limbs agree."""
    bits = [int(b) for b in bin(exponent)[2:]][1:]  # leading 1 -> acc = x
    acc = x
    for bit in bits:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, x)
    return acc


def inv(a):
    """a^(p-2); inv(0) = 0."""
    return _pow_bits(a, P - 2)


def pow_p58(a):
    """a^((p-5)/8), the candidate-root exponent for decompression."""
    return _pow_bits(a, (P - 5) // 8)


_KP_INT = {k: k * P for k in (32, 16, 8, 4, 2, 1)}


def freeze(a):
    """Canonical representative in [0, p): normalize, then subtract k*p for
    k = 32, 16, ..., 1 wherever the value is at least k*p."""
    v = normalize(a)
    for k in (32, 16, 8, 4, 2, 1):
        d, c = _carry(v - _fill_like(_KP_INT[k], a))
        v = torch.where((c < 0)[None], v, d)
    return v


def is_zero(a):
    return torch.all(freeze(a) == 0, dim=0)


def eq(a, b):
    return is_zero(sub(a, b))


def select(mask, a, b):
    return torch.where(mask[None], a, b)
