"""Batched single-block SHA-512 + mod-L reduction: the Ed25519 challenge.

Counterpart of ``corda_tpu/ops/sha512_jax.py``. For the notary workload the
message is a 32-byte transaction id, so R || A || M is a fixed 96 bytes,
exactly one padded SHA-512 block, and h = SHA-512(R||A||M) mod L is a
fixed-shape batched function of three (8, N) word arrays.

``challenge_words`` dispatches: a CUDA tensor goes to the hand-written
kernel (csrc/sha512_challenge.cu, one thread per signature, native
uint64), a CPU tensor to ``challenge_words_reference``, the plain PyTorch
version below. The plain version mirrors the JAX graph: a 64-bit word is
an (hi, lo) pair of 32-bit values, here carried in int64 lanes (a logical
right shift is ``>>`` on a non-negative value; results are masked back to
32 bits), and the reduction uses 43 limbs of 12 bits with 2^252 == -delta
(mod L). Byte-identical to hashlib.sha512 + int % L.
"""

from __future__ import annotations

import torch

from ..crypto.ref_ed25519 import L

__all__ = ["sha512_96_words", "sc_reduce_words", "challenge_words",
           "challenge_words_reference"]

M32 = 0xFFFFFFFF
I64 = torch.int64

K512 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

H0_512 = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]


# --- 64-bit ops on (hi, lo) pairs of 32-bit values in int64 lanes ----------


def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def _add64_many(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = _add64(out, x)
    return out


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _and64(a, b):
    return a[0] & b[0], a[1] & b[1]


def _not64(a):
    return a[0] ^ M32, a[1] ^ M32


def _rotr64(x, n: int):
    hi, lo = x
    if n == 32:
        return lo, hi
    if n < 32:
        nh, nl = hi, lo
    else:
        nh, nl = lo, hi
        n -= 32
    return (((nh >> n) | (nl << (32 - n))) & M32,
            ((nl >> n) | (nh << (32 - n))) & M32)


def _shr64(x, n: int):
    hi, lo = x
    return hi >> n, ((lo >> n) | (hi << (32 - n))) & M32  # n < 32 here


def _big_s0(x):
    return _xor64(_xor64(_rotr64(x, 28), _rotr64(x, 34)), _rotr64(x, 39))


def _big_s1(x):
    return _xor64(_xor64(_rotr64(x, 14), _rotr64(x, 18)), _rotr64(x, 41))


def _small_s0(x):
    return _xor64(_xor64(_rotr64(x, 1), _rotr64(x, 8)), _shr64(x, 7))


def _small_s1(x):
    return _xor64(_xor64(_rotr64(x, 19), _rotr64(x, 61)), _shr64(x, 6))


def _bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(I64) & M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def sha512_96_words(r_words, a_words, m_words):
    """SHA-512(R||A||M) for 32-byte R, A, M as (8, N) int32 LE words.
    Returns ((8, N), (8, N)) int64 (hi, lo) halves of the eight big-endian
    64-bit state words."""
    r, a, m = _u32(r_words), _u32(a_words), _u32(m_words)
    n = r.shape[-1]
    dev = r.device
    # Block word i (big-endian 64-bit) = bswap(LE word 2i) : bswap(2i+1).
    w = []
    for src in (r, a, m):
        for i in range(4):
            w.append((_bswap32(src[2 * i]), _bswap32(src[2 * i + 1])))
    zero = torch.zeros(n, dtype=I64, device=dev)
    w.append((torch.full((n,), 0x80000000, dtype=I64, device=dev), zero))
    w += [(zero, zero)] * 2
    w.append((zero, torch.full((n,), 96 * 8, dtype=I64, device=dev)))

    state = [(torch.full((n,), h >> 32, dtype=I64, device=dev),
              torch.full((n,), h & M32, dtype=I64, device=dev))
             for h in H0_512]
    a_, b_, c_, d_, e_, f_, g_, h_ = state
    for t in range(80):
        wt = w[t]
        s1 = _big_s1(e_)
        ch = _xor64(_and64(e_, f_), _and64(_not64(e_), g_))
        k = (K512[t] >> 32, K512[t] & M32)
        t1 = _add64_many(h_, s1, ch, k, wt)
        s0 = _big_s0(a_)
        maj = _xor64(_xor64(_and64(a_, b_), _and64(a_, c_)), _and64(b_, c_))
        t2 = _add64(s0, maj)
        if t + 16 < 80:
            w.append(_add64_many(_small_s1(w[t + 14]), w[t + 9],
                                 _small_s0(w[t + 1]), wt))
        h_, g_, f_, e_ = g_, f_, e_, _add64(d_, t1)
        d_, c_, b_, a_ = c_, b_, a_, _add64(t1, t2)
    out = [_add64(s, v) for s, v in
           zip(state, (a_, b_, c_, d_, e_, f_, g_, h_))]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]))


# --- scalar reduction mod L -------------------------------------------------

SC_RADIX = 12
SC_MASK = (1 << SC_RADIX) - 1
SC_NLIMBS = 43  # ceil(512 / 12)
SC_SPLIT = 21  # 252 = 21 * 12: limbs >= 21 carry the 2^252 overflow
DELTA = L - 2**252  # 125 bits -> 11 limbs
_DELTA_LIMBS = [(DELTA >> (SC_RADIX * i)) & SC_MASK for i in range(11)]


def _sc_const(x: int, nlimbs: int, like: torch.Tensor) -> torch.Tensor:
    vals = [(x >> (SC_RADIX * i)) & SC_MASK for i in range(nlimbs)]
    return torch.tensor(vals, dtype=I64, device=like.device)[:, None].expand(
        nlimbs, like.shape[-1]).contiguous()


def _sc_carry(limbs, nlimbs: int):
    """Carry to canonical [0, 2^12) limbs (arithmetic shifts: floor
    semantics); exactly ``nlimbs`` limbs out."""
    out = []
    carry = torch.zeros_like(limbs[0])
    for i in range(limbs.shape[0]):
        v = limbs[i] + carry
        out.append(v & SC_MASK)
        carry = v >> SC_RADIX
    while len(out) < nlimbs:
        out.append(carry & SC_MASK)
        carry = carry >> SC_RADIX
    return torch.stack(out[:nlimbs])


def _sc_mul_delta(hi):
    """delta * hi: (H, N) canonical limbs -> (H+11, N) limb products."""
    h = hi.shape[0]
    out = torch.zeros((h + 11, hi.shape[-1]), dtype=I64, device=hi.device)
    for j, d in enumerate(_DELTA_LIMBS):
        if d:
            out[j:j + h] += hi * d
    return out


def _sc_fold(limbs, nlimbs_out: int, guard_bits: int):
    """value = lo + 2^252*hi == lo + 2^guard*L - delta*hi (mod L), kept
    non-negative; canonical ``nlimbs_out`` limbs out."""
    lo, hi = limbs[:SC_SPLIT], limbs[SC_SPLIT:]
    prod = _sc_mul_delta(hi)
    width = max(SC_SPLIT, prod.shape[0]) + guard_bits // SC_RADIX + 2
    acc = _sc_const((1 << guard_bits) * L, width, limbs)
    acc[:SC_SPLIT] += lo
    acc[:prod.shape[0]] -= prod
    return _sc_carry(acc, nlimbs_out)


def _sc_ge(a, l_limbs):
    """Lexicographic a >= l over canonical limbs, most significant first."""
    gt = torch.zeros(a.shape[-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[0] - 1, -1, -1):
        gt = gt | (eq & (a[i] > l_limbs[i]))
        eq = eq & (a[i] == l_limbs[i])
    return gt | eq


def _limbs_to_words(limbs):
    """(>=22, N) canonical 12-bit limbs -> (8, N) int64 LE word values."""
    words = []
    for w in range(8):
        bit = 32 * w
        t, off = bit // SC_RADIX, bit % SC_RADIX
        v = limbs[t] >> off
        used = SC_RADIX - off
        while used < 32:
            t += 1
            if t < limbs.shape[0]:
                v = v | (limbs[t] << used)
            used += SC_RADIX
        words.append(v & M32)
    return torch.stack(words)


def sc_reduce_words(digest_hi, digest_lo):
    """SHA-512 state as (8, N) (hi, lo) int64 halves -> (8, N) int32 LE
    words of h mod L (the digest byte stream read little-endian, ref10
    sc_reduce semantics)."""
    byte_rows = []
    for i in range(8):
        for w in (digest_hi[i], digest_lo[i]):
            byte_rows.extend([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                              (w >> 8) & 0xFF, w & 0xFF])
    b = torch.stack(byte_rows)  # (64, N), stream order
    limbs = []
    for t in range(SC_NLIMBS):
        bit = SC_RADIX * t
        byte, off = bit // 8, bit % 8
        v = b[byte] >> off
        if byte + 1 < 64:
            v = v | (b[byte + 1] << (8 - off))
        limbs.append(v & SC_MASK)
    h = torch.stack(limbs)  # canonical 43 limbs, < 2^512

    t1 = _sc_fold(h, 34, guard_bits=140)   # < 2^393
    t2 = _sc_fold(t1, 25, guard_bits=32)   # < 2^285
    lo3, hi3 = t2[:SC_SPLIT], t2[SC_SPLIT:]
    prod3 = _sc_mul_delta(hi3)
    width3 = SC_SPLIT + 2
    acc = _sc_const(2 * L, width3, t2)
    acc[:SC_SPLIT] += lo3
    acc[:prod3.shape[0]] -= prod3
    out = _sc_carry(acc, width3)          # in [0, 3L)
    l_limbs = _sc_const(L, width3, t2)
    for _ in range(2):
        ge = _sc_ge(out, l_limbs)
        out = torch.where(ge[None, :], _sc_carry(out - l_limbs, width3), out)
    return _to_i32(_limbs_to_words(out))


def challenge_words_reference(r_words, a_words, m_words):
    """Plain PyTorch version of the challenge kernel: (8, N) int32 LE words
    of R, A, M in, (8, N) int32 LE words of SHA-512(R||A||M) mod L out."""
    hi, lo = sha512_96_words(r_words, a_words, m_words)
    return sc_reduce_words(hi, lo)


def challenge_words(r_words, a_words, m_words):
    """h = SHA-512(R||A||M) mod L on the words' device: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if r_words.device.type == "cpu":
        return challenge_words_reference(r_words, a_words, m_words)
    from . import kernels

    return kernels.sha512_challenge_cuda(r_words, a_words, m_words)
