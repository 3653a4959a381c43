"""The least work of the two verify kernels and the card's peaks.

A kernel's roofline share is the least time the card could take for the
work its inputs need -- the larger of its integer operations over the peak
integer rate and its bytes over the peak memory bandwidth -- divided by the
kernel's time in the profiler's trace. The counts below are lower bounds
(what the inputs need, not what the kernel happens to do), so a share can
never pass 100% unless the time leaves out part of the work.

Kernels are identified by the names the profiler prints.
"""

from __future__ import annotations

import hashlib

import numpy as np

VERIFY_KERNEL = "ed25519_verify_kernel"
CHALLENGE_KERNEL = "sha512_challenge_kernel"

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of device memory; 32-bit
# integer multiply-add and ALU rate = 132 SMs x 64 lanes x 1.98 GHz (half
# the 67 TFLOP/s float32 rate's 128 lanes per SM). The SM clock measured
# beside a run is reported with each share: a card held below 1.98 GHz
# reads a lower share against this peak.
SMS = 132
INT32_LANES_PER_SM = 64
PEAK_SM_CLOCK_HZ = 1.98e9
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = SMS * INT32_LANES_PER_SM * PEAK_SM_CLOCK_HZ

L = 2 ** 252 + 27742317777372353535851937790883648493

# Field arithmetic in radix 2^32: the least integer work per multiply is
# 64 32x32->64 products plus 8 for the reduction (36 + 8 for a square),
# each product two 32-bit multiply-adds (low and high halves).
MUL_INT_OPS, SQ_INT_OPS = 2 * 72, 2 * 44
# Bytes a verify lane must move: A, R, S, h in (32 bytes each), one
# 32-bit verdict out.
VERIFY_BYTES = 4 * 32 + 4
# Challenge kernel: the least 32-bit instruction count per signature as
# Hopper issues it, constants folded:
#   * a round is 28: each 64-bit rotate is one funnel shift per half
#     (6 for Sigma0, 6 for Sigma1), each three-input XOR, Ch and Maj one
#     LOP3 per half (8), and the adds as IADD3/IADD3.X pairs: two for t1
#     (5 operands), one for a = t1 + Sigma0 + Maj, one for e = d + t1 (8);
#     round 0, whose state is all H0, is 4: 79 * 28 + 4;
#   * a schedule word is 20: sigma0 and sigma1 6 shifts + 2 LOP3 each, the
#     4-operand sum two IADD3 pairs; W[12..15] are constants, which saves
#     60 over t = 16..31: 64 * 20 - 60;
#   * the final H0 + state adds, 8 * 2, and the byte swaps, one PRMT per
#     32-bit word: 24 in, 16 for the digest.
# The mod-L reduction is left out, so the bound stays a lower bound.
CHALLENGE_INT_OPS = (79 * 28 + 4) + (64 * 20 - 60) + 8 * 2 + (24 + 16)
# R, A, M in (32 bytes each), h out (32 bytes).
CHALLENGE_BYTES = 3 * 32 + 32


def wnaf5(x: int) -> tuple[int, int]:
    """(nonzero digits, index of the top one or -1) of ``x`` in width-5
    signed sliding windows: odd digits in -15..15, at least four zeros
    after each, as ref10's slide() recodes a scalar."""
    nonzero, top, i = 0, -1, 0
    while x:
        if x & 1:
            d = x & 31
            x -= d - 32 if d > 16 else d
            nonzero, top = nonzero + 1, i
        x >>= 1
        i += 1
    return nonzero, top


def verify_lane_ops(s: int, h: int) -> int:
    """The least integer work of verifying one lane with scalars S and h,
    counted as ref10's variable-time double scalar multiplication needs it
    for these scalars (less than the kernel's fixed windows):
      * decompression 20 mul + 255 sq, inversion and encode 13 + 254;
      * the odd multiples [1, 3, ..., 15](-A): 68 mul + 4 sq;
      * one doubling (4 sq) and its p2 form (3 mul) per bit from the top
        nonzero digit of either scalar down;
      * 8 mul per nonzero digit of h (an addition of a cached -A entry and
        the p3 form before it), 7 per nonzero digit of S (a mixed addition
        of a fixed B entry)."""
    ns, ts = wnaf5(s)
    nh, th = wnaf5(h)
    bits = max(ts, th) + 1
    muls = 20 + 13 + 68 + 3 * bits + 8 * nh + 7 * ns
    sqs = 255 + 254 + 4 + 4 * bits
    return muls * MUL_INT_OPS + sqs * SQ_INT_OPS


def challenge(pk: bytes, msg: bytes, sig: bytes) -> int:
    """h = SHA-512(R || A || M) mod L, the verify kernel's second scalar."""
    return int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                          "little") % L


def verify_ops_chunk(lanes) -> int:
    """Least integer operations of verifying every (pk, msg, sig) lane."""
    return sum(verify_lane_ops(int.from_bytes(sig[32:], "little"),
                               challenge(pk, msg, sig))
               for pk, msg, sig in lanes)


def verify_least_ops(pk: np.ndarray, msg: np.ndarray, sig: np.ndarray,
                     pool=None) -> int:
    """Least integer operations of a batch given as (n, 32) / (n, 32) /
    (n, 64) uint8 arrays, split across ``pool`` when given."""
    n = len(pk)
    lanes = [(pk[i].tobytes(), msg[i].tobytes(), sig[i].tobytes())
             for i in range(n)]
    step = max(1, -(-n // 32))
    chunks = [lanes[i:i + step] for i in range(0, n, step)]
    parts = (pool.map(verify_ops_chunk, chunks) if pool is not None
             else [verify_ops_chunk(c) for c in chunks])
    return int(sum(parts))


def least_seconds(int_ops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds to issue ``int_ops`` 32-bit integer operations or
    to move ``nbytes``, and which one binds."""
    t_ops, t_bytes = int_ops / PEAK_INT32_OPS_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def verify_least_seconds(int_ops: int, lanes: int) -> tuple[float, str]:
    return least_seconds(int_ops, lanes * VERIFY_BYTES)


def challenge_least_seconds(lanes: int) -> tuple[float, str]:
    return least_seconds(lanes * CHALLENGE_INT_OPS, lanes * CHALLENGE_BYTES)
