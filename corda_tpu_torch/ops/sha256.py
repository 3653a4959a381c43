"""Batched SHA-256 and Merkle roots: the resolve path's hashing.

Counterpart of ``corda_tpu/ops/sha256_jax.py``. A validating notary's
resolve path recomputes the id of every downloaded transaction: every
component leaf is hashed in one bulk call (``hash_many_auto``, driven by
``SignedTransaction.prime_ids``), and a wave's Merkle trees can be reduced
together (``merkle_roots``).

Two functions reach a hand-written CUDA kernel (csrc/sha256.cu):

  sha256_flat   messages as one uint8 byte buffer plus N + 1 int64 offsets
                -> (8, N) int32 state words. A CUDA tensor launches
                ``sha256_many_kernel`` (one thread per message, each block
                staged through shared memory by coalesced copies, padding
                done in the kernel, any mix of lengths in one launch); a CPU
                tensor takes ``sha256_flat_reference``, which pads in torch,
                buckets by block count and runs ``sha256_blocks_reference``.
  merkle_reduce ``depth`` levels of m trees, (8, m, width) int32 digest
                words -> (8, m, ceil(width / 2^depth)). A CUDA tensor
                launches ``sha256_pair_kernel`` once (each aligned chunk of
                2^depth nodes reduced in shared memory, the odd node by
                index clamping); a CPU tensor takes
                ``merkle_level_reference`` ``depth`` times.

The plain versions mirror ``_compress``: torch's uint32 lacks ``>>``, ``+``
and ``~``, so words ride int64 lanes masked to 32 bits (as in sha512.py);
at the boundaries a word is an int32 bit pattern. Byte-identical to
hashlib.sha256. Nothing falls back: on a CUDA device a kernel that does not
build or launch raises, and there is no environment variable (the
crossover is ``hash_many_auto``'s ``device_min`` argument).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

__all__ = ["sha256_blocks_reference", "sha256_pair_words_reference",
           "sha256_flat_reference", "sha256_flat", "pack_flat", "digests_of",
           "sha256_many", "sha256_pair_words", "merkle_level",
           "merkle_reduce", "merkle_level_reference", "merkle_roots",
           "merkle_root", "hash_many_auto", "DEVICE_MIN_HASHES_DEFAULT"]

# hash_many_auto sends a batch of at least this many messages to the card
# and a smaller one to hashlib: the size from which chip_smoke.py's sweep
# over the resolve wave's leaf messages had the card win at every larger
# size on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, "hashing
# crossover"). Change it only through the argument.
DEVICE_MIN_HASHES_DEFAULT = 512

# Levels one launch of the pair kernel reduces at most (csrc/sha256.cu's
# MERKLE_MAX_DEPTH): 2^5 = 32 leaves of a tree to one node.
MERKLE_DEPTH = 5

M32 = 0xFFFFFFFF
I64 = torch.int64

K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

H0_256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

# A 64-byte message is one data block plus this constant padding block
# (sha256_jax.py's _PAD_BLOCK_64).
PAD_BLOCK_64 = [0x80000000] + [0] * 14 + [64 * 8]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, block):
    """One compression: ``state`` 8 words, ``block`` 16 words; each word an
    int64 tensor of values in [0, 2^32) (or a Python int, broadcast)."""
    w = list(block)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + K256[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(I64) & M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _h0(n: int, device) -> list[torch.Tensor]:
    return [torch.full((n,), h, dtype=I64, device=device) for h in H0_256]


def sha256_blocks_reference(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of the hash over pre-padded blocks (sha256_jax.py's
    sha256_blocks): (nblocks, 16, N) int32 big-endian block words ->
    (8, N) int32 state words."""
    b = _u32(blocks)
    state = _h0(b.shape[-1], b.device)
    for k in range(b.shape[0]):
        state = _compress(state, [b[k, i] for i in range(16)])
    return _to_i32(torch.stack(state))


def sha256_pair_words_reference(left: torch.Tensor,
                                right: torch.Tensor) -> torch.Tensor:
    """Plain version of the Merkle node kernel: sha256(l || r) for (8, N)
    int32 digest words, as two compressions (the data block, then the
    constant pad block) -> (8, N) int32."""
    lw, rw = _u32(left), _u32(right)
    state = _h0(lw.shape[-1], lw.device)
    state = _compress(state, [lw[i] for i in range(8)]
                      + [rw[i] for i in range(8)])
    return _to_i32(torch.stack(_compress(state, PAD_BLOCK_64)))


def _padded_buckets(data: torch.Tensor, offsets: torch.Tensor):
    """(message indices, (nblocks, 16, m) int32 padded blocks) for each
    block count among the messages: the padding sha256.cu does per thread,
    done here in torch for the plain version."""
    lengths = offsets[1:] - offsets[:-1]
    nblocks = (lengths + 8) // 64 + 1
    src = data.to(I64)
    if src.numel() == 0:
        src = torch.zeros(1, dtype=I64, device=data.device)
    for nb in torch.unique(nblocks).tolist():
        idx = torch.nonzero(nblocks == nb).flatten()
        length, off = lengths[idx, None], offsets[idx, None]
        pos = torch.arange(nb * 64, dtype=I64, device=data.device)[None]
        gathered = src[(off + pos).clamp(max=src.numel() - 1)]
        byte = torch.where(pos < length, gathered,
                           torch.where(pos == length, 0x80, 0))
        bits = length[:, 0] * 8
        for k in range(8):  # the bit length, big-endian, in the last 8 bytes
            byte[:, nb * 64 - 1 - k] = (bits >> (8 * k)) & 0xFF
        q = byte.view(-1, nb, 16, 4)
        words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) \
            | q[..., 3]
        yield idx, _to_i32(words.permute(1, 2, 0).contiguous())


def sha256_flat_reference(data: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of sha256_many_kernel: message i is data[offsets[i]:
    offsets[i + 1]] (uint8 bytes, N + 1 int64 offsets) -> (8, N) int32
    state words."""
    out = torch.empty((8, offsets.shape[0] - 1), dtype=torch.int32,
                      device=data.device)
    for idx, blocks in _padded_buckets(data, offsets):
        out[:, idx] = sha256_blocks_reference(blocks)
    return out


def sha256_flat(data: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """SHA-256 state words of the messages of a flat buffer, on the
    tensors' device: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if data.device.type == "cpu":
        return sha256_flat_reference(data, offsets)
    from . import kernels

    return kernels.sha256_many_cuda(data, offsets)


def pack_flat(msgs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """One vectorized host pass: every message's bytes in one uint8 buffer
    and N + 1 int64 offsets (message i is buf[off[i]:off[i + 1]])."""
    data = np.frombuffer(b"".join(msgs), np.uint8)
    offsets = np.zeros(len(msgs) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, msgs), np.int64, len(msgs)),
              out=offsets[1:])
    return data, offsets


def digests_of(words: torch.Tensor) -> list[bytes]:
    """(8, N) int32 state words -> N 32-byte digests."""
    st = words.cpu().numpy().view(np.uint32).T.astype(">u4")
    raw = st.tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def sha256_many(msgs: Sequence[bytes], device: str = "cuda") -> list[bytes]:
    """SHA-256 of a ragged batch in one call on ``device`` ("cuda", the
    default, raises without a card; "cpu" runs the plain version)."""
    from . import require_cuda

    dev = require_cuda(device)
    if not msgs:
        return []
    data, offsets = pack_flat(msgs)
    words = sha256_flat(torch.from_numpy(data.copy()).to(dev),
                        torch.from_numpy(offsets).to(dev))
    return digests_of(words)


def hash_many_auto(msgs: Sequence[bytes], device_min: int | None = None,
                   device: str = "cuda") -> tuple[list[bytes], str]:
    """(digests, backend): hashlib below ``device_min`` messages
    (DEVICE_MIN_HASHES_DEFAULT when None), sha256_many on ``device`` at or
    above it. The one dispatch predicate for bulk hashing (the resolve
    path's id recomputation). Unlike the JAX package there is no host
    fallback: a device failure raises."""
    if device_min is None:
        device_min = DEVICE_MIN_HASHES_DEFAULT
    if len(msgs) >= device_min:
        return sha256_many(msgs, device=device), "device"
    return [hashlib.sha256(m).digest() for m in msgs], "host"


def sha256_pair_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node hash sha256(l || r) for (8, N) int32 digest words on
    their device: the plain version on the CPU, the pair kernel (N trees of
    two nodes reduced one level) on the card."""
    if left.device.type == "cpu":
        return sha256_pair_words_reference(left, right)
    level = torch.stack((left, right), dim=-1).contiguous()  # (8, N, 2)
    return merkle_reduce(level, 1)[:, :, 0]


def merkle_level(level: torch.Tensor) -> torch.Tensor:
    """One reduction step of m trees: (8, m, width) int32 digest words ->
    (8, m, ceil(width / 2)), node j = sha256(node 2j || node 2j + 1), the
    last node hashed with itself when width is odd (crypto/merkle.py's
    duplicate rule)."""
    return merkle_reduce(level, 1)


def merkle_reduce(level: torch.Tensor, depth: int) -> torch.Tensor:
    """``depth`` reduction steps of m trees at once: (8, m, width) ->
    (8, m, ceil(width / 2^depth)). On the card one launch of the pair
    kernel (depth at most MERKLE_DEPTH); on the CPU the plain step
    ``depth`` times."""
    if level.device.type == "cpu":
        for _ in range(depth):
            level = merkle_level_reference(level)
        return level
    from . import kernels

    return kernels.merkle_reduce_cuda(level, depth)


def merkle_level_reference(level: torch.Tensor) -> torch.Tensor:
    """Plain version of one level of sha256_pair_kernel: the children
    gathered with the right index clamped to the last node, then
    sha256_pair_words_reference."""
    m, width = level.shape[1], level.shape[2]
    j = torch.arange((width + 1) // 2, device=level.device)
    left = level[:, :, 2 * j].reshape(8, -1)
    right = level[:, :, (2 * j + 1).clamp(max=width - 1)].reshape(8, -1)
    return sha256_pair_words_reference(left, right).reshape(8, m, -1)


def merkle_roots(leaf_groups: Sequence[Sequence[bytes]],
                 device: str = "cuda") -> list[bytes]:
    """Merkle roots of many trees of 32-byte leaf digests, equal to
    crypto/merkle.py's MerkleTree.build root for each. Trees with the same
    leaf count reduce together: on the card one launch takes them up to
    MERKLE_DEPTH levels, so trees of up to 32 leaves take one launch
    and a tree of one leaf none (its root is the leaf)."""
    from . import require_cuda

    dev = require_cuda(device)
    out: list[bytes | None] = [None] * len(leaf_groups)
    buckets: dict[int, list[int]] = {}
    for i, leaves in enumerate(leaf_groups):
        if not leaves:
            raise ValueError("Cannot calculate Merkle root on empty hash list.")
        buckets.setdefault(len(leaves), []).append(i)
    for n_leaves, idxs in buckets.items():
        flat = b"".join(b"".join(leaf_groups[i]) for i in idxs)
        if len(flat) != 32 * n_leaves * len(idxs):
            raise ValueError("Merkle leaves must be 32-byte digests")
        words = np.frombuffer(flat, ">u4").astype(np.uint32).reshape(
            len(idxs), n_leaves, 8).transpose(2, 0, 1)  # (8, m, leaves)
        level = torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(dev)
        while level.shape[2] > 1:
            level = merkle_reduce(level, min(
                MERKLE_DEPTH, (level.shape[2] - 1).bit_length()))
        for i, d in zip(idxs, digests_of(level[:, :, 0])):
            out[i] = d
    return out  # type: ignore[return-value]


def merkle_root(leaf_hashes: Sequence[bytes], device: str = "cuda") -> bytes:
    """The Merkle root of one tree of 32-byte leaf digests."""
    if not leaf_hashes:
        raise ValueError("Cannot calculate Merkle root on empty hash list.")
    return merkle_roots([leaf_hashes], device=device)[0]
