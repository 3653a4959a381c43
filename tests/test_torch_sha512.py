"""The port's plain SHA-512 challenge against the JAX graph and hashlib.

corda_tpu_torch.ops.sha512.challenge_words_reference must give the same
words as corda_tpu.ops.sha512_jax.challenge_words and as hashlib.sha512 +
int % L, on seeded words plus all-0x00 and all-0xFF inputs. Exact
comparisons (bits). One batch shape (N = 64) keeps the JAX compiles to one.
"""

import hashlib

import numpy as np
import pytest
import torch

from corda_tpu.ops import sha512_jax
from corda_tpu_torch.crypto.ref_ed25519 import L
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import sha512 as tsha

N = 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    r, a, m = (rng.integers(0, 256, (N, 32), np.uint8) for _ in range(3))
    r[0] = a[0] = m[0] = 0x00
    r[1] = a[1] = m[1] = 0xFF
    r[2], a[2], m[2] = 0x00, 0xFF, 0x00
    return r, a, m


def _t(words):
    return ted.words_to_tensor(words, "cpu")


@pytest.mark.parametrize("seed", [5, 6])
def test_challenge_matches_jax_and_hashlib(seed):
    r, a, m = _inputs(seed)
    rw, aw, mw = (ted._words_of(x) for x in (r, a, m))
    got = tsha.challenge_words_reference(_t(rw), _t(aw), _t(mw))
    got = got.numpy().view(np.uint32)
    want = np.asarray(sha512_jax.challenge_words(rw, aw, mw))
    assert np.array_equal(got, want)
    for i in range(N):
        h = int.from_bytes(hashlib.sha512(
            r[i].tobytes() + a[i].tobytes() + m[i].tobytes()).digest(),
            "little") % L
        assert sum(int(got[w, i]) << (32 * w) for w in range(8)) == h
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(tsha.challenge_words(_t(rw), _t(aw), _t(mw)),
                       tsha.challenge_words_reference(_t(rw), _t(aw), _t(mw)))


def test_sha512_96_matches_jax_halves():
    r, a, m = _inputs(7)
    rw, aw, mw = (ted._words_of(x) for x in (r, a, m))
    hi, lo = tsha.sha512_96_words(_t(rw), _t(aw), _t(mw))
    jhi, jlo = sha512_jax.sha512_96_words(rw, aw, mw)
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))


def test_sc_reduce_edges_match_python_ints():
    # digests whose little-endian value is 0, L - 1, L, 2^512 - 1, k*L
    vals = [0, L - 1, L, (1 << 512) - 1, 7 * L, (1 << 252), (1 << 253) - 1]
    hi = np.zeros((8, len(vals)), np.int64)
    lo = np.zeros((8, len(vals)), np.int64)
    for j, v in enumerate(vals):
        stream = v.to_bytes(64, "little")
        for w in range(8):
            word = int.from_bytes(stream[8 * w:8 * w + 8], "big")
            hi[w, j], lo[w, j] = word >> 32, word & 0xFFFFFFFF
    out = tsha.sc_reduce_words(torch.from_numpy(hi), torch.from_numpy(lo))
    out = out.numpy().view(np.uint32)
    got = [sum(int(out[w, j]) << (32 * w) for w in range(8))
           for j in range(len(vals))]
    assert got == [v % L for v in vals]
