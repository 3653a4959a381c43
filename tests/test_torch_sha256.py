"""The port's batched SHA-256 and Merkle roots (corda_tpu_torch/ops/
sha256.py) on the CPU, held to corda_tpu.ops.sha256_jax and hashlib with
tolerance 0: digests are bytes and must be identical.

Mirrors tests/test_sha256_jax.py: padding edges, the NIST vectors, ragged
buckets, Merkle roots over 1-33 leaves (the odd-node duplicate rule), and
hash_many_auto's host and device routes agreeing. On the CPU the device
route runs the kernels' plain versions; the kernels themselves are checked
by tests/test_torch_csrc.py (their host C++ twin) and on the card by
chip_smoke.py.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from corda_tpu.crypto.hashes import SecureHash as JaxSecureHash
from corda_tpu.crypto.merkle import MerkleTree as JaxMerkleTree
from corda_tpu.ops import sha256_jax as sj
from corda_tpu_torch.crypto.hashes import SecureHash
from corda_tpu_torch.crypto.merkle import MerkleTree
from corda_tpu_torch.ops import sha256 as ts

EDGES = (0, 1, 31, 54, 55, 56, 57, 63, 64, 65, 119, 120, 128, 200, 1000)


def _sha(msgs):
    return [hashlib.sha256(m).digest() for m in msgs]


def test_padding_edges_match_jax_and_hashlib():
    # Every padding regime in one ragged call: empty, < 55, 55 (one-block
    # limit), 56-63 (the length spills into a second block), multiples of 64.
    rng = random.Random(7)
    msgs = [rng.randbytes(n) for n in EDGES for _ in range(3)]
    got = ts.sha256_many(msgs, device="cpu")
    assert got == _sha(msgs)
    assert got == sj.sha256_many(msgs)


@pytest.mark.parametrize("length", EDGES)
def test_blocks_reference_matches_jax_sha256_blocks(length):
    # The plain version of the compression chain against the JAX graph on
    # the same pre-padded blocks (sha256_jax.pack_messages).
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (4, length), dtype=np.uint8)
    blocks = sj.pack_messages(msgs)
    want = np.asarray(sj.sha256_blocks(blocks))
    got = ts.sha256_blocks_reference(
        torch.from_numpy(blocks.view(np.int32))).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_nist_vectors():
    # FIPS 180-2 examples.
    got = ts.sha256_many(
        [b"abc", b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq"],
        device="cpu")
    assert got == [
        bytes.fromhex("ba7816bf8f01cfea414140de5dae2223"
                      "b00361a396177a9cb410ff61f20015ad"),
        bytes.fromhex("248d6a61d20638b8e5c026930c3e6039"
                      "a33ce45964ff2167f6ecedd419db06c1")]


def test_ragged_buckets_match_jax():
    rng = random.Random(11)
    msgs = [rng.randbytes(n)
            for n in (0, 1, 3, 55, 56, 64, 57, 200, 1000, 64, 63, 119)]
    got = ts.sha256_many(msgs, device="cpu")
    assert got == sj.sha256_many(msgs) == _sha(msgs)


def test_pack_flat_is_one_buffer_and_offsets():
    msgs = [b"", b"ab", b"", b"cde"]
    data, offsets = ts.pack_flat(msgs)
    assert data.tobytes() == b"abcde" and data.dtype == np.uint8
    assert offsets.tolist() == [0, 0, 2, 2, 5] and offsets.dtype == np.int64
    assert ts.sha256_many([], device="cpu") == []


def test_flat_reference_state_words_match_jax():
    rng = random.Random(3)
    msgs = [rng.randbytes(rng.randrange(300)) for _ in range(40)]
    data, offsets = ts.pack_flat(msgs)
    got = ts.sha256_flat(torch.from_numpy(data.copy()),
                         torch.from_numpy(offsets))
    assert got.dtype == torch.int32 and got.shape == (8, 40)
    want = np.stack([np.frombuffer(d, ">u4").astype(np.uint32)
                     for d in sj.sha256_many(msgs)], axis=1)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_pair_words_match_jax():
    rng = np.random.default_rng(5)
    left = rng.integers(0, 2**32, (8, 16), dtype=np.uint64).astype(np.uint32)
    right = rng.integers(0, 2**32, (8, 16), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(sj.sha256_pair_words(left, right))
    got = ts.sha256_pair_words(torch.from_numpy(left.view(np.int32)),
                               torch.from_numpy(right.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for i in range(16):
        assert got[:, i].numpy().view(np.uint32).astype(">u4").tobytes() == \
            hashlib.sha256(left[:, i].astype(">u4").tobytes()
                           + right[:, i].astype(">u4").tobytes()).digest()


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8])
def test_merkle_level_clamps_the_odd_node(width):
    # The kernel's index clamping against sha256_jax's host concatenate of
    # the last node (merkle_roots_device).
    rng = np.random.default_rng(width)
    level = rng.integers(0, 2**32, (8, 3, width),
                         dtype=np.uint64).astype(np.uint32)
    got = ts.merkle_level(torch.from_numpy(level.view(np.int32)))
    assert got.shape == (8, 3, (width + 1) // 2)
    padded = (np.concatenate([level, level[:, :, -1:]], axis=2)
              if width % 2 else level)
    want = np.asarray(sj.sha256_pair_words(
        padded[:, :, 0::2].reshape(8, -1),
        padded[:, :, 1::2].reshape(8, -1))).reshape(8, 3, -1)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n_leaves", range(1, 34))
def test_merkle_root_matches_host_trees(n_leaves):
    leaves = [SecureHash.sha256(bytes([i, n_leaves])) for i in range(n_leaves)]
    got = ts.merkle_root([h.bytes for h in leaves], device="cpu")
    assert got == MerkleTree.build(leaves).hash.bytes
    assert got == JaxMerkleTree.build(
        [JaxSecureHash(h.bytes) for h in leaves]).hash.bytes


def test_merkle_roots_batched_match_jax():
    # Mixed leaf counts bucket; same-count trees reduce together.
    rng = random.Random(7)
    groups = [[rng.randbytes(32) for _ in range(n)]
              for n in (1, 2, 3, 4, 5, 7, 8, 9, 3, 8)]
    got = ts.merkle_roots(groups, device="cpu")
    assert got == sj.merkle_roots_device(groups)
    assert got == [MerkleTree.build([SecureHash(h) for h in g]).hash.bytes
                   for g in groups]


def test_merkle_roots_reject_empty_and_short_leaves():
    with pytest.raises(ValueError, match="empty hash list"):
        ts.merkle_roots([[b"\x00" * 32], []], device="cpu")
    with pytest.raises(ValueError, match="empty hash list"):
        ts.merkle_root([], device="cpu")
    with pytest.raises(ValueError, match="32-byte"):
        ts.merkle_roots([[b"\x00" * 31]], device="cpu")


def test_hash_many_auto_backends_agree():
    msgs = [b"x" * n for n in range(0, 300, 7)]
    host, hb = ts.hash_many_auto(msgs, device_min=10**9, device="cpu")
    dev, db = ts.hash_many_auto(msgs, device_min=0, device="cpu")
    assert (hb, db) == ("host", "device")
    assert host == dev == _sha(msgs)
    assert (host, hb) == sj.hash_many_auto(msgs, device_min=10**9)
    assert (dev, db) == sj.hash_many_auto(msgs, device_min=0)


def test_crossover_is_an_argument_not_an_environment_variable(monkeypatch):
    # The JAX package reads CORDA_TPU_SHA256_DEVICE_MIN; the port does not.
    monkeypatch.setenv("CORDA_TPU_SHA256_DEVICE_MIN", "0")
    msgs = [b"m"] * (ts.DEVICE_MIN_HASHES_DEFAULT - 1)
    digests, backend = ts.hash_many_auto(msgs, device="cpu")
    assert backend == "host" and digests[0] == hashlib.sha256(b"m").digest()
    assert ts.hash_many_auto([b"m"], device_min=1, device="cpu")[1] == "device"


def test_entry_points_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.sha256_many([b"abc"])
    with pytest.raises(RuntimeError, match="cuda"):
        ts.merkle_roots([[b"\x00" * 32]])
    with pytest.raises(RuntimeError, match="cuda"):
        ts.hash_many_auto([b"abc"], device_min=0)
    # Below the crossover the host answers and the card is not touched.
    assert ts.hash_many_auto([b"abc"], device_min=2)[1] == "host"


# --- oversize work: the launch-span planner and the split dispatchers ------


def _offsets(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


@pytest.mark.parametrize("lengths, max_bytes, max_items, want", [
    # Exact byte boundary: a span's bytes must stay under max_bytes.
    ([5, 5, 5, 5], 10, 100, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    ([5, 5, 5, 5], 11, 100, [(0, 2), (2, 4)]),
    # Exact message boundary: a span holds fewer than max_items messages.
    ([1] * 7, 100, 3, [(0, 2), (2, 4), (4, 6), (6, 7)]),
    ([1] * 6, 100, 4, [(0, 3), (3, 6)]),
    # One message at or over the byte limit gets a launch of its own.
    ([2, 10, 2], 10, 100, [(0, 1), (1, 2), (2, 3)]),
    ([2, 2, 30, 2, 2], 10, 100, [(0, 2), (2, 3), (3, 5)]),
    # Empty messages take no bytes, only message slots.
    ([0, 0, 0, 0, 0], 1, 3, [(0, 2), (2, 4), (4, 5)]),
    # Under both limits: one launch; no messages: none.
    ([3, 4, 5], 100, 100, [(0, 3)]),
    ([], 10, 10, []),
])
def test_launch_spans_boundaries(lengths, max_bytes, max_items, want):
    offsets = _offsets(lengths)
    spans = ts.launch_spans(offsets, max_bytes, max_items)
    assert spans == want
    # Consecutive, covering, and under both limits unless one message alone.
    assert [lo for lo, _ in spans] == [0] + [hi for _, hi in spans][:-1] \
        or not spans
    assert (spans[-1][1] if spans else 0) == len(lengths)
    for lo, hi in spans:
        assert 0 < hi - lo < max_items
        assert (offsets[hi] - offsets[lo] < max_bytes) or hi - lo == 1


def test_launch_spans_group_whole_trees():
    # merkle_reduce's planner: m trees of `width` nodes, each group of
    # fewer than the limit's nodes, a tree at the limit alone.
    width, m = 9, 10
    assert ts.tree_groups(m, width, 28) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert ts.tree_groups(m, width, 27) == [(0, 2), (2, 4), (4, 6), (6, 8),
                                            (8, 10)]
    assert ts.tree_groups(m, width, 9) == [(i, i + 1) for i in range(m)]
    assert ts.tree_groups(m, width, 10) == [(i, i + 1) for i in range(m)]
    assert ts.tree_groups(0, width, 28) == []
    assert ts.tree_groups(m, width, 91) == [(0, m)]


def test_sha256_flat_splits_oversize_buffers(monkeypatch):
    # The byte and message limits cut to a few hundred, so the dispatcher
    # splits into views with rebased offsets; digests = hashlib and the JAX
    # package.
    calls = []
    plain = ts.sha256_flat_reference

    def counting(data, offsets):
        calls.append((int(data.numel()), int(offsets.shape[0]) - 1))
        assert int(offsets[0]) == 0 and int(offsets[-1]) == data.numel()
        return plain(data, offsets)

    monkeypatch.setattr(ts, "sha256_flat_reference", counting)
    monkeypatch.setattr(ts, "SHA256_MAX_BYTES", 300)
    monkeypatch.setattr(ts, "SHA256_MAX_MESSAGES", 7)
    rng = random.Random(3)
    msgs = [rng.randbytes(rng.randrange(0, 150)) for _ in range(40)]
    msgs[17] = rng.randbytes(400)  # over the byte limit: its own launch
    got = ts.sha256_many(msgs, device="cpu")
    assert got == _sha(msgs) == sj.sha256_many(msgs)
    assert len(calls) >= 7 and (400, 1) in calls
    assert all(b < 300 and k < 7 for b, k in calls if (b, k) != (400, 1))
    assert sum(k for _, k in calls) == len(msgs)


def test_merkle_reduce_splits_oversize_levels(monkeypatch):
    monkeypatch.setattr(ts, "MERKLE_MAX_NODES", 20)
    rng = random.Random(5)
    groups = [[rng.randbytes(32) for _ in range(9)] for _ in range(11)]
    want = [MerkleTree.build([SecureHash(h) for h in g]).hash.bytes
            for g in groups]
    assert ts.merkle_roots(groups, device="cpu") == want
    assert want == [bytes(JaxMerkleTree.build(
        [JaxSecureHash(h) for h in g]).hash.bytes) for g in groups]
