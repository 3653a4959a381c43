"""The CUDA sources' arithmetic, compiled for the host and held to the
oracle, hashlib and the port's plain PyTorch versions.

Both csrc/*.cu files write their math as host+device functions; compiled
as C++ (no nvcc needed) they export *_host entry points running the exact
code the kernels run, one lane after another. These tests are how the
kernels' arithmetic is checked where there is no card; the launch itself
is checked on the card by chip_smoke.py. Every comparison is exact
(integers and bits).
"""

import ctypes
import hashlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import _build, kernels
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import sha512 as tsha

P, L = ref.P, ref.L
M32 = (1 << 32) - 1
rng = np.random.default_rng(2024)


def _host_lib(tmp_path_factory, src):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc") / (src + ".so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
                    "-o", str(out), f"{_build.CSRC}/{src}"], check=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def verify_lib(tmp_path_factory):
    return _host_lib(tmp_path_factory, "ed25519_verify.cu")


@pytest.fixture(scope="module")
def sha_lib(tmp_path_factory):
    return _host_lib(tmp_path_factory, "sha512_challenge.cu")


def _source(src):
    with open(f"{_build.CSRC}/{src}") as f:
        return f.read()


def _macro_ints(text, name):
    """Hex literals of ``#define name ...`` (continuation lines joined)."""
    for line in text.replace("\\\n", " ").splitlines():
        if line.startswith(f"#define {name} "):
            return [int(x, 16)
                    for x in re.findall(r"0x([0-9a-fA-F]+)U(?:LL)?", line)]
    raise AssertionError(f"no #define {name}")


def _of_limbs(limbs, radix):
    return sum(v << (radix * i) for i, v in enumerate(limbs))


def test_verify_kernel_constants_match_oracle():
    text = _source("ed25519_verify.cu")
    assert _of_limbs(_macro_ints(text, "FE_D"), 32) == ref.D
    assert _of_limbs(_macro_ints(text, "FE_D2"), 32) == 2 * ref.D % P
    assert _of_limbs(_macro_ints(text, "FE_SQRTM1"), 32) == ref.SQRT_M1
    # fe_sub's offset: 4p as nine 32-bit words
    words = ([_macro_ints(text, "P4_LO")[0]] + [_macro_ints(text, "P4_MID")[0]] * 7
             + [int(re.search(r"#define P4_TOP (\d+)U", text).group(1))])
    assert _of_limbs(words, 32) == 4 * P


def test_challenge_kernel_constants_match_oracle():
    text = _source("sha512_challenge.cu")
    delta = L - 2**252
    assert _macro_ints(text, "SC_DELTA0")[0] | (
        _macro_ints(text, "SC_DELTA1")[0] << 64) == delta
    assert _of_limbs(_macro_ints(text, "SC_L"), 64) == L
    assert _of_limbs(_macro_ints(text, "SC_L_2P133"), 64) == L << 133
    assert _of_limbs(_macro_ints(text, "SC_L_2P7"), 64) == L << 7
    k = [int(x, 16) for x in re.findall(r"0x([0-9a-f]{16})ULL",
                                         text.split("K512[80]")[1])[:80]]
    assert k == tsha.K512


def _words(vals):
    """Python ints < 2^256 -> (n, 8) little-endian uint32 words."""
    return np.array([[(v >> (32 * i)) & M32 for i in range(8)] for v in vals],
                    np.uint32)


def _ints(arr):
    return [_of_limbs([int(x) for x in row], 32) for row in arr]


# Lazy-reduced values up to 2^256 - 1: every field op takes any 256 bits.
EDGE = [0, 1, 2, 19, 38, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**255 - 20,
        2**255, 2 * P, 2 * P + 37, 2**256 - 38, 2**256 - 39, 2**256 - 1, 608]


@pytest.mark.parametrize("op,name,fn", [
    (0, "mul", lambda a, b: a * b % P),
    (1, "sq", lambda a, b: a * a % P),
    (2, "add", lambda a, b: (a + b) % P),
    (3, "sub", lambda a, b: (a - b) % P),
    (4, "neg", lambda a, b: -a % P),
    (5, "freeze", lambda a, b: a % P),
    (6, "invert", lambda a, b: pow(a, P - 2, P)),
    (7, "pow22523", lambda a, b: pow(a, (P - 5) // 8, P)),
])
def test_field_ops_match_python_ints(verify_lib, op, name, fn):
    # Inputs are any 256-bit values; freeze's output is compared exactly
    # (canonical), the others by value mod p.
    vals_a = EDGE + [int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    vals_b = list(reversed(EDGE)) + [int.from_bytes(rng.bytes(32), "little")
                                     for _ in range(40)]
    got = _fe_op(verify_lib, op, vals_a, vals_b)
    want = [fn(x, y) for x, y in zip(vals_a, vals_b)]
    if name == "freeze":
        assert got == want
    else:
        assert [g % P for g in got] == want


def _fe_op(verify_lib, op, vals_a, vals_b):
    """fe_op_host over pairs of Python ints < 2^256 -> output ints."""
    a, b = _words(vals_a), _words(vals_b)
    out = np.zeros_like(a)
    ptr = ctypes.c_void_p
    verify_lib.fe_op_host.argtypes = [ctypes.c_int, ptr, ptr, ptr, ctypes.c_int]
    assert verify_lib.fe_op_host(op, a.ctypes.data, b.ctypes.data,
                                 out.ctypes.data, len(vals_a)) == 0
    return _ints(out)


@pytest.mark.parametrize("op,fn", [
    (0, lambda a, b: a * b),
    (2, lambda a, b: a + b),
    (3, lambda a, b: a - b),
], ids=["mul", "add", "sub"])
def test_field_ops_on_every_pair_of_edge_values(verify_lib, op, fn):
    # Every ordered pair of lazy-reduced edge values, so each carry chain
    # meets all-ones words, a carry out of the top word and the fold's
    # second carry from both sides.
    pairs = [(x, y) for x in EDGE for y in EDGE]
    got = _fe_op(verify_lib, op, [x for x, _ in pairs], [y for _, y in pairs])
    assert [g % P for g in got] == [fn(x, y) % P for x, y in pairs]


@pytest.mark.parametrize("name,s", [
    ("zero", 0),
    ("one", 1),
    ("all_ones", 2**256 - 1),
    ("L_minus_1", L - 1),
    ("L", L),
    ("S_plus_L", (2**252 + 12345) + L),
    ("S_or_2^255", 0x1234567 | 2**255),
    ("all_sevens", int("7" * 64, 16)),
    ("all_eights", int("8" * 64, 16)),
    ("random", int.from_bytes(rng.bytes(32), "little")),
])
def test_signed_digit_recoding(verify_lib, name, s):
    # Digits 0..63 in -8..7 and digit 64 (the carry) in 0..1 must sum back
    # to s over all 256 bits: S >= 2^255 and S + L are not reduced.
    digits = np.zeros((1, 65), np.int32)
    ptr = ctypes.c_void_p
    verify_lib.recode_host.argtypes = [ptr, ptr, ctypes.c_int]
    assert verify_lib.recode_host(_words([s]).ctypes.data,
                                  digits.ctypes.data, 1) == 0
    d = [int(x) for x in digits[0]]
    assert all(-8 <= x <= 7 for x in d[:64]) and d[64] in (0, 1)
    assert sum(x * 16**i for i, x in enumerate(d)) == s


def _corpus():
    """Golden cases: valid, corrupted, S+L, non-canonical A and R, an
    invalid point, all-zero lanes."""
    cases = []
    for i in range(6):
        seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        pk = ref.public_key(seed)
        msg = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = ref.sign(seed, msg)
        cases.append((pk, msg, sig))
        if i == 0:
            s2 = int.from_bytes(sig[32:], "little") + L
            cases.append((pk, msg, sig[:32] + s2.to_bytes(32, "little")))
            cases.append((pk, msg, sig[:1] + bytes([sig[1] ^ 4]) + sig[2:]))
            cases.append((pk, msg, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]))
            cases.append((pk, bytes(32), sig))
            cases.append((pk, msg, sig[:63] + bytes([sig[63] | 0x80])))
            cases.append((pk, msg, sig[:32] + b"\xff" * 32))  # all-ones S
    for y in range(19):
        x = ref._recover_x(y, 0)
        if x is not None:
            enc = int.from_bytes(ref.compress((x, y)), "little")
            noncanon = (enc + P).to_bytes(32, "little")
            cases.append((noncanon, bytes(32), bytes(64)))
            pk, msg, sig = cases[0]
            cases.append((pk, msg, noncanon + sig[32:]))
            break
    for y in range(2, 100):
        if ref._recover_x(y, 0) is None:
            cases.append((y.to_bytes(32, "little"), cases[0][1], cases[0][2]))
            break
    cases.append((bytes(32), bytes(32), bytes(64)))
    return cases


def test_verify_kernel_arithmetic_matches_oracle_and_plain(verify_lib):
    cases = _corpus()
    (a, r, s, m), n = ted.precompute_batch_device(
        [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases],
        bucket=len(cases))
    h = tsha.challenge_words_reference(*(ted.words_to_tensor(w, "cpu")
                                         for w in (r, a, m)))
    h = h.numpy().view(np.uint32)
    btab = kernels.b_table_niels()
    out = np.zeros(n, np.int32)
    ptr = ctypes.c_void_p
    verify_lib.ed25519_verify_host.argtypes = [ptr] * 6 + [ctypes.c_int]
    verify_lib.ed25519_verify_host(
        a.ctypes.data, r.ctypes.data, s.ctypes.data, h.ctypes.data,
        btab.ctypes.data, out.ctypes.data, n)
    want = [ref.verify(*c) for c in cases]
    assert out.astype(bool).tolist() == want
    plain = ted.verify_arrays_reference(*(ted.words_to_tensor(w, "cpu")
                                          for w in (a, r, s, h)))
    assert plain.tolist() == want
    assert any(want) and not all(want)


def test_challenge_kernel_arithmetic_matches_hashlib(sha_lib):
    n = 40
    r = rng.integers(0, 256, (n, 32), np.uint8)
    a = rng.integers(0, 256, (n, 32), np.uint8)
    m = rng.integers(0, 256, (n, 32), np.uint8)
    r[0] = a[0] = m[0] = 0
    r[1] = a[1] = m[1] = 0xFF
    words = [ted._words_of(x) for x in (r, a, m)]
    out = np.zeros((8, n), np.uint32)
    ptr = ctypes.c_void_p
    sha_lib.sha512_challenge_host.argtypes = [ptr] * 4 + [ctypes.c_int]
    sha_lib.sha512_challenge_host(*(w.ctypes.data for w in words),
                                  out.ctypes.data, n)
    plain = tsha.challenge_words_reference(
        *(ted.words_to_tensor(w, "cpu") for w in words)).numpy().view(np.uint32)
    assert np.array_equal(out, plain)
    for i in range(n):
        want = int.from_bytes(hashlib.sha512(
            r[i].tobytes() + a[i].tobytes() + m[i].tobytes()).digest(),
            "little") % L
        assert sum(int(out[w, i]) << (32 * w) for w in range(8)) == want


def test_wrappers_reject_cpu_tensors():
    words = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ed25519_verify_cuda(words, words, words, words)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sha512_challenge_cuda(words, words, words)
    elems = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fe_op_cuda(0, elems, elems)


def test_b_table_is_one_to_eight_b_in_words():
    # kernels.b_table_niels: [1..8]B as (y+x, y-x, 2dxy) mod p in 8 words.
    tab = kernels.b_table_niels()
    assert tab.shape == (8, 3, 8) and tab.dtype == np.uint32
    for k in range(1, 9):
        x, y = ref.scalar_mult(k, ref.B)
        want = [(y + x) % P, (y - x) % P, 2 * ref.D * x * y % P]
        assert [_of_limbs([int(w) for w in c], 32) for c in tab[k - 1]] == want


@pytest.fixture(scope="module")
def sha256_lib(tmp_path_factory):
    return _host_lib(tmp_path_factory, "sha256.cu")


def _u32_table(text, name):
    body = text.split(f"{name}[64] = {{")[1].split("};")[0]
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_sha256_kernel_constants():
    from corda_tpu_torch.ops import sha256 as ts

    text = _source("sha256.cu")
    assert _u32_table(text, "K256") == ts.K256
    # KW_PAD64: K[t] + W[t] over the pad block of a 64-byte message.
    w = list(ts.PAD_BLOCK_64)
    rotr = ts._rotr
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    assert _u32_table(text, "KW_PAD64") == [(k + x) & M32
                                            for k, x in zip(ts.K256, w)]
    h0 = re.search(r"#define SHA256_H0 \{([^}]*)\}",
                   text.replace("\\\n", " ")).group(1)
    assert [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", h0)] == \
        ts.H0_256
    depth = re.search(r"#define MERKLE_MAX_DEPTH (\d+)", text).group(1)
    assert int(depth) == ts.MERKLE_DEPTH == kernels.MERKLE_DEPTH


def _sha256_host(lib, msgs):
    from corda_tpu_torch.ops import sha256 as ts

    data, offsets = ts.pack_flat(msgs)
    return _sha256_host_flat(lib, data, offsets)


def _sha256_host_flat(lib, data, offsets):
    """sha256_many_host over a uint8 buffer (any view) and its offsets."""
    n = len(offsets) - 1
    out = np.zeros((8, n), np.uint32)
    ptr = ctypes.c_void_p
    lib.sha256_many_host.argtypes = [ptr, ptr, ptr, ctypes.c_int,
                                     ctypes.c_int64]
    assert lib.sha256_many_host(data.ctypes.data, offsets.ctypes.data,
                                out.ctypes.data, n, data.size) == 0
    return out


def _digests(out):
    return [col.astype(">u4").tobytes() for col in out.T]


def test_sha256_many_kernel_arithmetic_matches_hashlib(sha256_lib):
    # Every length 0..300 (each padding regime and block count 1..5) plus
    # long messages, in one call: the kernel pads each message itself.
    from corda_tpu_torch.ops import sha256 as ts

    msgs = [rng.bytes(n) for n in list(range(301)) + [1000, 4097]]
    out = _sha256_host(sha256_lib, msgs)
    assert _digests(out) == [hashlib.sha256(m).digest() for m in msgs]
    some = msgs[::37]
    data, offsets = ts.pack_flat(some)
    plain = ts.sha256_flat_reference(torch.from_numpy(data.copy()),
                                     torch.from_numpy(offsets))
    assert np.array_equal(_sha256_host(sha256_lib, some),
                          plain.numpy().view(np.uint32))


# The padding boundaries, the resolve wave's leaf sizes (a command leaf of
# 166 bytes, output leaves of 317-318) and a many-block message.
SHA_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 166, 317, 318, 1000)


@pytest.mark.parametrize("start", range(16))
def test_sha256_many_windows_at_every_alignment(sha256_lib, start):
    # The buffer starts at `start` mod 16, so its messages start at every
    # offset mod 16 over the edge lengths, and the last message ends at the
    # buffer's last byte: the bytes around the view are 0xff, which only the
    # masks keep out of the digests.
    from corda_tpu_torch.ops import sha256 as ts

    msgs = [rng.bytes(n) for n in SHA_EDGE_LENGTHS for _ in range(2)]
    msgs += [rng.bytes(n) for n in SHA_EDGE_LENGTHS[::-1]]
    flat, offsets = ts.pack_flat(msgs)
    room = np.full(flat.size + 64, 0xFF, np.uint8)
    lead = (start - room.ctypes.data) % 16
    view = room[lead:lead + flat.size]
    view[:] = flat
    assert view.ctypes.data % 16 == start
    out = _sha256_host_flat(sha256_lib, view, offsets)
    assert _digests(out) == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 129])
def test_sha256_many_ctas_of_any_count(sha256_lib, n):
    # N around the CTA's 64 messages: a last CTA with idle threads, whose
    # copies still cover the other threads' messages.
    lengths = rng.integers(0, 400, n)
    msgs = [rng.bytes(int(k)) for k in lengths]
    out = _sha256_host(sha256_lib, msgs)
    assert out.shape == (8, n)
    assert _digests(out) == [hashlib.sha256(m).digest() for m in msgs]


def test_sha256_many_long_message_beside_short_ones(sha256_lib):
    # A 100 KB message (1,563 blocks) in one CTA with short ones: the CTA
    # steps to its longest message through the 3-stage ring.
    msgs = [rng.bytes(5), rng.bytes(100_000), rng.bytes(64), b""]
    out = _sha256_host(sha256_lib, msgs)
    assert _digests(out) == [hashlib.sha256(m).digest() for m in msgs]


def _merkle_host(lib, level, depth, sms=132):
    """merkle_reduce_host: (8, m, width) uint32 -> (8, m, ceil(width /
    2^depth))."""
    m, width = level.shape[1], level.shape[2]
    out = np.zeros((8, m, -(-width // 2**depth)), np.uint32)
    ptr = ctypes.c_void_p
    lib.merkle_reduce_host.argtypes = [ptr, ptr] + [ctypes.c_int] * 4
    assert lib.merkle_reduce_host(np.ascontiguousarray(level).ctypes.data,
                                  out.ctypes.data, m, width, depth,
                                  sms) == 0
    return out


@pytest.mark.parametrize("width", [1, 2, 3, 8, 9, 31, 32, 33, 1000])
def test_sha256_pair_kernel_arithmetic_matches_hashlib(sha256_lib, width):
    # The reduce at depth 1 is one level: each node against hashlib and the
    # plain level. Then whole trees as merkle_roots reduces them (depth up
    # to 5 a launch) against the plain level looped and MerkleTree.build,
    # with CTAs that cut trees and chunks anywhere (the CTAs shared out over
    # 1, 7 and 132 SMs).
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.crypto.merkle import MerkleTree
    from corda_tpu_torch.ops import sha256 as ts

    m = 4
    level = rng.integers(0, 2**32, (8, m, width),
                         dtype=np.uint64).astype(np.uint32)
    wout = (width + 1) // 2
    out = _merkle_host(sha256_lib, level, 1)
    for t in range(m):
        for j in range(wout):
            pair = (level[:, t, 2 * j], level[:, t, min(2 * j + 1, width - 1)])
            want = hashlib.sha256(b"".join(x.astype(">u4").tobytes()
                                           for x in pair)).digest()
            assert out[:, t, j].astype(">u4").tobytes() == want
    plain = torch.from_numpy(level.view(np.int32))
    assert np.array_equal(out, ts.merkle_level_reference(plain).numpy()
                          .view(np.uint32))
    while plain.shape[2] > 1:
        plain = ts.merkle_level_reference(plain)
    trees = [MerkleTree.build([SecureHash(level[:, t, j].astype(">u4")
                                          .tobytes()) for j in range(width)])
             .hash.bytes for t in range(m)]
    assert _digests(plain.numpy().view(np.uint32)[:, :, 0]) == trees
    for sms in (1, 7, 132):
        roots = level
        while roots.shape[2] > 1:
            depth = min(ts.MERKLE_DEPTH, (roots.shape[2] - 1).bit_length())
            roots = _merkle_host(sha256_lib, roots, depth, sms)
        assert _digests(roots[:, :, 0]) == trees


@pytest.mark.parametrize("width,depth", [(1, 3), (5, 5), (40, 2), (64, 5),
                                         (100, 4)])
def test_merkle_reduce_depth_is_that_many_levels(sha256_lib, width, depth):
    # Any depth on any width is exactly `depth` plain levels, also where it
    # runs past the root (a width-1 level hashes its node with itself).
    from corda_tpu_torch.ops import sha256 as ts

    level = rng.integers(0, 2**32, (8, 3, width),
                         dtype=np.uint64).astype(np.uint32)
    plain = torch.from_numpy(level.view(np.int32))
    assert np.array_equal(_merkle_host(sha256_lib, level, depth, 2),
                          ts.merkle_reduce(plain, depth).numpy()
                          .view(np.uint32))


def test_sha256_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sha256_many_cuda(torch.zeros(4, dtype=torch.uint8),
                                 torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.merkle_reduce_cuda(torch.zeros((8, 2, 3), dtype=torch.int32))
