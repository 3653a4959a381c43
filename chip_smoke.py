"""Drive corda_tpu_torch's main path on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA card, nvcc and
this checkout):

    python3 chip_smoke.py

To compare the SHA-256 kernels of two checkouts on one card (each tree's
corda_tpu_torch built and timed in its own process, in the order given,
for example parent, change, change, parent):

    python3 chip_smoke.py --sha256-turns PARENT_TREE . . PARENT_TREE

Phases, in order; any failure exits non-zero and prints no result:
  1. probe    -- a CUDA device must exist; print its name and power limit.
  2. build    -- compile the three csrc/ sources with nvcc (in parallel).
  3. host     -- (a) build the host tier's native core (gcc, libcrypto);
                 CpuVerifier against the oracle on the golden corpus,
                 including the S + L lane the native core rejects.
  4. kernels  -- the verify kernel's field operations (its PTX carry
                 chains) on the card against Python integers; each kernel
                 against its plain PyTorch version on the card
                 on the golden corpus (valid, corrupted, S + L, non-canonical
                 A and R, an invalid point, all-zero lanes) at N = 1024 and
                 a ragged N = 1000, and the challenge against hashlib.
  5. main     -- 65,536 VerifyJobs with 32-byte tx ids through
                 TorchVerifier.verify_batch (native pack -> challenge kernel
                 -> verify kernel), answers held to the oracle; one batch of
                 variable-length messages (host-hashed); (b) the native and
                 numpy packers timed on the same inputs, byte-equal; kernel
                 times in a device-side window (behind a queued delay, so
                 the host's launch is outside it), and each wrapper's host
                 cost per call.
  6. crossover -- (c) all-valid tx-id batches of 1 .. 4,096 through
                 CpuVerifier and TorchVerifier(device_min_sigs=0): the
                 smallest size at which the card wins, beside the
                 provider's default; the host tier's cost split into the
                 timer, one native verify, libcrypto's per-signature cost on
                 one thread and the Python around it.
  7. stream   -- (d) verify_stream at depth 2 over 8 batches of 65,536
                 against 8 sequential verify_batch calls, answers held to
                 the oracle; sustained sigs/s and the device's idle share.
  8. sidecar  -- a SidecarServer on the card, three client threads sending
                 2,048-signature requests (one with a tampered job, one with
                 a malformed key); (e) then one request alone, one
                 signature under the crossover, which the host tier must
                 answer (reply tier 0). Every reply held to the oracle.
  9. degrade  -- (f) degrade_device on a card verifier: a batch of 1,024,
                 above the crossover, takes the host tier; the re-probe
                 reopens the
                 gate through the kernels; the next batch is a device batch.
 10. sha256   -- (a) the SHA-256 kernel (sha256_many) and the Merkle reduce
                 kernel (sha256_pair) against their plain versions on the
                 card and hashlib, tolerance 0: the padding edges at every
                 start offset mod 16, a ragged N = 1,000, N = 1, a 1 MB
                 message; 1,024 pairs, trees of width 1-40 and 1,000 launch
                 by launch; merkle_roots on those widths against
                 MerkleTree.build.
 11. resolve  -- (b) a wave of 8,192 SignedTransactions (73,728 leaves; 1%
                 with a flipped signature byte) built in the port and
                 serialized; prime_ids over fresh deserializations on the
                 host, then on the card (launch counts from 0), must give
                 the build-time ids; merkle_roots on the card must equal
                 them; one TorchVerifier.verify_batch over every signature
                 must reject exactly the tampered transactions; a swapped
                 id must raise "does not match". Tx/s and leaves/s on the
                 host and on the card, split into deserialize, component
                 serialize, hash, tree plus compare and verify; the card
                 route's hash step split into pack_flat, copy in, kernel,
                 copy out and digests_of; both SHA-256 kernels timed at the
                 wave's shapes (the wave's trees in one reduce launch).
 12. hashing crossover -- (c) hash_many_auto on the host against the card
                 over the wave's leaf messages, 256 ... 131,072.
 13. the verify kernel's registers, static SASS counts, resident blocks
     per SM and waves at N_MAIN, and the SHA-256 kernels' SASS counts (no
     byte loads in sha256_many's block loop) and occupancy at the wave;
     the kernels line, then the device line (last).

Everything is made from fixed seeds; the oracle (crypto/ref_ed25519.py)
decides every expected answer.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 20261016
N_MAIN = 65536          # the top of the bucket ladder: a notary-scale batch
N_DISTINCT = 256        # distinct signed (key, tx id) pairs, tiled to N_MAIN
TAMPER_FRACTION = 0.01

# H100 SXM peaks used for the bounds (NVIDIA data sheet): 3.35 TB/s of
# device memory; 32-bit integer multiply-add and ALU rate = 132 SMs x 64
# lanes x 1.98 GHz (half the 67 TFLOP/s float32 rate's 128 lanes per SM).
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9

# The least integer work per field multiply in radix 2^32 is 64 32x32->64
# products plus 8 for the reduction (36 + 8 for a square), each product
# two 32-bit multiply-adds (low and high halves).
MUL_INT_OPS, SQ_INT_OPS = 2 * 72, 2 * 44
# Work per signature of the verify kernel's own structure
# (csrc/ed25519_verify.cu), the same for every input: 1,835 field
# multiplies and 1,537 squarings -- decompression 20 + 255 (the pow22523
# chain 11 + 251), the [1..8](-A) table 60 + 4, the top-digit window
# 14 + 0, 64 windows of 27 + 16 (three doublings to p2, one to p3, a mixed
# add to p3, an add to p2), the final inversion and encode 13 + 254.
# Recorded beside the bound, which counts less (verify_least_int_ops).
VERIFY_FIELD_MULS = 1835
VERIFY_FIELD_SQS = 1537
VERIFY_BYTES = 4 * 32 + 4
# Challenge kernel: the least 32-bit instruction count per signature as
# Hopper issues it (csrc/sha512_challenge.cu), constants folded:
#   * a round is 28: each 64-bit rotate is one SHF funnel shift per half
#     (6 for Sigma0, 6 for Sigma1), each three-input XOR, Ch and Maj one
#     LOP3 per half (8), and the adds as IADD3/IADD3.X pairs: two for t1
#     (5 operands), one for a = t1 + Sigma0 + Maj, one for e = d + t1
#     (8); round 0, whose state is all H0, is 4 (a and e are w0 plus a
#     constant): 79 * 28 + 4;
#   * a schedule word is 20: sigma0 and sigma1 6 shifts + 2 LOP3 each,
#     the 4-operand sum two IADD3 pairs; W[12..15] are constants, which
#     saves 60 over t = 16..31 (sigma of a constant, 3-operand sums):
#     64 * 20 - 60;
#   * the final H0 + state adds, 8 * 2, and the byte swaps, one PRMT per
#     32-bit word: 24 in, 16 for the digest.
# The mod-L reduction is left out, so the bound stays a lower bound.
CHALLENGE_INT_OPS = (79 * 28 + 4) + (64 * 20 - 60) + 8 * 2 + (24 + 16)
CHALLENGE_BYTES = 3 * 32 + 32
VERIFY_KERNELS = ("ed25519_verify", "sha512_challenge")
# SHA-256 kernels (csrc/sha256.cu): the least 32-bit instructions per
# compression as Hopper issues them:
#   * a round is 14: each Sigma three SHF rotates and one LOP3 (8), Ch and
#     Maj one LOP3 each (2), t1 = h + Sigma1 + Ch + (K + W) an IADD3 pair
#     (2), a = t1 + Sigma0 + Maj and e = d + t1 one IADD3 each (2);
#   * a schedule word is 10: sigma0 and sigma1 two SHF and one SHR each
#     plus one LOP3 (8), the 4-operand sum an IADD3 pair (2);
#   * the 8 adds into the state.
# A data block: 64 * 14 + 48 * 10 + 8 = 1,384. The constant pad block of a
# Merkle node has no schedule work (its K + W are constants): 64 * 14 + 8.
# Padding, byte loads and the word assembly are left out, so the bound
# stays a lower bound.
SHA256_BLOCK_INT_OPS = 64 * 14 + 48 * 10 + 8
SHA256_PAD_BLOCK_INT_OPS = 64 * 14 + 8


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# A device-side delay queued before each timing window: ~5 ms at 1.98 GHz,
# far longer than any wrapper's enqueue (tens of microseconds).
DELAY_CYCLES = 10_000_000


def kernel_ms(fn, reps: int = 7) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up. Each window opens behind a queued device-side delay, so the
    host enqueues the start event, ``fn`` and the end event while the
    stream is still busy and the window holds only the device's work.
    Fails if an enqueue outlasted the delay (the window would then hold
    host time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(DELAY_CYCLES)
        ev[1].record()
        fn()
        ev[2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        delay_ms = ev[0].elapsed_time(ev[1])
        check(enqueue_ms < delay_ms,
              f"host enqueue took {enqueue_ms:.3f} ms, longer than the "
              f"device delay of {delay_ms:.3f} ms: the window holds host time")
        times.append(ev[1].elapsed_time(ev[2]))
    return statistics.median(times)


def idle_stream_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events recorded on an idle stream: the window
    also holds the host's launch of ``fn`` (its Python). Used for the plain
    versions, which are bound by their thousands of launches and cannot
    be queued behind kernel_ms's delay."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def wrapper_host_us(fn, calls: int) -> float:
    """Host-clock microseconds per call of ``fn`` over ``calls`` calls in a
    row, with no synchronisation inside the window: what a caller's thread
    spends to launch (checks, allocation, the ctypes call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def wnaf5(x: int) -> tuple[int, int]:
    """(nonzero digits, index of the top one or -1) of ``x`` in width-5
    signed sliding windows: odd digits in -15..15, at least four zeros
    after each, as ref10's slide() recodes a scalar (any 256 bits here)."""
    nonzero, top, i = 0, -1, 0
    while x:
        if x & 1:
            d = x & 31
            x -= d - 32 if d > 16 else d
            nonzero, top = nonzero + 1, i
        x >>= 1
        i += 1
    return nonzero, top


def verify_least_int_ops(s: np.ndarray, h: np.ndarray) -> tuple[int, dict]:
    """The least integer work of verifying the lanes whose (8, N) uint32
    scalar words are ``s`` and ``h``, counted as ref10's variable-time
    ge_double_scalarmult_vartime needs it for these scalars. That needs
    less than the kernel's fixed windows, which pay a full addition for
    a zero digit. Per signature:
      * decompression 20 mul + 255 sq, inversion and encode 13 + 254 (as
        in the kernel);
      * the odd multiples [1, 3, ..., 15](-A): 68 mul + 4 sq;
      * one doubling (4 sq) and its p2 form (3 mul) per bit from the top
        nonzero digit of either scalar down;
      * 8 mul per nonzero digit of h (an addition of a cached -A entry and
        the p3 form before it), 7 per nonzero digit of S (a mixed addition
        of a fixed B entry).
    Returns (integer ops of all lanes, per-signature means)."""
    cols = np.ascontiguousarray(np.concatenate([s, h]).T)
    uniq, counts = np.unique(cols, axis=0, return_counts=True)
    muls = sqs = 0
    for row, c in zip(uniq, counts):
        ns, ts = wnaf5(sum(int(w) << (32 * k) for k, w in enumerate(row[:8])))
        nh, th = wnaf5(sum(int(w) << (32 * k) for k, w in enumerate(row[8:])))
        bits = max(ts, th) + 1
        muls += int(c) * (20 + 13 + 68 + 3 * bits + 8 * nh + 7 * ns)
        sqs += int(c) * (255 + 254 + 4 + 4 * bits)
    n = cols.shape[0]
    return (muls * MUL_INT_OPS + sqs * SQ_INT_OPS,
            {"field_muls": muls / n, "field_sqs": sqs / n})


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of ``fn`` (each run synchronised)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------


def golden_cases(ref, rng):
    """(pk, msg, sig) golden corpus with 32-byte messages."""
    cases = []
    for i in range(8):
        seed = rng.bytes(32)
        pk = ref.public_key(seed)
        msg = rng.bytes(32)
        sig = ref.sign(seed, msg)
        cases.append((pk, msg, sig))
        if i == 0:
            s_plus_l = int.from_bytes(sig[32:], "little") + ref.L
            cases += [
                (pk, msg, sig[:32] + s_plus_l.to_bytes(32, "little")),
                (pk, msg, bytes([sig[0] ^ 1]) + sig[1:]),          # R bit
                (pk, msg, sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]),
                (pk, bytes(32), sig),                              # wrong msg
                (bytes([pk[0] ^ 8]) + pk[1:], msg, sig),           # wrong key
                (pk, msg, sig[:63] + bytes([sig[63] | 0x80])),     # S >= 2^255
            ]
    for y in range(19):  # a point with y < 19 has a second encoding y + p
        x = ref._recover_x(y, 0)
        if x is not None:
            noncanon = (int.from_bytes(ref.compress((x, y)), "little")
                        + ref.P).to_bytes(32, "little")
            pk, msg, sig = cases[0]
            cases += [(noncanon, msg, sig), (noncanon, bytes(32), bytes(64)),
                      (pk, msg, noncanon + sig[32:])]
            break
    for y in range(2, 100):
        if ref._recover_x(y, 0) is None:
            cases.append((y.to_bytes(32, "little"), cases[0][1], cases[0][2]))
            break
    return cases


def tile(cases, expect, n, zero_tail=0):
    """n lanes cycling through ``cases``; the last ``zero_tail`` lanes
    all-zero key, message and signature."""
    zero = (bytes(32), bytes(32), bytes(64))
    idx = [i % len(cases) for i in range(n - zero_tail)]
    lanes = [cases[i] for i in idx] + [zero] * zero_tail
    want = [expect[i] for i in idx]
    return lanes, want


def words_of_ints(vals) -> np.ndarray:
    """Python ints < 2^256 -> (n, 8) little-endian uint32 words."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], np.uint32)


def phase_field_ops(ref, kernels, dev, rng):
    """Phase 3a: the verify kernel's field operations on the card (the PTX
    carry chains; the CPU tests see only their C twin) against Python
    integers: freeze exactly, the others mod p, on edge values of the lazy
    representation (any 256 bits) and random ones."""
    p = ref.P
    ops = [("mul", lambda a, b: a * b % p), ("sq", lambda a, b: a * a % p),
           ("add", lambda a, b: (a + b) % p), ("sub", lambda a, b: (a - b) % p),
           ("neg", lambda a, b: -a % p), ("freeze", lambda a, b: a % p),
           ("invert", lambda a, b: pow(a, p - 2, p)),
           ("pow22523", lambda a, b: pow(a, (p - 5) // 8, p))]
    edge = [0, 1, 2, 19, 38, p - 1, p, p + 1, p + 18, 2**255 - 1,
            2**255 - 20, 2**255, 2 * p, 2 * p + 37, 2**256 - 38, 2**256 - 39,
            2**256 - 1, 608]
    va = edge + [int.from_bytes(rng.bytes(32), "little") for _ in range(2030)]
    vb = edge[::-1] + [int.from_bytes(rng.bytes(32), "little")
                       for _ in range(2030)]
    a, b = (torch.from_numpy(words_of_ints(v).view(np.int32)).to(dev)
            for v in (va, vb))
    for op, (name, fn) in enumerate(ops):
        out = kernels.fe_op_cuda(op, a, b).cpu().numpy().view(np.uint32)
        got = [sum(int(x) << (32 * i) for i, x in enumerate(row)) for row in out]
        want = [fn(x, y) for x, y in zip(va, vb)]
        if name == "freeze":
            check(got == want, "fe_freeze on the card != Python ints")
        else:
            bad = sum(g % p != w for g, w in zip(got, want))
            check(bad == 0, f"fe_{name} on the card != Python ints on {bad} "
                            f"of {len(va)} values")
    log(f"field ops on the card: {len(ops)} ops x {len(va)} values "
        f"({len(edge)} edge) equal Python integers")


def phase_kernels(ref, ted, tsha, kernels, dev, rng, zero_ok):
    """Phase 3: kernel vs plain version (and oracle) on the golden corpus."""
    cases = golden_cases(ref, rng)
    expect = [ref.verify(*c) for c in cases]
    check(any(expect) and not all(expect), "golden corpus is degenerate")
    max_err = {"ed25519_verify": 0, "sha512_challenge": 0}
    for n in (1024, 1000):
        lanes, want = tile(cases, expect, n, zero_tail=24)
        want += [zero_ok] * 24
        (a, r, s, m), _ = ted.precompute_batch_device(
            [c[0] for c in lanes], [c[1] for c in lanes],
            [c[2] for c in lanes], bucket=n)
        A, R, S, M = (ted.words_to_tensor(w, dev) for w in (a, r, s, m))
        h_k = kernels.sha512_challenge_cuda(R, A, M)
        h_p = tsha.challenge_words_reference(R, A, M)
        torch.cuda.synchronize()
        max_err["sha512_challenge"] = max(
            max_err["sha512_challenge"],
            int((h_k.long() - h_p.long()).abs().max()))
        check(torch.equal(h_k, h_p), f"challenge kernel != plain at N={n}")
        h_np = h_k.cpu().numpy().view(np.uint32)
        for i in range(0, n, 97):  # a sample against hashlib + % L
            c = lanes[i]
            want_h = int.from_bytes(hashlib.sha512(
                c[2][:32] + c[0] + c[1]).digest(), "little") % ref.L
            got_h = sum(int(h_np[w, i]) << (32 * w) for w in range(8))
            check(got_h == want_h, f"challenge != hashlib at lane {i}")
        ok_k = kernels.ed25519_verify_cuda(A, R, S, h_k)
        ok_p = ted.verify_arrays_reference(A, R, S, h_p)
        torch.cuda.synchronize()
        max_err["ed25519_verify"] = max(
            max_err["ed25519_verify"],
            int((ok_k.long() - ok_p.long()).abs().max()))
        check(torch.equal(ok_k.bool(), ok_p), f"verify kernel != plain at N={n}")
        check(ok_k.bool().cpu().tolist() == want,
              f"verify kernel != oracle at N={n}")
        log(f"kernels vs plain at N={n} (tolerance 0: integer outputs must "
            f"be identical): challenge and verify identical, "
            f"{sum(want)} accepted of {n}")
    return max_err


def main_jobs(ref, provider, rng):
    """N_MAIN tx-id jobs from N_DISTINCT signed pairs plus tampered copies
    at seeded positions; the expected answer of every distinct tuple comes
    from the oracle."""
    VerifyJob = provider.VerifyJob
    distinct = []
    for _ in range(N_DISTINCT):
        seed = rng.bytes(32)
        txid = rng.bytes(32)
        distinct.append((ref.public_key(seed), txid, ref.sign(seed, txid)))
    tampered = []
    for k in range(64):
        pk, msg, sig = distinct[k]
        kind = k % 3
        if kind == 0:
            sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]
        elif kind == 1:
            sig = sig[:50] + bytes([sig[50] ^ 0x01]) + sig[51:]
        else:
            msg = bytes([msg[0] ^ 0x80]) + msg[1:]
        tampered.append((pk, msg, sig))
    tuples = distinct + tampered
    expect = [ref.verify(*t) for t in tuples]
    check(all(expect[:N_DISTINCT]) and not any(expect[N_DISTINCT:]),
          "oracle disagrees with its own signatures")
    idx = np.arange(N_MAIN) % N_DISTINCT
    n_tamper = int(N_MAIN * TAMPER_FRACTION)
    pos = rng.choice(N_MAIN, n_tamper, replace=False)
    idx[pos] = N_DISTINCT + rng.integers(0, len(tampered), n_tamper)
    jobs = [VerifyJob(*tuples[i]) for i in idx]
    want = np.array([expect[i] for i in idx], bool)
    return jobs, want, tuples, expect


def phase_host_tier(ref, provider, native, fast_ed25519):
    """Phase 3 (a): build the native core on this host and hold CpuVerifier
    to the oracle on the golden corpus, including the S + L lane that
    libcrypto rejects (S >= L) and the oracle accepts."""
    import sysconfig

    include = sysconfig.get_paths()["include"]
    t0 = time.perf_counter()
    core = native.load_cverify()
    load_s = time.perf_counter() - t0
    check(core is not None,
          f"native core did not build (Python.h in {include}: "
          f"{os.path.exists(os.path.join(include, 'Python.h'))}, libcrypto "
          f"{native._libcrypto_path()}): the host tier would be the oracle")
    log(f"native core: gcc {native.BUILD_SECONDS.get('_cverify', 0.0):.2f} s "
        f"(load {load_s:.2f} s) -> {core.__file__}; Python.h from {include}; "
        f"libcrypto {native._libcrypto_path()}; OpenSSL re-check path "
        f"(cryptography) {'on' if fast_ed25519.available() else 'off'}")
    cases = golden_cases(ref, np.random.default_rng(SEED + 1))
    expect = [ref.verify(*c) for c in cases]
    got = provider.CpuVerifier().verify_batch(
        [provider.VerifyJob(*c) for c in cases])
    check(got.tolist() == expect, "CpuVerifier != oracle on the golden corpus")
    raw = core.verify_many(*([c[k] for c in cases] for k in range(3)))
    s_plus_l = 1  # golden_cases' second case
    check(expect[s_plus_l] and raw[s_plus_l] == 0 and got[s_plus_l],
          "the S + L lane: the oracle must accept it, libcrypto reject it "
          "and CpuVerifier accept it")
    check(all(expect[i] for i in range(len(cases)) if raw[i]),
          "the native core accepted a lane the oracle rejects")
    log(f"host tier: CpuVerifier = oracle on {len(cases)} golden cases "
        f"({sum(expect)} valid; the S + L lane rejected natively, accepted "
        f"through the oracle)")
    return {"native_build_s": native.BUILD_SECONDS.get("_cverify"),
            "native_path": core.__file__, "python_include": include,
            "libcrypto": native._libcrypto_path(),
            "openssl_recheck": fast_ed25519.available()}


def phase_main(ref, provider, native, ted, tsha, kernels, dev, rng, card):
    """Phase 5: the main path at full size, then its timings."""
    jobs, want, tuples, expect = main_jobs(ref, provider, rng)
    verifier = provider.TorchVerifier(device="cuda")
    check(native.pack_backend() == "native",
          "the main path would pack with numpy: the native core is missing")

    kernels.reset_launches()
    got = verifier.verify_batch(jobs)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in VERIFY_KERNELS}
    check(got.shape == (N_MAIN,) and got.dtype == bool, "bad result shape")
    check(np.array_equal(got, want),
          f"main path != oracle on {int((got != want).sum())} lanes")
    check(launches["ed25519_verify"] > 0 and launches["sha512_challenge"] > 0,
          f"main path did not launch both kernels: {launches}")
    check(verifier.device_batches == 1 and verifier.host_batches == 0,
          "the main path's batch did not take the device")
    log(f"main path: {N_MAIN} sigs match the oracle "
        f"({int(want.sum())} valid, {int((~want).sum())} tampered); "
        f"launches {launches}; packer {native.pack_backend()}")

    # Variable-length messages take the host-hashed path (verify kernel only).
    var = []
    for k in range(16):
        seed = bytes([k + 1]) * 32
        msg = rng.bytes(int(rng.integers(0, 200)))
        sig = ref.sign(seed, msg)
        if k % 4 == 3:
            msg += b"!"
        var.append((ref.public_key(seed), msg, sig))
    var_expect = [ref.verify(*t) for t in var]
    var_jobs = [provider.VerifyJob(*var[i % 16]) for i in range(512)]
    var_got = verifier.verify_batch(var_jobs)
    check(var_got.tolist() == [var_expect[i % 16] for i in range(512)],
          "host-hashed path != oracle")
    check(verifier.device_batches == 2, "the host-hashed batch took the host")
    log("host-hashed path: 512 sigs with variable-length messages match")

    # (b) Packing: the native packer (the main path's) against numpy.
    pks = [j.pubkey for j in jobs]
    msgs = [j.message for j in jobs]
    sigs = [j.sig for j in jobs]
    native_words, _ = ted.precompute_batch_device(pks, msgs, sigs, N_MAIN)
    numpy_words, _ = ted.precompute_batch_device_numpy(pks, msgs, sigs, N_MAIN)
    check(all(x.tobytes() == y.tobytes()
              for x, y in zip(native_words, numpy_words)),
          "native and numpy packers differ at N=65536")
    pack_ms, pack_numpy_ms = [], []
    for turn in range(6):  # in turns: numpy, native, native, numpy, ...
        fn, out = ((ted.precompute_batch_device_numpy, pack_numpy_ms)
                   if turn % 4 in (0, 3) else
                   (ted.precompute_batch_device, pack_ms))
        out.append(host_ms(lambda: fn(pks, msgs, sigs, N_MAIN), reps=1))
    pack_ms, pack_numpy_ms = (statistics.median(x)
                              for x in (pack_ms, pack_numpy_ms))

    # Kernel times at the main path's shapes in the device-side window, and
    # each wrapper's host cost per call.
    A, R, S, M = (ted.words_to_tensor(w, dev) for w in native_words)
    h = kernels.sha512_challenge_cuda(R, A, M)
    k2_ms = kernel_ms(lambda: kernels.sha512_challenge_cuda(R, A, M))
    k1_ms = kernel_ms(lambda: kernels.ed25519_verify_cuda(A, R, S, h))
    k2_host_us = wrapper_host_us(
        lambda: kernels.sha512_challenge_cuda(R, A, M), calls=200)
    k1_host_us = wrapper_host_us(
        lambda: kernels.ed25519_verify_cuda(A, R, S, h), calls=20)
    least_ops, least_per_sig = verify_least_int_ops(
        *(t.cpu().numpy().view(np.uint32) for t in (S, h)))

    # Plain versions on the same inputs; the first run of each is also the
    # full-size comparison with the kernel.
    h_p = tsha.challenge_words_reference(R, A, M)
    check(torch.equal(h_p, h), "challenge kernel != plain at N=65536")
    ok_k = kernels.ed25519_verify_cuda(A, R, S, h)
    ok_p = ted.verify_arrays_reference(A, R, S, h)
    torch.cuda.synchronize()
    check(torch.equal(ok_k.bool(), ok_p), "verify kernel != plain at N=65536")
    p2_ms = idle_stream_ms(lambda: tsha.challenge_words_reference(R, A, M),
                           reps=3)
    p1_ms = idle_stream_ms(lambda: ted.verify_arrays_reference(A, R, S, h),
                           reps=2)

    e2e_ms = host_ms(lambda: verifier.verify_batch(jobs), reps=3)
    idle = 1 - (k1_ms + k2_ms) / e2e_ms
    log(f"{card} | timings at N={N_MAIN}: pack native {pack_ms:.3f} ms / "
        f"numpy {pack_numpy_ms:.3f} ms; challenge kernel {k2_ms:.4f} ms "
        f"(wrapper {k2_host_us:.1f} us/call on the host, plain "
        f"{p2_ms:.1f} ms); verify kernel {k1_ms:.4f} ms (wrapper "
        f"{k1_host_us:.1f} us/call, plain {p1_ms:.1f} ms); end to end "
        f"{e2e_ms:.1f} ms = {N_MAIN / (e2e_ms / 1e3):.0f} sigs/s, device "
        f"idle {idle:.3f}")
    return {
        "launches": launches, "pack_backend": native.pack_backend(),
        "pack_ms": pack_ms, "pack_numpy_ms": pack_numpy_ms,
        "k1_ms": k1_ms, "k2_ms": k2_ms,
        "k1_wrapper_host_us": k1_host_us, "k2_wrapper_host_us": k2_host_us,
        "p1_ms": p1_ms, "p2_ms": p2_ms, "e2e_ms": e2e_ms,
        "e2e_sigs_s": N_MAIN / (e2e_ms / 1e3), "device_idle_share": idle,
        "verify_least_int_ops": least_ops,
        "verify_least_per_sig": least_per_sig,
        "max_err": {
            "ed25519_verify": int((ok_k.long() - ok_p.long()).abs().max()),
            "sha512_challenge": int((h.long() - h_p.long()).abs().max())},
    }, jobs, want, tuples, expect


# 1 .. 4,096: the sweep that sets DEVICE_MIN_SIGS_DEFAULT (crypto/provider.py)
# reaches down to a single signature.
CROSSOVER_SIZES = (1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4096)
# Under _cverify.c's PAR_MIN (64) verify_many runs on one thread.
ONE_THREAD_SIGS = 32


def libcrypto_version(native) -> str:
    """OpenSSL_version(OPENSSL_VERSION) of the libcrypto the core links."""
    lib = ctypes.CDLL(native._libcrypto_path())
    lib.OpenSSL_version.restype = ctypes.c_char_p
    lib.OpenSSL_version.argtypes = [ctypes.c_int]
    return lib.OpenSSL_version(0).decode()


def host_tier_split(provider, native, fast_ed25519, tuples) -> dict:
    """Where the host tier's time goes for one signature, host-clock
    medians of 21 (each run ends in torch.cuda.synchronize, as host_ms
    does): the timer alone, one native verify_many call, libcrypto's cost
    per signature on one thread, the OpenSSL path through
    ``cryptography`` for one signature, and CpuVerifier whole."""
    core = native.load_cverify()
    one = [tuples[0]]
    cols1 = [[t[k] for t in one] for k in range(3)]
    many = [tuples[i % N_DISTINCT] for i in range(ONE_THREAD_SIGS)]
    cols = [[t[k] for t in many] for k in range(3)]
    jobs1 = [provider.VerifyJob(*one[0])]
    cpu = provider.CpuVerifier()
    return {
        "timer_ms": host_ms(lambda: None, reps=21),
        "native_1_ms": host_ms(lambda: core.verify_many(*cols1), reps=21),
        "native_per_sig_1_thread_ms": host_ms(
            lambda: core.verify_many(*cols), reps=21) / ONE_THREAD_SIGS,
        "cryptography_1_ms": (host_ms(
            lambda: fast_ed25519.verify(*one[0]), reps=21)
            if fast_ed25519.available() else None),
        "cpu_verifier_1_ms": host_ms(lambda: cpu.verify_batch(jobs1), reps=21),
        "libcrypto": libcrypto_version(native),
    }


def phase_crossover(provider, native, fast_ed25519, kernels, tuples, card):
    """Phase 6 (c): all-valid tx-id batches through the host tier and the
    card (device_min_sigs=0), medians on the host clock; the smallest size
    at which the card wins, beside the provider's default; then where the
    host tier's time goes for one signature."""
    cpu = provider.CpuVerifier()
    card_v = provider.TorchVerifier(device="cuda", device_min_sigs=0)
    rows = []
    for n in CROSSOVER_SIZES:
        jobs = [provider.VerifyJob(*tuples[i % N_DISTINCT]) for i in range(n)]
        kernels.reset_launches()
        check(card_v.verify_batch(jobs).all() and cpu.verify_batch(jobs).all(),
              f"crossover batch of {n} != oracle (all valid)")
        check(min(kernels.LAUNCHES[k] for k in VERIFY_KERNELS) > 0,
              f"the card's batch of {n} did not launch both kernels")
        cpu_ms = host_ms(lambda: cpu.verify_batch(jobs), reps=5)
        card_ms = host_ms(lambda: card_v.verify_batch(jobs), reps=5)
        rows.append({"n": n, "cpu_ms": cpu_ms, "card_ms": card_ms})
    wins = [r["n"] for r in rows if r["card_ms"] < r["cpu_ms"]]
    crossover = wins[0] if wins else None
    log(f"{card} | crossover (host clock, medians of 5): " + "; ".join(
        f"{r['n']}: host {r['cpu_ms']:.3f} ms / card {r['card_ms']:.3f} ms"
        for r in rows) + f" -> the card wins from {crossover} "
        f"(DEVICE_MIN_SIGS_DEFAULT {provider.DEVICE_MIN_SIGS_DEFAULT})")
    split = host_tier_split(provider, native, fast_ed25519, tuples)
    log(f"{card} | host tier for 1 signature (host clock, medians of 21): "
        f"CpuVerifier {split['cpu_verifier_1_ms']:.3f} ms = timer "
        f"{split['timer_ms']:.3f} ms + native verify_many "
        f"{split['native_1_ms'] - split['timer_ms']:.3f} ms + Python "
        f"{split['cpu_verifier_1_ms'] - split['native_1_ms']:.3f} ms; "
        f"libcrypto on one thread "
        f"{split['native_per_sig_1_thread_ms']:.3f} ms a signature "
        f"(verify_many of {ONE_THREAD_SIGS}); through cryptography "
        + (f"{split['cryptography_1_ms']:.3f} ms"
           if split["cryptography_1_ms"] is not None else "not installed")
        + f"; {split['libcrypto']}")
    return {"rows": rows, "crossover": crossover, "card_wins_at": wins,
            "default": provider.DEVICE_MIN_SIGS_DEFAULT,
            "host_tier_1_sig": split}


STREAM_BATCHES = 8


def phase_stream(ted, kernels, tuples, expect, main_res, card):
    """Phase 7 (d): verify_stream at depth 2 over 8 batches of N_MAIN
    against 8 sequential verify_batch calls on the same batches, in turns
    (stream, sequential, sequential, stream); every answer held to the
    oracle."""
    rng = np.random.default_rng(SEED + 2)
    n_tamper = int(N_MAIN * TAMPER_FRACTION)
    batches, wants = [], []
    for _ in range(STREAM_BATCHES):
        idx = np.arange(N_MAIN) % N_DISTINCT
        pos = rng.choice(N_MAIN, n_tamper, replace=False)
        idx[pos] = N_DISTINCT + rng.integers(0, len(tuples) - N_DISTINCT,
                                             n_tamper)
        batches.append(tuple([tuples[i][k] for i in idx] for k in range(3)))
        wants.append(np.array([expect[i] for i in idx], bool))
    total = STREAM_BATCHES * N_MAIN

    def stream():
        return list(ted.verify_stream(batches, device="cuda", depth=2))

    def sequential():
        return [ted.verify_batch(*b, device="cuda") for b in batches]

    walls = {"stream": [], "sequential": []}
    launches = None
    for turn, name in enumerate(("stream", "sequential", "sequential",
                                 "stream")):
        fn = stream if name == "stream" else sequential
        if turn == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        outs = fn()
        walls[name].append((time.perf_counter() - t0) * 1e3)
        if turn == 0:
            launches = {k: kernels.LAUNCHES[k] for k in VERIFY_KERNELS}
        check(len(outs) == STREAM_BATCHES and all(
            np.array_equal(o, w) for o, w in zip(outs, wants)),
            f"{name} answers != oracle")
    check(launches == {"ed25519_verify": STREAM_BATCHES,
                       "sha512_challenge": STREAM_BATCHES},
          f"the stream did not launch each kernel once a batch: {launches}")
    busy = main_res["k1_ms"] * launches["ed25519_verify"] \
        + main_res["k2_ms"] * launches["sha512_challenge"]
    rate = {k: [total / (w / 1e3) for w in v] for k, v in walls.items()}
    idle = [1 - busy / w for w in walls["stream"]]
    log(f"{card} | stream: {STREAM_BATCHES} x {N_MAIN} sigs match the oracle; "
        f"verify_stream depth 2 {rate['stream'][0]:.0f} / "
        f"{rate['stream'][1]:.0f} sigs/s against sequential verify_batch "
        f"{rate['sequential'][0]:.0f} / {rate['sequential'][1]:.0f} sigs/s; "
        f"device idle {idle[0]:.3f} / {idle[1]:.3f} of the stream's wall; "
        f"launches {launches}")
    return {"wall_ms": walls, "sigs_s": rate, "device_idle_share": idle,
            "launches": launches}


def sidecar_address() -> tuple[str, str | None]:
    tmp = tempfile.mkdtemp(prefix="cts")
    path = os.path.join(tmp, "sidecar.sock")
    if len(path) < 100:
        return path, tmp
    return "127.0.0.1:0", tmp  # socket path too long: use localhost TCP


def request_tier(sidecar, address, jobs, req_id):
    """One OP_VERIFY round trip -> (reply tier, answers)."""
    sock = sidecar.connect(address, timeout=120.0)
    try:
        sidecar.send_frame(sock, sidecar.encode_verify_request(req_id, jobs))
        reply = sidecar.recv_frame(sock)
    finally:
        sock.close()
    _op, rid, status, tier, _w, _v = sidecar._VERIFY_REPLY_HDR.unpack_from(
        reply)
    check(rid == req_id and status == sidecar.STATUS_OK,
          f"sidecar request {req_id}: status {status}")
    body = reply[sidecar._VERIFY_REPLY_HDR.size:]
    return tier, np.frombuffer(body, np.uint8).astype(bool)


def phase_sidecar(provider, sidecar, kernels, jobs, want):
    """Phase 8: three clients through one SidecarServer on the card, then
    (e) one small request alone, which the host tier answers."""
    n_small = provider.DEVICE_MIN_SIGS_DEFAULT - 1
    check(n_small >= 1, "DEVICE_MIN_SIGS_DEFAULT routes no batch to the host")
    address, tmp = sidecar_address()
    server = sidecar.SidecarServer(address, device="cuda", coalesce_us=20000,
                                   max_sigs=4096)
    server.start()
    kernels.reset_launches()
    errors: list[str] = []
    per_req = 2048
    reqs_per_client = 4
    barrier = threading.Barrier(3)

    def client(c: int) -> None:
        try:
            sock = sidecar.connect(server.address, timeout=120.0)
            try:
                barrier.wait()
                for k in range(reqs_per_client):
                    lo = (c * reqs_per_client + k) * per_req
                    idx = [(lo + t) % len(jobs) for t in range(per_req)]
                    req = [jobs[t] for t in idx]
                    exp = want[idx]
                    if c == 0 and k == 1:  # a tampered job
                        j = req[7]
                        req[7] = provider.VerifyJob(
                            j.pubkey, j.message,
                            j.sig[:33] + bytes([j.sig[33] ^ 4]) + j.sig[34:])
                        exp[7] = False
                    if c == 1 and k == 2:  # a malformed job: 31-byte key
                        j = req[9]
                        req[9] = provider.VerifyJob(j.pubkey[:31], j.message,
                                                    j.sig)
                        exp[9] = False
                    got = sidecar.verify_remote(server.address, req,
                                                sock=sock, req_id=k + 1)
                    if not np.array_equal(got, exp):
                        errors.append(f"client {c} request {k}: "
                                      f"{int((got != exp).sum())} lanes wrong")
            finally:
                sock.close()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(f"client {c}: {exc!r}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = {k: kernels.LAUNCHES[k] for k in VERIFY_KERNELS}
        # (e) one request alone, under the crossover: the host tier.
        small_tier, small_got = request_tier(sidecar, server.address,
                                             jobs[:n_small], 77)
        stats = sidecar.fetch_stats(server.address)
        qos = sidecar.connect(server.address, timeout=30.0)
        try:
            sidecar.send_frame(qos, sidecar._VERIFY_REQ_HDR.pack(
                sidecar.OP_VERIFY_QOS, 99, 0))
            reply = sidecar.recv_frame(qos)
        finally:
            qos.close()
    finally:
        server.stop()
        if tmp:
            try:
                os.rmdir(tmp)
            except OSError:
                pass
    check(not errors, "; ".join(errors))
    check(not any(t.is_alive() for t in threads), "sidecar client hung")
    check(sidecar._VERIFY_REPLY_HDR.unpack_from(reply)[2] == sidecar.STATUS_ERR,
          "OP_VERIFY_QOS did not get STATUS_ERR")
    check(np.array_equal(small_got, want[:n_small]),
          f"the {n_small}-signature request != oracle")
    check(small_tier == 0 and stats["host_batches"] >= 1,
          f"the {n_small}-signature request was not host-routed: tier "
          f"{small_tier}, stats {stats}")
    check(stats["requests"] == 3 * reqs_per_client + 1, f"stats: {stats}")
    check(stats["device_batches"] and stats["cross_request_batches"] > 0,
          f"no merged device batches: {stats}")
    check(stats["kernel_backend"] == "cuda", f"stats: {stats}")
    check(launches["ed25519_verify"] > 0 and launches["sha512_challenge"] > 0,
          f"sidecar did not launch both kernels: {launches}")
    log(f"sidecar: {3 * reqs_per_client} requests from 3 clients match the "
        f"oracle; batches {stats['batches']} (merged "
        f"{stats['cross_request_batches']}), hist {stats['batch_sigs_hist']}, "
        f"pad_lanes {stats['pad_lanes']}, launches {launches}; one "
        f"{n_small}-signature request answered by the host tier (tier "
        f"{small_tier}, host_batches {stats['host_batches']}, "
        f"device_min_sigs {stats['device_min_sigs']})")
    return stats, launches


def phase_degrade(provider, kernels, jobs, want):
    """Phase 9 (f): degrade a card verifier; a batch of 1,024, above the
    crossover, takes the host tier and matches the oracle; the re-probe
    reopens the gate through the kernels; the next batch is a device
    batch."""
    v = provider.TorchVerifier(device="cuda")
    n = 1024
    check(n >= v.device_min_sigs, "the degrade batch is under the crossover")
    batch, batch_want = jobs[:n], want[:n]
    kernels.reset_launches()
    check(provider.degrade_device(v, cooldown_s=0.2), "degrade_device refused")
    got = v.verify_batch(batch)
    check((v.host_batches, v.device_batches) == (1, 0),
          "a batch above the crossover did not take the host tier while "
          "degraded")
    check(np.array_equal(got, batch_want), "degraded host answers != oracle")
    deadline = time.monotonic() + 60
    while not v.device_gate.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    torch.cuda.synchronize()
    probe_launches = {k: kernels.LAUNCHES[k] for k in VERIFY_KERNELS}
    check(v.device_gate.is_set() and v.reprobes_ok == 1
          and v.reprobes_failed == 0,
          f"the re-probe did not reopen the gate (ok {v.reprobes_ok}, "
          f"failed {v.reprobes_failed})")
    check(min(probe_launches.values()) > 0,
          f"the re-probe did not run the kernels: {probe_launches}")
    got = v.verify_batch(batch)
    check((v.host_batches, v.device_batches) == (1, 1)
          and np.array_equal(got, batch_want),
          "after the re-probe the batch was not a device batch = oracle")
    log(f"degrade: {n} sigs on the host tier while degraded (= oracle); the "
        f"re-probe reopened the gate through the kernels ({probe_launches}); "
        f"the next batch ran on the card (= oracle)")
    return {"n": n, "probe_launches": probe_launches}


# --- the resolve path: SHA-256 kernels, the transaction wave, crossover -----

# The padding boundaries, the wave's leaf sizes (a 166-byte command leaf,
# 317-318-byte output leaves), a many-block message and 1 MB.
SHA_EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120, 166, 317, 318, 1000)
SHA_MEGABYTE = 1 << 20
N_RAGGED = 1000
# bench.py's bench_resolve_ids wave (2,048 transactions) scaled to 8,192:
# DummyContract.generate_initial plus 7 more DummySingleOwnerState outputs
# and one signature a transaction, so 9 leaves a transaction.
N_WAVE = 8192
OUTPUTS_PER_TX = 8
HASH_CROSSOVER_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                        65536, 131072)
NEVER = 1 << 62  # a device_min no batch reaches: hash_many_auto's host route


def flat_tensors(tsha256, msgs, dev):
    data, offsets = tsha256.pack_flat(msgs)
    return (torch.from_numpy(data.copy()).to(dev),
            torch.from_numpy(offsets).to(dev))


def max_err_of(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def leaf_level(leaf_groups, dev) -> torch.Tensor:
    """Equal-length groups of 32-byte digests -> (8, m, leaves) int32."""
    m, n = len(leaf_groups), len(leaf_groups[0])
    raw = b"".join(b"".join(g) for g in leaf_groups)
    words = np.frombuffer(raw, ">u4").astype(np.uint32).reshape(
        m, n, 8).transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)


def root_depth(width: int, most: int) -> int:
    """The depth of merkle_roots' next launch on ``width`` nodes."""
    return min(most, (width - 1).bit_length())


def reduce_roots(reduce_fn, level, most: int):
    """merkle_roots' loop: ``reduce_fn(level, depth)`` until one node."""
    while level.shape[2] > 1:
        level = reduce_fn(level, root_depth(level.shape[2], most))
    return level


def plain_reduce(tsha256, level, depth):
    for _ in range(depth):
        level = tsha256.merkle_level_reference(level)
    return level


def aligned_messages(rng):
    """The edge lengths at every start offset mod 16: before each message a
    spacer message brings the next start to the wanted residue."""
    msgs, pos = [], 0
    for n in SHA_EDGES:
        for r in range(16):
            spacer = rng.bytes((r - pos) % 16)
            msgs += [spacer, rng.bytes(n)]
            pos += len(spacer) + n
    return msgs


def phase_sha256_kernels(tsha256, kernels, dev, rng):
    """Phase 10 (a): both SHA-256 kernels against their plain versions on
    the card and against hashlib, tolerance 0 (digests are bits).
    sha256_many: the edge lengths at every start offset mod 16, in a buffer
    that starts at 0 and at 3 mod 16 and ends at its last message's last
    byte with 0xff bytes behind it; a seeded ragged N = 1,000 (not a
    multiple of the CTA's 64); N = 1; a 1 MB message beside short ones
    (against hashlib only: the plain version would take minutes). The pair
    kernel: one level of (8, 1,024) pairs against hashlib; trees of width
    1-40 and 1,000 reduced as merkle_roots reduces them, each launch
    against the plain level looped; merkle_roots on those widths against
    MerkleTree.build."""
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.crypto.merkle import MerkleTree

    max_err = {"sha256_many": 0, "sha256_pair": 0}
    edges = aligned_messages(rng)
    ragged = [rng.bytes(int(k)) for k in rng.integers(0, 1200, N_RAGGED)]
    cases = [("edges at 0 mod 16", edges, 0), ("edges at 3 mod 16", edges, 3),
             ("ragged batch", ragged, 0), ("N = 1", [rng.bytes(317)], 5)]
    for name, msgs, lead in cases:
        flat, offsets = tsha256.pack_flat(msgs)
        room = torch.full((flat.size + 64,), 0xFF, dtype=torch.uint8,
                          device=dev)
        start = (lead - room.data_ptr()) % 16
        data = room[start:start + flat.size]
        data.copy_(torch.from_numpy(flat.copy()))
        check(data.data_ptr() % 16 == lead, f"{name}: view misaligned")
        offsets = torch.from_numpy(offsets).to(dev)
        k = kernels.sha256_many_cuda(data, offsets)
        p = tsha256.sha256_flat_reference(data, offsets)
        torch.cuda.synchronize()
        max_err["sha256_many"] = max(max_err["sha256_many"], max_err_of(k, p))
        check(torch.equal(k, p), f"sha256_many kernel != plain on the {name}")
        check(tsha256.digests_of(k) == [hashlib.sha256(m).digest()
                                        for m in msgs],
              f"sha256_many kernel != hashlib on the {name}")
    big = [rng.bytes(3), rng.bytes(SHA_MEGABYTE), rng.bytes(166)]
    k = kernels.sha256_many_cuda(*flat_tensors(tsha256, big, dev))
    check(tsha256.digests_of(k) == [hashlib.sha256(m).digest() for m in big],
          "sha256_many kernel != hashlib on a 1 MB message")

    pairs = torch.from_numpy(rng.integers(
        0, 2**32, (8, 1024, 2), dtype=np.uint64).astype(np.uint32).view(
        np.int32)).to(dev)
    k = kernels.merkle_reduce_cuda(pairs, 1)[:, :, 0]
    p = tsha256.sha256_pair_words_reference(pairs[:, :, 0].contiguous(),
                                            pairs[:, :, 1].contiguous())
    torch.cuda.synchronize()
    max_err["sha256_pair"] = max_err_of(k, p)
    check(torch.equal(k, p), "sha256_pair kernel != plain on 1,024 pairs")
    host = pairs.cpu().numpy().view(np.uint32)
    check(tsha256.digests_of(k) == [hashlib.sha256(
        host[:, i, 0].astype(">u4").tobytes()
        + host[:, i, 1].astype(">u4").tobytes()).digest()
        for i in range(1024)], "sha256_pair kernel != hashlib")
    most = kernels.MERKLE_DEPTH
    widths = list(range(1, 41)) + [1000]
    for width in widths:
        level = torch.from_numpy(rng.integers(
            0, 2**32, (8, 8, width), dtype=np.uint64).astype(np.uint32).view(
            np.int32)).to(dev)
        while level.shape[2] > 1:
            depth = root_depth(level.shape[2], most)
            k = kernels.merkle_reduce_cuda(level, depth)
            p = plain_reduce(tsha256, level, depth)
            torch.cuda.synchronize()
            max_err["sha256_pair"] = max(max_err["sha256_pair"],
                                         max_err_of(k, p))
            check(torch.equal(k, p), f"sha256_pair kernel != plain at width "
                                     f"{level.shape[2]}, depth {depth}")
            level = k
    groups = [[rng.bytes(32) for _ in range(n)] for n in widths]
    check(tsha256.merkle_roots(groups, device="cuda") == [
        MerkleTree.build([SecureHash(h) for h in g]).hash.bytes
        for g in groups], "merkle_roots on the card != MerkleTree.build")
    log(f"sha256 kernels vs plain on the card (tolerance 0): sha256_many on "
        f"{len(edges)} messages starting at every offset mod 16 (buffers at "
        f"0 and 3 mod 16), {N_RAGGED} ragged messages and N = 1, identical "
        f"and = hashlib, a 1 MB message = hashlib; sha256_pair on 1,024 "
        f"pairs (= hashlib) and trees of width 1-40 and 1,000 launch by "
        f"launch; merkle_roots on those widths = MerkleTree.build")
    return max_err


def build_wave(rng):
    """The resolve wave, built in the port from ``rng``: N_WAVE serialized
    SignedTransactions, the build-time ids, and the indices whose one
    signature has a flipped byte (TAMPER_FRACTION of them; ids intact)."""
    from corda_tpu_torch.crypto.keys import DigitalSignature, KeyPair
    from corda_tpu_torch.crypto.party import Party
    from corda_tpu_torch.serialization.codec import serialize
    from corda_tpu_torch.testing.dummies import (DummyContract,
                                                 DummySingleOwnerState)

    key = KeyPair.generate(rng.bytes(32))
    notary = Party.of("Notary", KeyPair.generate(rng.bytes(32)).public)
    party = Party.of("Party", key.public)
    tampered = set(rng.choice(N_WAVE, int(N_WAVE * TAMPER_FRACTION),
                              replace=False).tolist())
    blobs, ids = [], []
    for i in range(N_WAVE):
        b = DummyContract.generate_initial(
            party.ref(i.to_bytes(4, "big")), i, notary)
        for j in range(OUTPUTS_PER_TX - 1):
            b.add_output_state(DummySingleOwnerState(
                i * 1000 + j, party.owning_key))
        stx = b.sign_with(key).to_signed_transaction()
        if i in tampered:
            sig = stx.sigs[0].bytes
            stx = dataclasses.replace(stx, sigs=(DigitalSignature.WithKey(
                bytes=sig[:9] + bytes([sig[9] ^ 0x04]) + sig[10:],
                by=stx.sigs[0].by),))
        blobs.append(serialize(stx).bytes)
        ids.append(stx.id.bytes)
    return blobs, ids, tampered


def wave_jobs(provider, stxs):
    """Every signature of the wave, formed as the node's verify batch forms
    them (corda_tpu/node/statemachine.py:1355-1378), and each
    transaction's [lo, hi) span in the list."""
    jobs, spans = [], []
    for s in stxs:
        spans.append((len(jobs), len(jobs) + len(s.sigs)))
        jobs.extend(provider.VerifyJob(sig.by.encoded, s.id.bytes, sig.bytes)
                    for sig in s.sigs)
    return jobs, spans


def tx_accepts(ok, spans) -> list[bool]:
    return [bool(ok[lo:hi].all()) for lo, hi in spans]


def resolve_split(provider, tsha256, blobs, ids, want, device_min,
                  verifier) -> dict:
    """One resolve pass over fresh deserializations, prime_ids' steps timed
    one by one on the host clock: deserialize (the SignedTransaction and its
    WireTransaction), component serialize, hash (hash_many_auto), tree plus
    compare, then verify (every signature in one verify_batch)."""
    from corda_tpu_torch.serialization.codec import deserialize
    from corda_tpu_torch.transactions import signed

    t = [time.perf_counter()]
    stxs = [deserialize(b) for b in blobs]
    wtxs = [s.tx_bits.deserialize() for s in stxs]
    t.append(time.perf_counter())
    flat, spans = signed.component_blobs(wtxs)
    t.append(time.perf_counter())
    digests, backend = tsha256.hash_many_auto(flat, device_min=device_min,
                                              device="cuda")
    t.append(time.perf_counter())
    signed.seed_and_check_ids(stxs, wtxs, spans, digests)
    t.append(time.perf_counter())
    jobs, job_spans = wave_jobs(provider, stxs)
    ok = verifier.verify_batch(jobs)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    check([s.tx.id.bytes for s in stxs] == ids, "split pass: ids differ")
    check(tx_accepts(ok, job_spans) == want, "split pass: accepts differ")
    ms = {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(
        ("deserialize", "component_serialize", "hash", "tree_and_compare",
         "verify"))}
    total = sum(ms.values())
    return {"backend": backend, "ms": ms, "total_ms": total,
            "tx_s": len(blobs) / (total / 1e3),
            "leaves_s": len(flat) / (total / 1e3)}


def phase_resolve(provider, tsha256, kernels, dev, rng, card):
    """Phase 11 (b): the resolve wave at full size through the entry points
    (prime_ids, merkle_roots, TorchVerifier.verify_batch), on the host and
    on the card; the tampered id; the time split; kernel times at the
    wave's shapes."""
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.crypto.merkle import MerkleTree
    from corda_tpu_torch.serialization.codec import deserialize, serialize
    from corda_tpu_torch.transactions.signed import SignedTransaction

    t0 = time.perf_counter()
    blobs, ids, tampered = build_wave(rng)
    build_s = time.perf_counter() - t0
    want = [i not in tampered for i in range(N_WAVE)]
    card_v = provider.TorchVerifier(device="cuda")
    card_v.warm()

    # Host: fresh copies, hash_many_auto's host route.
    host_batch = [deserialize(b) for b in blobs]
    t0 = time.perf_counter()
    backend = SignedTransaction.prime_ids(host_batch, device_min=NEVER,
                                          device="cuda")
    host_prime_ms = (time.perf_counter() - t0) * 1e3
    check(backend == "host" and [s.tx.id.bytes for s in host_batch] == ids,
          "host prime_ids != build-time ids")

    # The card: the main path of this phase, counted from 0.
    batch = [deserialize(b) for b in blobs]
    kernels.reset_launches()
    t0 = time.perf_counter()
    backend = SignedTransaction.prime_ids(batch, device_min=0, device="cuda")
    t1 = time.perf_counter()
    leaves = [[h.bytes for h in s.tx.all_leaves_hashes] for s in batch]
    roots = tsha256.merkle_roots(leaves, device="cuda")
    t2 = time.perf_counter()
    jobs, job_spans = wave_jobs(provider, batch)
    ok = card_v.verify_batch(jobs)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    n_leaves = sum(len(g) for g in leaves)
    check(backend == "device", f"card prime_ids took the {backend} route")
    check([s.tx.id.bytes for s in batch] == ids,
          "card prime_ids != build-time ids")
    check(roots == ids, "merkle_roots on the card != build-time ids")
    accepts = tx_accepts(ok, job_spans)
    check(accepts == want,
          f"verify_batch rejected {[i for i, a in enumerate(accepts) if not a]}"
          f" but the tampered transactions are {sorted(tampered)}")
    check(launches["sha256_many"] == 1 and launches["sha256_pair"] == 1
          and min(launches[k] for k in VERIFY_KERNELS) > 0
          and card_v.device_batches >= 1,
          f"the resolve wave did not launch every kernel: {launches}")
    log(f"resolve wave: {N_WAVE} transactions ({n_leaves} leaves, built in "
        f"{build_s:.1f} s): host and card prime_ids and merkle_roots on the "
        f"card = build-time ids; verify_batch rejects exactly the "
        f"{len(tampered)} tampered; launches {launches}")

    # A tampered id: one blob whose id is another transaction's.
    small = [deserialize(b) for b in blobs[:3]]
    bad = [serialize(s).bytes for s in
           (small[2], dataclasses.replace(small[0], id=small[1].id))]
    try:
        SignedTransaction.prime_ids([deserialize(b) for b in bad],
                                    device_min=0, device="cuda")
        fail("a swapped id was accepted by prime_ids on the card")
    except ValueError as e:
        check("does not match" in str(e), f"wrong error for a swapped id: {e}")
    log("tampered id: prime_ids on the card raised the 'does not match' "
        "ValueError")

    # The time split over fresh copies, in turns (card, host, host, card),
    # with the earlier waves freed so each pass finds the same heap.
    from corda_tpu_torch.transactions import signed

    flat, _ = signed.component_blobs([s.tx for s in batch])
    packed = card_v._pack(jobs)
    del batch, host_batch, small
    split = {"card": [], "host": []}
    for where in ("card", "host", "host", "card"):
        gc.collect()
        split[where].append(resolve_split(
            provider, tsha256, blobs, ids, want,
            0 if where == "card" else NEVER,
            card_v if where == "card" else provider.CpuVerifier()))
    check(all(sp["backend"] == "device" for sp in split["card"])
          and all(sp["backend"] == "host" for sp in split["host"]),
          "split routes differ")
    for where in ("host", "card"):
        for sp in split[where]:
            log(f"{card} | resolve {where}: {sp['tx_s']:.0f} tx/s, "
                f"{sp['leaves_s']:.0f} leaves/s; ms: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in sp["ms"].items())
                + f" (total {sp['total_ms']:.1f})")

    # The card route's hash step split into its parts, host clock, each
    # part synchronised, medians of 5: pack_flat, the copy in, the kernel,
    # the copy out and digests_of.
    hash_split = hash_step_split(tsha256, kernels, flat, dev)

    # Kernel times at the wave's shapes.
    data, offsets = flat_tensors(tsha256, flat, dev)
    lengths = np.diff(offsets.cpu().numpy())
    blocks = int(((lengths + 8) // 64 + 1).sum())
    k_many = kernels.sha256_many_cuda(data, offsets)
    p_many = tsha256.sha256_flat_reference(data, offsets)
    torch.cuda.synchronize()
    check(torch.equal(k_many, p_many), "sha256_many kernel != plain on the wave")
    many = {"ms": kernel_ms(lambda: kernels.sha256_many_cuda(data, offsets)),
            "wrapper_host_us": wrapper_host_us(
                lambda: kernels.sha256_many_cuda(data, offsets), calls=100),
            "plain_ms": idle_stream_ms(
                lambda: tsha256.sha256_flat_reference(data, offsets), reps=2),
            "hashlib_ms": host_ms(lambda: [hashlib.sha256(m).digest()
                                           for m in flat], reps=3),
            "max_err": max_err_of(k_many, p_many), "blocks": blocks,
            "messages": len(flat),
            "bytes": int(data.numel()) + 8 * (len(flat) + 1) + 32 * len(flat),
            "launches": launches["sha256_many"], "hash_split": hash_split}
    level0 = leaf_level(leaves, dev)
    most = kernels.MERKLE_DEPTH

    def card_roots():
        return reduce_roots(kernels.merkle_reduce_cuda, level0, most)

    k_root = card_roots()
    p_root = reduce_roots(lambda lv, d: plain_reduce(tsha256, lv, d), level0,
                          most)
    torch.cuda.synchronize()
    check(torch.equal(k_root, p_root), "sha256_pair kernel != plain on the wave")
    # The bound's work: every node of the wave's trees (the same whatever
    # reduces them); its bytes: the leaves read once, the roots written once.
    nodes, width = 0, level0.shape[2]
    while width > 1:
        width = (width + 1) // 2
        nodes += N_WAVE * width
    pair = {"ms": kernel_ms(card_roots),
            "wrapper_host_us": wrapper_host_us(
                lambda: kernels.merkle_reduce_cuda(
                    level0, root_depth(level0.shape[2], most)), calls=100),
            "plain_ms": idle_stream_ms(lambda: reduce_roots(
                lambda lv, d: plain_reduce(tsha256, lv, d), level0, most),
                reps=2),
            "hashlib_ms": host_ms(lambda: [MerkleTree.build(
                [SecureHash(h) for h in g]).hash for g in leaves], reps=3),
            "max_err": max_err_of(k_root, p_root), "nodes": nodes,
            "bytes": 32 * (int(level0.shape[1] * level0.shape[2]) + N_WAVE),
            "launches": launches["sha256_pair"]}
    # Both verify kernels on the wave's 8,192 signatures, as verify_batch
    # packed them.
    verify_ms = kernel_ms(lambda: packed.verify_fn(*packed.tensors))
    e2e_card_ms = (t3 - t0) * 1e3
    busy = many["ms"] + pair["ms"] + verify_ms
    log(f"{card} | resolve kernels at the wave's shapes: sha256_many "
        f"{many['ms']:.4f} ms for {len(flat)} messages / {blocks} blocks "
        f"(wrapper {many['wrapper_host_us']:.1f} us/call, plain "
        f"{many['plain_ms']:.1f} ms, hashlib on the host "
        f"{many['hashlib_ms']:.1f} ms); sha256_pair {pair['ms']:.4f} ms for "
        f"the wave's {launches['sha256_pair']} launch(es), {nodes} nodes "
        f"(wrapper {pair['wrapper_host_us']:.1f} us/call, plain "
        f"{pair['plain_ms']:.1f} ms, host trees {pair['hashlib_ms']:.1f} ms);"
        f" challenge + verify kernels on the wave's signatures "
        f"{verify_ms:.4f} ms; card path prime_ids {(t1 - t0) * 1e3:.1f} ms +"
        f" merkle_roots {(t2 - t1) * 1e3:.1f} ms + verify "
        f"{(t3 - t2) * 1e3:.1f} ms, host prime_ids {host_prime_ms:.1f} ms; "
        f"the kernels are busy {busy / e2e_card_ms:.3e} of the card path's "
        f"wall (device idle {1 - busy / e2e_card_ms:.6f})")
    log(f"{card} | the card route's hash step (host clock, medians of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in hash_split.items()))
    return {"build_s": build_s, "n_tx": N_WAVE, "leaves": n_leaves,
            "tampered": len(tampered), "launches": launches,
            "host_prime_ids_ms": host_prime_ms,
            "card_prime_ids_ms": (t1 - t0) * 1e3,
            "card_merkle_roots_ms": (t2 - t1) * 1e3,
            "card_verify_ms": (t3 - t2) * 1e3, "split": split,
            "verify_kernels_ms": verify_ms,
            "device_idle_share": 1 - busy / e2e_card_ms,
            "sha256_many": many, "sha256_pair": pair}, flat


def hash_step_split(tsha256, kernels, flat, dev) -> dict:
    """hash_many_auto's card route over the wave's leaf messages, step by
    step on the host clock (each step synchronised), medians of 5; the
    whole call beside the sum of its steps."""
    data, offsets = tsha256.pack_flat(flat)
    d_dev = torch.from_numpy(data.copy()).to(dev)
    o_dev = torch.from_numpy(offsets).to(dev)
    words = kernels.sha256_many_cuda(d_dev, o_dev)
    host_words = words.cpu()
    out = {"pack_flat": host_ms(lambda: tsha256.pack_flat(flat)),
           "copy_in": host_ms(lambda: (torch.from_numpy(data.copy()).to(dev),
                                       torch.from_numpy(offsets).to(dev))),
           "kernel": host_ms(lambda: kernels.sha256_many_cuda(d_dev, o_dev)),
           "copy_out": host_ms(lambda: words.cpu()),
           "digests_of": host_ms(lambda: tsha256.digests_of(host_words))}
    out["sum"] = sum(out.values())
    out["hash_many_auto"] = host_ms(lambda: tsha256.hash_many_auto(
        flat, device_min=0, device="cuda"))
    return out


def phase_hash_crossover(tsha256, flat, card):
    """Phase 12 (c): hash_many_auto on the host against the card over the
    wave's leaf messages (tiled), 256 ... 131,072, host-clock medians of
    5; the smallest size from which the card wins at every larger size,
    beside DEVICE_MIN_HASHES_DEFAULT."""
    top = HASH_CROSSOVER_SIZES[-1]
    msgs = (flat * (-(-top // len(flat))))[:top]
    rows = []
    for n in HASH_CROSSOVER_SIZES:
        sub = msgs[:n]
        host_d, hb = tsha256.hash_many_auto(sub, device_min=n + 1,
                                            device="cuda")
        card_d, cb = tsha256.hash_many_auto(sub, device_min=n, device="cuda")
        check((hb, cb) == ("host", "device") and host_d == card_d,
              f"hash_many_auto routes disagree at {n}")
        rows.append({"n": n, "host_ms": host_ms(
            lambda: tsha256.hash_many_auto(sub, device_min=n + 1,
                                           device="cuda")),
            "card_ms": host_ms(lambda: tsha256.hash_many_auto(
                sub, device_min=n, device="cuda"))})
    crossover = None
    for r in reversed(rows):
        if r["card_ms"] >= r["host_ms"]:
            break
        crossover = r["n"]
    log(f"{card} | hashing crossover (host clock, medians of 5): " + "; ".join(
        f"{r['n']}: host {r['host_ms']:.3f} ms / card {r['card_ms']:.3f} ms"
        for r in rows) + f" -> the card wins from {crossover} on "
        f"(DEVICE_MIN_HASHES_DEFAULT {tsha256.DEVICE_MIN_HASHES_DEFAULT})")
    return {"rows": rows, "crossover": crossover,
            "default": tsha256.DEVICE_MIN_HASHES_DEFAULT}


def sass_instructions(nvcc: str, lib: str, kernel: str) -> list[tuple]:
    """(address, opcode with its modifiers, branch target or None) of each
    SASS instruction of ``kernel`` in the shared library ``lib``
    (``cuobjdump -sass``; NOPs left out)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    out = []
    inside = False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9.]*)([^;]*);", ln)
            if m and not m.group(2).startswith("NOP"):
                tgt = (re.search(r"0x([0-9a-f]+)", m.group(3))
                       if m.group(2).startswith("BRA") else None)
                out.append((int(m.group(1), 16), m.group(2),
                            int(tgt.group(1), 16) if tgt else None))
    check(bool(out), f"no SASS found for {kernel} in {lib}")
    return out


def opcode_counts(ins, modifiers: bool = False) -> dict[str, int]:
    """Instructions by opcode (with its modifiers, or without), most first.
    The challenge kernel is fully unrolled, so each thread runs about its
    static count."""
    counts: dict[str, int] = {}
    for _, op, _ in ins:
        key = op if modifiers else op.split(".")[0]
        counts[key] = counts.get(key, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def largest_loop(ins) -> list[tuple]:
    """The body of the longest backward branch: in the verify kernel, one
    window of the scalar multiplication (64 per signature)."""
    index = {a: k for k, (a, _, _) in enumerate(ins)}
    best: list[tuple] = []
    for k, (a, _, tgt) in enumerate(ins):
        if tgt is not None and tgt < a and tgt in index \
                and k + 1 - index[tgt] > len(best):
            best = ins[index[tgt]:k + 1]
    return best


def ptxas_summary(build, src: str) -> str:
    """ptxas's register, stack and spill lines for the kernels of ``src``
    (the fe_op check kernel's lines left out)."""
    text = build.ptxas_report(src)
    lines, skip, fn = [], False, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            skip = "fe_op_kernel" in ln
        elif "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif not skip and ("registers" in ln or "spill" in ln):
            lines.append(f"{fn}: {ln.strip()}" if "spill" in ln else ln.strip())
    return " | ".join(lines)


def verify_sass_summary(sass: dict[str, int]) -> dict[str, int]:
    keys = ("IMAD", "IADD3", "LDL", "STL", "LDS")
    return {"total": sum(sass.values()), **{k: sass.get(k, 0) for k in keys}}


def occupancy(lib, blocks_n: int) -> dict[str, int]:
    """Resident blocks per SM of the verify kernel in ``lib`` and the waves
    its launch at ``blocks_n`` signatures takes on this card."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    fn = lib.ed25519_verify_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    check(fn(ctypes.byref(blocks), ctypes.byref(threads)) == 0,
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = -(-blocks_n // threads.value)
    check(blocks.value > 0, "the verify kernel fits no block on an SM")
    return {"blocks_per_sm": blocks.value, "threads": threads.value,
            "sms": sms, "grid": grid,
            "waves": -(-grid // (blocks.value * sms))}


SHA_LOOP_KEYS = ("LDG", "LDGSTS", "LDS", "PRMT", "SHF", "IADD3", "LOP3")


def sha_sass_summary(nvcc: str, lib: str, kernel: str) -> dict:
    """Static SASS counts of a SHA-256 kernel: its total, and in its largest
    loop (sha256_many: the block loop; the pair kernel: the level loop) the
    total, the loads and the instructions of the rounds, and the byte
    loads (LDG.*U8) anywhere in that loop."""
    ins = sass_instructions(nvcc, lib, kernel)
    loop = largest_loop(ins)
    counts = opcode_counts(loop)
    return {"total": len(ins), "loop_total": len(loop),
            "loop": {k: counts.get(k, 0) for k in SHA_LOOP_KEYS},
            "loop_byte_loads": sum(1 for _, op, _ in loop
                                   if op.startswith("LDG") and "U8" in op),
            "top": dict(list(opcode_counts(ins).items())[:10])}


def sha_occupancy(lib, n_messages: int, tree_width: int, depth: int,
                  trees: int) -> dict:
    """Resident CTAs per SM, threads per CTA, grid and waves of both SHA-256
    kernels at the wave's shapes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, chunks = (ctypes.c_int(0) for _ in range(3))
    fn = lib.sha256_many_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    check(fn(ctypes.byref(blocks), ctypes.byref(threads)) == 0,
          "sha256_many occupancy query failed")
    grid = -(-n_messages // threads.value)
    many = {"blocks_per_sm": blocks.value, "threads": threads.value,
            "grid": grid, "waves": -(-grid // (blocks.value * sms)),
            "ctas_per_sm": grid / sms}
    fn = lib.merkle_reduce_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    check(fn(trees, tree_width, depth, sms, ctypes.byref(blocks),
             ctypes.byref(threads), ctypes.byref(chunks)) == 0,
          "sha256_pair occupancy query failed")
    grid = -(-trees * -(-tree_width // 2**depth) // chunks.value)
    pair = {"blocks_per_sm": blocks.value, "threads": threads.value,
            "chunks_per_cta": chunks.value, "grid": grid,
            "waves": -(-grid // (blocks.value * sms)),
            "ctas_per_sm": grid / sms}
    return {"sms": sms, "sha256_many": many, "sha256_pair": pair}


def bound_ms(nbytes: int, int_ops: int) -> tuple[float, str]:
    """The least milliseconds to move ``nbytes`` or to issue ``int_ops``
    32-bit integer operations on this card, and which one binds."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, int_ops / PEAK_INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def out_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out")


# --- parent against change: the SHA-256 kernels of two trees in turns ------


def sha256_time(tree: str, inputs: str) -> int:
    """One turn: import corda_tpu_torch from ``tree`` (a checkout), build
    its kernels, check both SHA-256 kernels on the saved wave against the
    saved digests and roots, time them in the device window (medians of
    7) and print one line ``SHA256_TURN {json}``. A tree whose wrappers
    predate merkle_reduce_cuda reduces one level a launch."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from corda_tpu_torch.ops import _build, kernels
    from corda_tpu_torch.ops import sha256 as tsha256

    check(os.path.abspath(kernels.__file__).startswith(tree + os.sep),
          f"corda_tpu_torch came from {kernels.__file__}, not {tree}")
    libs = _build.build_all()
    dev = torch.device("cuda")
    d = np.load(inputs)
    data = torch.from_numpy(d["data"]).to(dev)
    offsets = torch.from_numpy(d["offsets"]).to(dev)
    level0 = torch.from_numpy(d["level"]).to(dev)
    if hasattr(kernels, "merkle_reduce_cuda"):
        most = kernels.MERKLE_DEPTH

        def pair_fn():
            return reduce_roots(kernels.merkle_reduce_cuda, level0, most)
    else:
        def pair_fn():
            return reduce_roots(lambda lv, _d: kernels.sha256_pair_cuda(lv),
                                level0, 1)

    def many_fn():
        return kernels.sha256_many_cuda(data, offsets)

    kernels.reset_launches()
    digests, roots = many_fn(), pair_fn()[:, :, 0]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(b"".join(tsha256.digests_of(digests)) == d["digests"].tobytes(),
          f"{tree}: sha256_many != hashlib on the wave")
    check(b"".join(tsha256.digests_of(roots)) == d["roots"].tobytes(),
          f"{tree}: the pair kernel's roots != the wave's ids")
    nvcc = _build.find_nvcc()
    out = {"tree": tree, "sha256_many_ms": kernel_ms(many_fn),
           "sha256_pair_ms": kernel_ms(pair_fn),
           "launches": {k: launches[k] for k in ("sha256_many", "sha256_pair")},
           "ptxas": ptxas_summary(_build, "sha256.cu"),
           "sass": {k: sha_sass_summary(nvcc, libs["sha256.cu"], f"{k}_kernel")
                    for k in ("sha256_many", "sha256_pair")}}
    print("SHA256_TURN " + json.dumps(out), flush=True)
    return 0


def sha256_turns(trees: list[str]) -> int:
    """Build the resolve wave once, then time both SHA-256 kernels of each
    tree in the order given (parent, change, change, parent), each in its
    own process (sha256_time); print every turn and the shares of the
    operation bound, and write chiprun_out/sha256_turns.json."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from corda_tpu_torch.ops import sha256 as tsha256
    from corda_tpu_torch.serialization.codec import deserialize
    from corda_tpu_torch.transactions import signed
    from corda_tpu_torch.transactions.signed import SignedTransaction

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    blobs, ids, _ = build_wave(np.random.default_rng(SEED))
    batch = [deserialize(b) for b in blobs]
    SignedTransaction.prime_ids(batch, device_min=NEVER, device="cpu")
    flat, _ = signed.component_blobs([x.tx for x in batch])
    leaves = [[h.bytes for h in x.tx.all_leaves_hashes] for x in batch]
    data, offsets = tsha256.pack_flat(flat)
    level = leaf_level(leaves, "cpu").numpy()
    tmp = tempfile.mkdtemp(prefix="sha256_turns")
    inputs = os.path.join(tmp, "wave.npz")
    np.savez(inputs, data=data, offsets=offsets, level=level,
             digests=np.frombuffer(b"".join(hashlib.sha256(m).digest()
                                            for m in flat), np.uint8),
             roots=np.frombuffer(b"".join(ids), np.uint8))
    blocks = int(((np.diff(offsets) + 8) // 64 + 1).sum())
    nodes, width = 0, level.shape[2]
    while width > 1:
        width = (width + 1) // 2
        nodes += level.shape[1] * width
    bounds = {"sha256_many": bound_ms(
                  data.size + 8 * len(offsets) + 32 * len(flat),
                  blocks * SHA256_BLOCK_INT_OPS),
              "sha256_pair": bound_ms(
                  32 * (level.shape[1] * level.shape[2] + level.shape[1]),
                  nodes * (SHA256_BLOCK_INT_OPS + SHA256_PAD_BLOCK_INT_OPS))}
    turns = []
    try:
        for tree in trees:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--sha256-time",
                 tree, inputs], capture_output=True, text=True, timeout=600)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("SHA256_TURN ")]
            check(proc.returncode == 0 and len(line) == 1,
                  f"turn in {tree} failed (rc {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            turn = json.loads(line[0].split(" ", 1)[1])
            turns.append(turn)
            log(f"{card} | turn {len(turns)} {tree}: sha256_many "
                f"{turn['sha256_many_ms']:.4f} ms "
                f"({bounds['sha256_many'][0] / turn['sha256_many_ms']:.1%} of "
                f"{bounds['sha256_many'][0]:.4f}), sha256_pair "
                f"{turn['sha256_pair_ms']:.4f} ms "
                f"({bounds['sha256_pair'][0] / turn['sha256_pair_ms']:.1%} of "
                f"{bounds['sha256_pair'][0]:.4f}); launches {turn['launches']}")
            for k, v in turn["sass"].items():
                log(f"  sass {k}_kernel: {v['total']} instructions; largest "
                    f"loop {v['loop_total']}: {v['loop']}, byte loads "
                    f"{v['loop_byte_loads']}")
            log(f"  ptxas: {turn['ptxas']}")
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    os.makedirs(out_dir(), exist_ok=True)
    with open(os.path.join(out_dir(), "sha256_turns.json"), "w") as f:
        json.dump({"card": card, "bounds": bounds, "blocks": blocks,
                   "nodes": nodes, "turns": turns}, f, indent=1)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from corda_tpu_torch import native
    from corda_tpu_torch.crypto import fast_ed25519, provider, sidecar
    from corda_tpu_torch.crypto import ref_ed25519 as ref
    from corda_tpu_torch.ops import _build, kernels
    from corda_tpu_torch.ops import ed25519 as ted
    from corda_tpu_torch.ops import sha256 as tsha256
    from corda_tpu_torch.ops import sha512 as tsha

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s {dict(_build.BUILD_SECONDS)}")
    for src in _build.SOURCES:
        log(f"ptxas {src}: {ptxas_summary(_build, src)}")
    sass2 = opcode_counts(sass_instructions(
        _build.find_nvcc(), libs["sha512_challenge.cu"],
        "sha512_challenge_kernel"))
    log(f"sass sha512_challenge_kernel: {sum(sass2.values())} instructions "
        f"(least count for the hash {CHALLENGE_INT_OPS}); "
        f"{dict(list(sass2.items())[:8])}")
    ins1 = sass_instructions(_build.find_nvcc(), libs["ed25519_verify.cu"],
                             "ed25519_verify_kernel")
    sass1 = opcode_counts(ins1)
    loop1 = opcode_counts(largest_loop(ins1), modifiers=True)
    occ = occupancy(_build.load("ed25519_verify.cu"), N_MAIN)
    log(f"sass ed25519_verify_kernel: {verify_sass_summary(sass1)}; "
        f"{dict(list(sass1.items())[:8])}")
    log(f"sass ed25519_verify_kernel window loop: {sum(loop1.values())} "
        f"instructions; {dict(list(loop1.items())[:10])}")
    log(f"ed25519_verify_kernel occupancy: {occ['blocks_per_sm']} blocks of "
        f"{occ['threads']} per SM x {occ['sms']} SMs; N={N_MAIN} is "
        f"{occ['grid']} blocks = {occ['waves']} wave(s)")
    sha_sass = {k: sha_sass_summary(_build.find_nvcc(), libs["sha256.cu"],
                                    f"{k}_kernel")
                for k in ("sha256_many", "sha256_pair")}
    for k, v in sha_sass.items():
        log(f"sass {k}_kernel: {v['total']} instructions; largest loop "
            f"{v['loop_total']}: {v['loop']}, byte loads "
            f"{v['loop_byte_loads']}; {v['top']}")
    check(sha_sass["sha256_many"]["loop_byte_loads"] == 0,
          "sha256_many's block loop loads message bytes one at a time")

    # 3. the host tier's native core
    host_res = phase_host_tier(ref, provider, native, fast_ed25519)

    zero_ok = ref.verify(bytes(32), bytes(32), bytes(64))

    # 4. field ops on the card, kernels vs plain versions
    phase_field_ops(ref, kernels, dev, rng)
    max_err = phase_kernels(ref, ted, tsha, kernels, dev, rng, zero_ok)

    # 5. main path at full size
    main_res, jobs, want, tuples, expect = phase_main(
        ref, provider, native, ted, tsha, kernels, dev, rng, card)
    for k, v in main_res["max_err"].items():
        max_err[k] = max(max_err[k], v)

    # 6. size crossover, 7. stream
    cross_res = phase_crossover(provider, native, fast_ed25519, kernels,
                                tuples, card)
    stream_res = phase_stream(ted, kernels, tuples, expect, main_res, card)

    # 8. sidecar, 9. degrade and re-probe
    stats, side_launches = phase_sidecar(provider, sidecar, kernels, jobs,
                                         want)
    degrade_res = phase_degrade(provider, kernels, jobs, want)

    # 10. SHA-256 kernels vs plain, 11. the resolve wave, 12. its crossover
    max_err.update(phase_sha256_kernels(tsha256, kernels, dev, rng))
    resolve_res, leaf_msgs = phase_resolve(provider, tsha256, kernels, dev,
                                           rng, card)
    for k in ("sha256_many", "sha256_pair"):
        max_err[k] = max(max_err[k], resolve_res[k]["max_err"])
    hash_cross = phase_hash_crossover(tsha256, leaf_msgs, card)

    # 13. kernels line
    bound1, by1 = bound_ms(N_MAIN * VERIFY_BYTES,
                           main_res["verify_least_int_ops"])
    bound2, by2 = bound_ms(N_MAIN * CHALLENGE_BYTES,
                           N_MAIN * CHALLENGE_INT_OPS)
    structure_ops = N_MAIN * (VERIFY_FIELD_MULS * MUL_INT_OPS
                              + VERIFY_FIELD_SQS * SQ_INT_OPS)
    log(f"verify bound: {bound1:.4f} ms for the least work of these scalars "
        f"({main_res['verify_least_per_sig']} per signature); the kernel's "
        f"fixed windows {bound_ms(0, structure_ops)[0]:.4f} ms")
    many, pair = resolve_res["sha256_many"], resolve_res["sha256_pair"]
    sha_occ = sha_occupancy(_build.load("sha256.cu"), many["messages"],
                            OUTPUTS_PER_TX + 1,
                            root_depth(OUTPUTS_PER_TX + 1,
                                       kernels.MERKLE_DEPTH),
                            N_WAVE)
    for k in ("sha256_many", "sha256_pair"):
        o = sha_occ[k]
        log(f"{k}_kernel occupancy: {o['blocks_per_sm']} CTAs of "
            f"{o['threads']} per SM x {sha_occ['sms']} SMs; the wave is "
            f"{o['grid']} CTAs ({o['ctas_per_sm']:.2f} an SM) = {o['waves']} "
            f"wave(s)" + (f", {o['chunks_per_cta']} trees a CTA"
                          if k == "sha256_pair" else ""))
    bound3, by3 = bound_ms(many["bytes"], many["blocks"] * SHA256_BLOCK_INT_OPS)
    bound4, by4 = bound_ms(pair["bytes"], pair["nodes"] * (
        SHA256_BLOCK_INT_OPS + SHA256_PAD_BLOCK_INT_OPS))
    for name, k_ms, b_ms in (("verify", main_res["k1_ms"], bound1),
                             ("challenge", main_res["k2_ms"], bound2),
                             ("sha256_many", many["ms"], bound3),
                             ("sha256_pair", pair["ms"], bound4)):
        log(f"{card} | {name} kernel {k_ms:.4f} ms = {b_ms / k_ms:.1%} of its "
            f"bound {b_ms:.4f} ms: "
            + ("at least half of it" if b_ms / k_ms >= 0.5
               else "under half of it"))
    line = {"kernels": [
        {"name": "ed25519_verify", "route": "cuda",
         "source": "corda_tpu_torch/ops/csrc/ed25519_verify.cu",
         "replaces": "corda_tpu/ops/ed25519_pallas.py:50",
         "launches": main_res["launches"]["ed25519_verify"],
         "max_abs_err": max_err["ed25519_verify"],
         "ms": main_res["k1_ms"], "plain_ms": main_res["p1_ms"],
         "bound_ms": bound1, "bound_by": by1, "library_ms": None},
        {"name": "sha512_challenge", "route": "cuda",
         "source": "corda_tpu_torch/ops/csrc/sha512_challenge.cu",
         "replaces": "corda_tpu/ops/sha512_jax.py:355",
         "launches": main_res["launches"]["sha512_challenge"],
         "max_abs_err": max_err["sha512_challenge"],
         "ms": main_res["k2_ms"], "plain_ms": main_res["p2_ms"],
         "bound_ms": bound2, "bound_by": by2, "library_ms": None},
        {"name": "sha256_many", "route": "cuda",
         "source": "corda_tpu_torch/ops/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256_jax.py:66",
         "launches": many["launches"], "max_abs_err": max_err["sha256_many"],
         "ms": many["ms"], "plain_ms": many["plain_ms"],
         "bound_ms": bound3, "bound_by": by3, "library_ms": None},
        {"name": "sha256_pair", "route": "cuda",
         "source": "corda_tpu_torch/ops/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256_jax.py:170",
         "launches": pair["launches"], "max_abs_err": max_err["sha256_pair"],
         "ms": pair["ms"], "plain_ms": pair["plain_ms"],
         "bound_ms": bound4, "bound_by": by4, "library_ms": None},
    ]}
    record = {"card": card, "build_s": build_s, "n_main": N_MAIN,
              "host_tier": host_res, "main": main_res,
              "crossover": cross_res, "stream": stream_res,
              "sidecar_stats": stats, "sidecar_launches": side_launches,
              "degrade": degrade_res, "resolve": resolve_res,
              "hash_crossover": hash_cross,
              "ptxas": {s: ptxas_summary(_build, s) for s in _build.SOURCES},
              "sass_sha512_challenge": sass2,
              "challenge_least_int_ops": CHALLENGE_INT_OPS,
              "sass_ed25519_verify": sass1,
              "sass_ed25519_verify_summary": verify_sass_summary(sass1),
              "sass_ed25519_verify_window_loop": loop1,
              "ed25519_verify_occupancy": occ,
              "sass_sha256": sha_sass, "sha256_occupancy": sha_occ,
              "verify_structure_bound_ms": bound_ms(0, structure_ops)[0],
              **line}
    os.makedirs(out_dir(), exist_ok=True)
    with open(os.path.join(out_dir(), "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(f"{card} | main path end to end {main_res['e2e_sigs_s']:.0f} sigs/s")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sha256-turns"]:
        raise SystemExit(sha256_turns(sys.argv[2:]))
    if sys.argv[1:2] == ["--sha256-time"]:
        raise SystemExit(sha256_time(*sys.argv[2:4]))
    raise SystemExit(main())
