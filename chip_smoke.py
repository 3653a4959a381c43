"""Drive corda_tpu_torch's main path on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA card, nvcc and
this checkout):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. probe    -- a CUDA device must exist; print its name and power limit.
  2. build    -- compile both kernels from csrc/ with nvcc (in parallel).
  3. kernels  -- the verify kernel's field operations (its PTX carry
                 chains) on the card against Python integers; each kernel
                 against its plain PyTorch version on the card
                 on the golden corpus (valid, corrupted, S + L, non-canonical
                 A and R, an invalid point, all-zero lanes) at N = 1024 and
                 a ragged N = 1000, and the challenge against hashlib.
  4. main     -- 65,536 VerifyJobs with 32-byte tx ids through
                 TorchVerifier.verify_batch (pack -> challenge kernel ->
                 verify kernel), answers held to the oracle; one batch of
                 variable-length messages (host-hashed); kernel and
                 plain-version timings at that size.
  5. sidecar  -- a SidecarServer on the card, three client threads sending
                 2,048-signature requests (one with a tampered job, one with
                 a malformed key); every reply held to the oracle.
  6. the verify kernel's registers, static SASS counts, resident blocks
     per SM and waves at N_MAIN; the kernels line, then the device line
     (last).

Everything is made from fixed seeds; the oracle (crypto/ref_ed25519.py)
decides every expected answer.
"""

from __future__ import annotations

import ctypes
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


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    each run bracketed by CUDA events."""
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


def phase_main(ref, provider, ted, tsha, kernels, dev, rng, card):
    """Phase 4: the main path at full size, then its timings."""
    jobs, want, tuples, expect = main_jobs(ref, provider, rng)
    verifier = provider.TorchVerifier(device="cuda")

    kernels.reset_launches()
    got = verifier.verify_batch(jobs)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(got.shape == (N_MAIN,) and got.dtype == bool, "bad result shape")
    check(np.array_equal(got, want),
          f"main path != oracle on {int((got != want).sum())} lanes")
    check(launches["ed25519_verify"] > 0 and launches["sha512_challenge"] > 0,
          f"main path did not launch both kernels: {launches}")
    log(f"main path: {N_MAIN} sigs match the oracle "
        f"({int(want.sum())} valid, {int((~want).sum())} tampered); "
        f"launches {launches}")

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
    log("host-hashed path: 512 sigs with variable-length messages match")

    # Timings at the main path's shapes.
    pks = [j.pubkey for j in jobs]
    msgs = [j.message for j in jobs]
    sigs = [j.sig for j in jobs]
    pack_ms = host_ms(lambda: ted.precompute_batch_device(pks, msgs, sigs,
                                                          bucket=N_MAIN))
    (a, r, s, m), _ = ted.precompute_batch_device(pks, msgs, sigs,
                                                  bucket=N_MAIN)
    A, R, S, M = (ted.words_to_tensor(w, dev) for w in (a, r, s, m))
    h = kernels.sha512_challenge_cuda(R, A, M)
    k2_ms = cuda_ms(lambda: kernels.sha512_challenge_cuda(R, A, M))
    k1_ms = cuda_ms(lambda: kernels.ed25519_verify_cuda(A, R, S, h))
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
    p2_ms = cuda_ms(lambda: tsha.challenge_words_reference(R, A, M), reps=3)
    p1_ms = cuda_ms(lambda: ted.verify_arrays_reference(A, R, S, h), reps=2)

    e2e_ms = host_ms(lambda: verifier.verify_batch(jobs), reps=3)
    log(f"{card} | timings at N={N_MAIN}: pack {pack_ms:.3f} ms, challenge kernel "
        f"{k2_ms:.4f} ms (plain {p2_ms:.1f} ms), verify kernel {k1_ms:.3f} ms "
        f"(plain {p1_ms:.1f} ms), end to end {e2e_ms:.1f} ms = "
        f"{N_MAIN / (e2e_ms / 1e3):.0f} sigs/s")
    return {
        "launches": launches, "pack_ms": pack_ms, "k1_ms": k1_ms,
        "k2_ms": k2_ms, "p1_ms": p1_ms, "p2_ms": p2_ms, "e2e_ms": e2e_ms,
        "e2e_sigs_s": N_MAIN / (e2e_ms / 1e3),
        "verify_least_int_ops": least_ops,
        "verify_least_per_sig": least_per_sig,
        "max_err": {
            "ed25519_verify": int((ok_k.long() - ok_p.long()).abs().max()),
            "sha512_challenge": int((h.long() - h_p.long()).abs().max())},
    }, jobs, want


def sidecar_address() -> tuple[str, str | None]:
    tmp = tempfile.mkdtemp(prefix="cts")
    path = os.path.join(tmp, "sidecar.sock")
    if len(path) < 100:
        return path, tmp
    return "127.0.0.1:0", tmp  # socket path too long: use localhost TCP


def phase_sidecar(provider, sidecar, kernels, jobs, want):
    """Phase 5: three clients through one SidecarServer on the card."""
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
    launches = dict(kernels.LAUNCHES)
    check(not errors, "; ".join(errors))
    check(not any(t.is_alive() for t in threads), "sidecar client hung")
    check(sidecar._VERIFY_REPLY_HDR.unpack_from(reply)[2] == sidecar.STATUS_ERR,
          "OP_VERIFY_QOS did not get STATUS_ERR")
    check(stats["requests"] == 3 * reqs_per_client, f"stats: {stats}")
    check(stats["device_batches"] and stats["cross_request_batches"] > 0,
          f"no merged device batches: {stats}")
    check(stats["kernel_backend"] == "cuda", f"stats: {stats}")
    check(launches["ed25519_verify"] > 0 and launches["sha512_challenge"] > 0,
          f"sidecar did not launch both kernels: {launches}")
    log(f"sidecar: {stats['requests']} requests from 3 clients match the "
        f"oracle; batches {stats['batches']} (merged "
        f"{stats['cross_request_batches']}), hist {stats['batch_sigs_hist']}, "
        f"pad_lanes {stats['pad_lanes']}, launches {launches}")
    return stats, launches


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


def bound_ms(nbytes: int, int_ops: int) -> tuple[float, str]:
    """The least milliseconds to move ``nbytes`` or to issue ``int_ops``
    32-bit integer operations on this card, and which one binds."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, int_ops / PEAK_INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def out_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from corda_tpu_torch.crypto import provider, ref_ed25519 as ref, sidecar
    from corda_tpu_torch.ops import _build, kernels
    from corda_tpu_torch.ops import ed25519 as ted
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

    zero_ok = ref.verify(bytes(32), bytes(32), bytes(64))

    # 3. field ops on the card, kernels vs plain versions
    phase_field_ops(ref, kernels, dev, rng)
    max_err = phase_kernels(ref, ted, tsha, kernels, dev, rng, zero_ok)

    # 4. main path at full size
    main_res, jobs, want = phase_main(ref, provider, ted, tsha, kernels, dev,
                                      rng, card)
    for k, v in main_res["max_err"].items():
        max_err[k] = max(max_err[k], v)

    # 5. sidecar
    stats, side_launches = phase_sidecar(provider, sidecar, kernels, jobs,
                                         want)

    # 6. kernels line
    bound1, by1 = bound_ms(N_MAIN * VERIFY_BYTES,
                           main_res["verify_least_int_ops"])
    bound2, by2 = bound_ms(N_MAIN * CHALLENGE_BYTES,
                           N_MAIN * CHALLENGE_INT_OPS)
    structure_ops = N_MAIN * (VERIFY_FIELD_MULS * MUL_INT_OPS
                              + VERIFY_FIELD_SQS * SQ_INT_OPS)
    log(f"verify bound: {bound1:.4f} ms for the least work of these scalars "
        f"({main_res['verify_least_per_sig']} per signature); the kernel's "
        f"fixed windows {bound_ms(0, structure_ops)[0]:.4f} ms")
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
    ]}
    record = {"card": card, "build_s": build_s, "n_main": N_MAIN,
              "main": main_res, "sidecar_stats": stats,
              "sidecar_launches": side_launches,
              "ptxas": {s: ptxas_summary(_build, s) for s in _build.SOURCES},
              "sass_sha512_challenge": sass2,
              "challenge_least_int_ops": CHALLENGE_INT_OPS,
              "sass_ed25519_verify": sass1,
              "sass_ed25519_verify_summary": verify_sass_summary(sass1),
              "sass_ed25519_verify_window_loop": loop1,
              "ed25519_verify_occupancy": occ,
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
    raise SystemExit(main())
