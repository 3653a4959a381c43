"""Batched Ed25519 signature verification: plain PyTorch version, host
packing, and dispatch to the CUDA kernel.

Counterpart of ``corda_tpu/ops/ed25519_jax.py``. Semantics are the
conformance oracle's (crypto/ref_ed25519.py): cofactorless ref10 verify,
no S < L range check, silent y mod p on decompression, encode-compare
against the raw R bytes. The plain version below computes the JAX
module's ``verify_core`` with the same field operations; the CUDA kernel
(csrc/ed25519_verify.cu, via kernels.ed25519_verify_cuda) is held to the
same accept set.

Layout: 32-byte values travel as (8, N) little-endian 32-bit words, batch
minor, exactly as in the JAX package. torch's uint32 has no shifts or
arithmetic, so on the torch side the words are int32 tensors holding the
same bit patterns; the host packers return numpy uint32 arrays identical
to the JAX package's, and ``words_to_tensor`` / ``from_jax_words`` turn
them into tensors.

Dispatch: ``verify_arrays`` takes the plain version for a CPU tensor and
the kernel for a CUDA tensor. There is no per-call fallback: a kernel that
fails to build or launch raises.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from ..crypto import ref_ed25519 as ref
from . import fe25519 as fe

__all__ = ["verify_batch", "precompute_batch", "precompute_batch_device",
           "verify_arrays", "verify_arrays_reference", "verify_arrays_hashed",
           "verify_core", "pick_bucket", "device_hash_eligible",
           "from_jax_words", "words_to_tensor", "last_backend"]

_D = ref.D
_2D = (2 * ref.D) % ref.P
_SQRT_M1 = pow(2, (ref.P - 1) // 4, ref.P)
_L = ref.L

_STATE = {"last_backend": None}  # "cuda" | "torch-cpu"


def last_backend() -> str | None:
    """Backend of the newest verify_arrays call ("cuda" | "torch-cpu")."""
    return _STATE["last_backend"]


# ---------------------------------------------------------------------------
# Curve arithmetic (plain version; mirrors ed25519_jax op for op)
# ---------------------------------------------------------------------------


def _ext_add(p, q):
    """Unified a=-1 twisted-Edwards addition (add-2008-hwcd-3), complete."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, t2), fe._fill_like(_2D, t1))
    d = fe.mul_small(fe.mul(z1, z2), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def _ext_dbl(p):
    """Dedicated doubling (dbl-2008-hwcd, a=-1), complete."""
    x1, y1, z1, _ = p
    a = fe.sq(x1)
    b = fe.sq(y1)
    c = fe.mul_small(fe.sq(z1), 2)
    e = fe.sub(fe.sub(fe.sq(fe.add(x1, y1)), a), b)
    g = fe.sub(b, a)
    f = fe.sub(g, c)
    h = fe.neg(fe.add(a, b))
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane table lookup: table (16, 20, N), idx (N,) -> (20, N)."""
    index = idx.long()[None, None, :].expand(1, table.shape[1], idx.shape[0])
    return torch.gather(table, 0, index)[0]


def _build_a_table(neg_a):
    """[0..15]*(-A) as 4 stacked (16, 20, N) coordinate tensors; every
    entry comes from the unified add (entry 0 = identity)."""
    x = neg_a[0]
    zero = fe._fill_like(0, x)
    one = fe._fill_like(1, x)
    entries = [(zero, one, one, zero), neg_a]
    for _ in range(14):
        entries.append(_ext_add(entries[-1], neg_a))
    return tuple(torch.stack([e[c] for e in entries]) for c in range(4))


def _host_b_table() -> np.ndarray:
    """Fixed-base table [0..15]*B, affine (x, y, t=xy) with z = 1, in the
    13-bit limbs: (3, 16, 20) int32, built from the port's oracle copy."""
    tab = np.zeros((3, 16, fe.NLIMBS), np.int32)
    for k, (x, y, t) in enumerate(b_table_ints()):
        tab[0, k] = fe.limbs_of_int(x)
        tab[1, k] = fe.limbs_of_int(y)
        tab[2, k] = fe.limbs_of_int(t)
    return tab


def b_table_ints() -> list[tuple[int, int, int]]:
    """[k]B for k = 0..15 as affine (x, y, x*y mod p) Python ints."""
    entries = [(0, 1, 0)]
    for k in range(1, 16):
        x, y = ref.scalar_mult(k, ref.B)
        entries.append((x, y, x * y % ref.P))
    return entries


_B_TABLE = _host_b_table()  # (3, 16, 20) int32; z == 1 for every entry


def _b_entry(idx, one, b_table):
    """B-table lookup: b_table (3, 16, 20) tensor -> extended point."""
    ix = idx.long()
    coords = [b_table[c][ix].T for c in range(3)]  # (20, N) each
    return (coords[0], coords[1], one, coords[2])


def _double_scalar_mult_sub(s_nibs, h_nibs, neg_a, b_table):
    """[s]B + [h](-A) by 4-bit windowed Strauss: 64 windows of 4 doublings
    and 2 table adds. s and h are full 256-bit integers (no range check)."""
    a_table = _build_a_table(neg_a)
    x = neg_a[0]
    one = fe._fill_like(1, x)
    zero = fe._fill_like(0, x)
    acc = (zero, one, one, zero)
    for t in range(64):
        for _ in range(4):
            acc = _ext_dbl(acc)
        acc = _ext_add(acc, _b_entry(s_nibs[t], one, b_table))
        acc = _ext_add(acc, tuple(_lookup(c, h_nibs[t]) for c in a_table))
    return acc


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern words -> int64 tensor of their unsigned values."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _unpack_limbs(words):
    """(8, N) LE words -> ((20, N) int32 limbs of bits 0..254, (N,) int32
    sign bit 255)."""
    w = _u32(words)
    limbs = []
    for i in range(fe.NLIMBS):
        word, shift = (13 * i) // 32, (13 * i) % 32
        lo = w[word] >> shift
        if shift > 19 and word + 1 < 8:  # 13 bits spill into the next word
            lo = lo | (w[word + 1] << (32 - shift))
        mask = 0xFF if i == fe.NLIMBS - 1 else fe.MASK  # drop bits >= 255
        limbs.append(lo & mask)
    sign = (w[7] >> 31).to(torch.int32)
    return torch.stack(limbs).to(torch.int32), sign


def _nibbles_msb(words):
    """(8, N) LE words -> (64, N) int32 4-bit windows, MSB first."""
    w = _u32(words)
    nibs = []
    for j in range(64):
        bit = 255 - 4 * j - 3
        word, shift = bit // 32, bit % 32
        nibs.append((w[word] >> shift) & 0xF)
    return torch.stack(nibs).to(torch.int32)


def decompress_neg_a(y, a_sign):
    """ref10 ge_frombytes + negate: (point_ok (N,), -A extended)."""
    one = fe._fill_like(1, y)
    yy = fe.sq(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe._fill_like(_D, y)), one)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    vxx = fe.mul(v, fe.sq(x))
    ok_direct = fe.eq(vxx, u)
    ok_flip = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok_flip & ~ok_direct,
                  fe.mul(x, fe._fill_like(_SQRT_M1, y)), x)
    point_ok = ok_direct | ok_flip
    parity = fe.freeze(x)[0] & 1
    x = fe.select(parity != a_sign, fe.neg(x), x)
    nx = fe.neg(x)
    return point_ok, (nx, y, one, fe.mul(nx, y))


def encode_compare(rpoint, r_limbs, r_sign, point_ok):
    """Canonical-encode R' and compare against the raw R bytes."""
    rx, ry, rz, _ = rpoint
    zi = fe.inv(rz)
    xr = fe.freeze(fe.mul(rx, zi))
    yr = fe.freeze(fe.mul(ry, zi))
    enc_ok = torch.all(yr == r_limbs, dim=0) & ((xr[0] & 1) == r_sign)
    return point_ok & enc_ok


def verify_core(y, a_sign, r_limbs, r_sign, s_nibs, h_nibs, b_table=None):
    """The verification math on unpacked values -> bool (N,)."""
    if b_table is None:
        b_table = torch.as_tensor(_B_TABLE, device=y.device)
    point_ok, neg_a = decompress_neg_a(y, a_sign)
    rpoint = _double_scalar_mult_sub(s_nibs, h_nibs, neg_a, b_table)
    return encode_compare(rpoint, r_limbs, r_sign, point_ok)


def verify_arrays_reference(a_words, r_words, s_words, h_words):
    """Plain PyTorch version of the verify kernel, on any device: (8, N)
    int32 words of A, raw R, S and h = SHA-512(R||A||M) mod L in, bool
    (N,) out. The JAX package's verify_arrays, in torch."""
    y, a_sign = _unpack_limbs(a_words)
    r_limbs, r_sign = _unpack_limbs(r_words)
    return verify_core(y, a_sign, r_limbs, r_sign,
                       _nibbles_msb(s_words), _nibbles_msb(h_words))


def verify_arrays(a_words, r_words, s_words, h_words):
    """Verify (8, N) int32 word tensors -> bool (N,) on their device: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if a_words.device.type == "cpu":
        _STATE["last_backend"] = "torch-cpu"
        return verify_arrays_reference(a_words, r_words, s_words, h_words)
    from . import kernels

    _STATE["last_backend"] = "cuda"
    return kernels.ed25519_verify_cuda(a_words, r_words, s_words,
                                       h_words).to(torch.bool)


def verify_arrays_hashed(a_words, r_words, s_words, m_words):
    """Verify with 32-byte messages: the challenge h = SHA-512(R||A||M)
    mod L is computed on the words' device first."""
    from . import sha512

    h_words = sha512.challenge_words(r_words, a_words, m_words)
    return verify_arrays(a_words, r_words, s_words, h_words)


# ---------------------------------------------------------------------------
# Host packing (numpy; byte-identical to the JAX package's packers)
# ---------------------------------------------------------------------------


def pick_bucket(n: int, buckets=(64, 256, 1024, 4096, 16384, 65536)) -> int:
    """The JAX package's static batch-size ladder. The CUDA kernel takes
    any N, so the port's verifiers pack to the exact batch size; the ladder
    stays for the packers' default and the sidecar's histogram keys."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def _words_of(enc: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 little-endian encodings -> (8, B) uint32 words."""
    return np.ascontiguousarray(enc).view("<u4").T.copy()


def _pack_pk_rs(pubkeys, sigs, n: int, b: int):
    """Keys + signatures -> padded (b, 32) uint8 arrays for A, R, S."""
    pk_cat = b"".join(bytes(k) for k in pubkeys)
    sig_cat = b"".join(bytes(s) for s in sigs)
    pk = np.zeros((b, 32), np.uint8)
    r_enc = np.zeros((b, 32), np.uint8)
    s_raw = np.zeros((b, 32), np.uint8)
    pk[:n] = np.frombuffer(pk_cat, np.uint8).reshape(n, 32)
    sg = np.frombuffer(sig_cat, np.uint8).reshape(n, 64)
    r_enc[:n] = sg[:, :32]
    s_raw[:n] = sg[:, 32:]
    return pk_cat, sig_cat, pk, r_enc, s_raw


def precompute_batch(pubkeys, msgs, sigs, bucket: int | None = None):
    """Host packing with host hashing, for messages of any length: four
    (8, bucket) uint32 word arrays (A, R, S, h) and n. h = SHA-512(R_enc ||
    A_enc || M) mod L with the original encodings, computed by hashlib."""
    n = len(sigs)
    b = bucket or pick_bucket(n)
    pk_cat, sig_cat, pk, r_enc, s_raw = _pack_pk_rs(pubkeys, sigs, n, b)
    h_raw = np.zeros((b, 32), np.uint8)
    sha512 = hashlib.sha512
    for i in range(n):
        digest = sha512(sig_cat[64 * i:64 * i + 32]
                        + pk_cat[32 * i:32 * i + 32]
                        + bytes(msgs[i])).digest()
        h = int.from_bytes(digest, "little") % _L
        h_raw[i] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
    return (_words_of(pk), _words_of(r_enc),
            _words_of(s_raw), _words_of(h_raw)), n


def precompute_batch_device(pubkeys, msgs, sigs, bucket: int | None = None):
    """Host packing for the device-hashed path: all messages must be 32
    bytes (the notary's tx ids). Returns ((A, R, S, M) (8, bucket) uint32
    word arrays, n). Packs in the native core (native/_cverify.c
    ``pack_words``, GIL released) where it builds, else in numpy
    (:func:`precompute_batch_device_numpy`); the two give byte-equal words
    and the same ValueErrors in the same order."""
    from .. import native

    core = native.load_cverify()
    if core is None:
        return precompute_batch_device_numpy(pubkeys, msgs, sigs, bucket)
    n = len(sigs)
    b = bucket or pick_bucket(n)
    raw = core.pack_words(pubkeys, msgs, sigs, b)
    return tuple(np.frombuffer(w, "<u4").reshape(8, b) for w in raw), n


def precompute_batch_device_numpy(pubkeys, msgs, sigs,
                                  bucket: int | None = None):
    """The numpy packer of the device-hashed path: the behavioural
    authority the native packer is held to, and the fallback where it does
    not build. Checks each item (pk -> msg -> sig) with the JAX package's
    messages and order, so malformed input fails identically."""
    n = len(sigs)
    b = bucket or pick_bucket(n)
    raw = [bytes(m) for m in msgs]
    if len(raw) != n or len(pubkeys) != n:
        raise ValueError("pubkeys, msgs and sigs must have equal length")
    if b < n:
        raise ValueError("bucket smaller than batch")
    for pk, m, s in zip(pubkeys, raw, sigs):
        if len(bytes(pk)) != 32:
            raise ValueError("pubkeys must be 32 bytes")
        if len(m) != 32:
            raise ValueError("device-hash path requires 32-byte messages")
        if len(bytes(s)) != 64:
            raise ValueError("sigs must be 64 bytes")
    m_cat = b"".join(raw)
    _, _, pk, r_enc, s_raw = _pack_pk_rs(pubkeys, sigs, n, b)
    m_raw = np.zeros((b, 32), np.uint8)
    m_raw[:n] = np.frombuffer(m_cat, np.uint8).reshape(n, 32)
    return (_words_of(pk), _words_of(r_enc),
            _words_of(s_raw), _words_of(m_raw)), n


def device_hash_eligible(msgs) -> bool:
    """All-32-byte messages (tx ids) hash on the device."""
    return all(len(bytes(m)) == 32 for m in msgs)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """(8, N) uint32 numpy words -> int32 tensor of the same bit patterns."""
    arr = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def from_jax_words(a, r, s, h_or_m, device="cuda"):
    """The JAX package's (8, N) uint32 word arrays (as numpy) -> the port's
    int32 bit-pattern tensors on ``device``."""
    from . import require_cuda

    dev = require_cuda(device)
    return tuple(words_to_tensor(np.asarray(w), dev) for w in (a, r, s, h_or_m))


def _precompute_auto(pubkeys, msgs, sigs, bucket: int | None):
    """Dispatch per device_hash_eligible -> (verify_fn, arrays, n)."""
    if device_hash_eligible(msgs):
        arrays, n = precompute_batch_device(pubkeys, msgs, sigs, bucket=bucket)
        return verify_arrays_hashed, arrays, n
    arrays, n = precompute_batch(pubkeys, msgs, sigs, bucket=bucket)
    return verify_arrays, arrays, n


def verify_batch(pubkeys, msgs, sigs, device="cuda") -> np.ndarray:
    """End-to-end batched verify on ``device`` -> bool (len(sigs),).

    Malformed inputs (wrong key or signature lengths) reject, never raise.
    The batch is packed to its exact well-formed count: the kernels take
    any N, so nothing is padded."""
    from . import require_cuda

    dev = require_cuda(device)
    n = len(sigs)
    ok = np.zeros(n, bool)
    good = [i for i in range(n)
            if len(bytes(pubkeys[i])) == 32 and len(bytes(sigs[i])) == 64]
    if not good:
        return ok
    verify_fn, arrays, m = _precompute_auto(
        [pubkeys[i] for i in good], [msgs[i] for i in good],
        [sigs[i] for i in good], len(good))
    tensors = [words_to_tensor(w, dev) for w in arrays]
    out = verify_fn(*tensors)[:m].cpu().numpy()
    ok[good] = out
    return ok


def verify_stream(batches, device="cuda", depth: int = 2):
    """Pipelined streaming verify: yields one bool array per input batch,
    in order.

    ``batches`` is an iterable of (pubkeys, msgs, sigs) triples; each packs
    to its exact size (malformed input raises, as the packers do). On the
    card the host packs batch k + 1 while the device runs batch k: the
    words go into pinned host memory, copy to the card with
    ``non_blocking``, both kernels run on one CUDA stream of this call that
    the host never waits on, and the answers copy back into pinned memory
    behind an event. The host waits on that event only when it pops the
    oldest batch, which it does once more than ``depth`` are in flight, so
    at most ``depth + 1`` batches are resident. On the CPU (the plain
    versions) every step is synchronous and the results are the same."""
    from . import require_cuda

    dev = require_cuda(device)
    cuda = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if cuda else None  # None: no stream
    pending = collections.deque()  # (event, answers, n), oldest first

    def pop():
        event, answers, n = pending.popleft()
        if event is not None:
            event.synchronize()
        return answers.numpy()[:n].copy()

    for pubkeys, msgs, sigs in batches:
        n = len(sigs)
        verify_fn, arrays, _ = _precompute_auto(pubkeys, msgs, sigs, n)
        if n == 0:  # checked by the packer; nothing to launch
            pending.append((None, torch.zeros(0, dtype=torch.bool), 0))
        else:
            host = torch.empty((4, 8, n), dtype=torch.int32, pin_memory=cuda)
            for k, w in enumerate(arrays):
                host[k].numpy()[...] = np.asarray(w, np.uint32).view(np.int32)
            event = None
            with torch.cuda.stream(stream):
                words = host.to(dev, non_blocking=True)
                answers = torch.empty(n, dtype=torch.bool, pin_memory=cuda)
                answers.copy_(verify_fn(*words), non_blocking=True)
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
            pending.append((event, answers, n))
        if len(pending) > depth:
            yield pop()
    while pending:
        yield pop()
