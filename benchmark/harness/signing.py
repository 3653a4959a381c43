"""Signed lanes from the seed, made with `cryptography` and hashlib, in
parallel worker processes, never with the program's signer.

A lane is (public key, 32-byte message, 64-byte signature) and a label:
whether the frozen oracle accepts it. Lane kinds:

  0  an honest signature                                     (accepted)
  1  one byte of the signature flipped                       (rejected)
  2  S + L in place of S: the same signature with a
     non-reduced scalar, which the oracle's semantics accept
     (no S < L check) and a strict verifier rejects           (accepted)

Which lanes are of kinds 1 and 2 is drawn from the seed, in fixed counts,
so every seed does the same work in another order.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os

import numpy as np

L = 2 ** 252 + 27742317777372353535851937790883648493

HONEST, FLIPPED, MALLEATED = 0, 1, 2


def seed_bytes(seed: int, *tag) -> bytes:
    """32 bytes derived from the run's seed and a tag path."""
    h = hashlib.sha256(b"corda-bench:" + str(int(seed)).encode())
    for t in tag:
        h.update(b"/" + str(t).encode())
    return h.digest()


def rng_for(seed: int, *tag) -> np.random.Generator:
    return np.random.default_rng(
        int.from_bytes(seed_bytes(seed, *tag), "little"))


def _sign_chunk(args):
    """Worker: sign lanes [lo, hi) of one lane set. Key k of the set signs
    lane i when i % n_keys == k; lane i's message is the SHA-256 of the
    set's message prefix and i."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey)

    seed, tag, lo, hi, n_keys = args
    keys = {}
    prefix = hashlib.sha256(seed_bytes(seed, tag, "msg"))
    pks = bytearray()
    msgs = bytearray()
    sigs = bytearray()
    for i in range(lo, hi):
        k = i % n_keys
        if k not in keys:
            key = Ed25519PrivateKey.from_private_bytes(
                seed_bytes(seed, tag, "key", k))
            keys[k] = (key, key.public_key().public_bytes_raw())
        key, pk = keys[k]
        h = prefix.copy()
        h.update(i.to_bytes(8, "little"))
        msg = h.digest()
        pks += pk
        msgs += msg
        sigs += key.sign(msg)
    return bytes(pks), bytes(msgs), bytes(sigs)


def workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def sign_lanes(seed: int, tag: str, n: int, n_keys: int,
               flipped: int, malleated: int, pool=None) -> dict:
    """``n`` lanes of set ``tag``: arrays pk (n, 32), msg (n, 32), sig
    (n, 64) uint8, kind (n,) int8 and label (n,) bool. ``flipped`` and
    ``malleated`` lanes (counts) are drawn from the seed."""
    chunk = max(1, -(-n // (4 * workers())))
    jobs = [(seed, tag, lo, min(n, lo + chunk), n_keys)
            for lo in range(0, n, chunk)]
    parts = (pool.map(_sign_chunk, jobs) if pool is not None
             else [_sign_chunk(j) for j in jobs])
    pk = np.frombuffer(b"".join(p[0] for p in parts), np.uint8).reshape(n, 32)
    msg = np.frombuffer(b"".join(p[1] for p in parts), np.uint8).reshape(n, 32)
    sig = np.frombuffer(b"".join(p[2] for p in parts),
                        np.uint8).reshape(n, 64).copy()
    rng = rng_for(seed, tag, "kinds")
    picks = rng.permutation(n)[:flipped + malleated]
    kind = np.zeros(n, np.int8)
    kind[picks[:flipped]] = FLIPPED
    kind[picks[flipped:]] = MALLEATED
    for i in picks[:flipped]:
        pos = int(rng.integers(0, 64))
        sig[i, pos] ^= int(rng.integers(1, 256))
    for i in picks[flipped:]:
        s = int.from_bytes(sig[i, 32:].tobytes(), "little") + L
        sig[i, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    return {"pk": pk, "msg": msg, "sig": sig, "kind": kind,
            "label": kind != FLIPPED}


def pool(n: int | None = None):
    """A pool of spawned worker processes (the caller closes it)."""
    return multiprocessing.get_context("spawn").Pool(n or workers())


def oracle_chunk(lanes):
    """Worker: the frozen oracle's verdict on each (pk, msg, sig)."""
    from ..reference import ed25519

    return [ed25519.verify(pk, m, s) for pk, m, s in lanes]


def oracle_verdicts(lanes: list, pool=None) -> list[bool]:
    """The frozen oracle over many lanes, split across the pool."""
    if not lanes:
        return []
    step = max(1, -(-len(lanes) // (4 * workers())))
    chunks = [lanes[i:i + step] for i in range(0, len(lanes), step)]
    parts = (pool.map(oracle_chunk, chunks) if pool is not None
             else [oracle_chunk(c) for c in chunks])
    return [v for part in parts for v in part]
