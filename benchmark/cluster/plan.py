"""Which moves of a client's corpus are honest, tampered or second spends,
drawn from the seed. Plain Python: the driver, the judge's caller and the
client nodes derive the same labels from it, so a client's own report of
its labels is never trusted.

In every block of ``block`` moves, ``second`` moves spend again the input
of an earlier honest move (its ``original``, about half a block before it)
and ``tampered`` moves carry one flipped signature among their ``width``.
"""

from __future__ import annotations

import hashlib

import numpy as np

HONEST, TAMPERED, SECOND_SPEND = 0, 1, 2


def _rng(seed: int, *tag) -> np.random.Generator:
    h = hashlib.sha256(b"corda-bench:" + str(int(seed)).encode())
    for t in tag:
        h.update(b"/" + str(t).encode())
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


def moves(seed: int, client: int, n: int, tampered: int = 2,
          second: int = 1, block: int = 200) -> tuple[list, dict]:
    """(kind of each of the ``n`` moves, {second spend: its original}).
    Only whole blocks carry tampered moves and second spends."""
    rng = _rng(seed, "fh32", "client", client, "plan")
    kind = [HONEST] * n
    original: dict[int, int] = {}
    half = block // 2
    for b0 in range(0, n - block + 1, block):
        for q in sorted(b0 + half + rng.choice(half, second, replace=False)):
            q = int(q)
            o = q - half
            while kind[o] != HONEST or o in original.values():
                o -= 1
            kind[q] = SECOND_SPEND
            original[q] = o
        free = [i for i in range(b0, b0 + block)
                if kind[i] == HONEST and i not in original.values()]
        for i in rng.choice(len(free), tampered, replace=False):
            kind[free[int(i)]] = TAMPERED
    return kind, original


def key_entropy(seed: int, client: int, *tag) -> bytes:
    """32 bytes for one of a client's signing keys."""
    h = hashlib.sha256(b"corda-bench:" + str(int(seed)).encode())
    for t in ("fh32", "client", client, *tag):
        h.update(b"/" + str(t).encode())
    return h.digest()


def flipped_lane(seed: int, client: int, i: int, width: int) -> tuple:
    """(which signature of tampered move ``i`` is flipped, the byte, the
    xor mask)."""
    rng = _rng(seed, "fh32", "client", client, "flip", i)
    return (int(rng.integers(0, width)), int(rng.integers(0, 64)),
            int(rng.integers(1, 256)))
