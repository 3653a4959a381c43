"""Base58 encoding (Bitcoin alphabet).

The port's own copy of ``corda_tpu/crypto/base58.py``.

Capability match for the reference's Base58.java (reference:
core/src/main/java/net/corda/core/crypto/Base58.java) — used for rendering
public keys and naming per-peer message queues
(reference: node/.../messaging/ArtemisMessagingComponent.kt:31-38).
"""

from __future__ import annotations

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n > 0:
        n, rem = divmod(n, 58)
        out.append(_ALPHABET[rem])
    # Preserve leading zero bytes as '1' characters.
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def decode(s: str) -> bytes:
    n = 0
    for c in s:
        if c not in _INDEX:
            raise ValueError(f"invalid base58 character: {c!r}")
        n = n * 58 + _INDEX[c]
    pad = 0
    for c in s:
        if c == "1":
            pad += 1
        else:
            break
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    return b"\x00" * pad + body
