"""Canned deterministic test identities.

The port's own copy of ``corda_tpu/testing/identities.py``.

Capability match for the reference's CoreTestUtils (reference:
test-utils/src/main/kotlin/net/corda/testing/CoreTestUtils.kt:40-80 — MEGA_CORP,
MINI_CORP, ALICE/BOB/CHARLIE, DUMMY_NOTARY with fixed entropy keys).
"""

from __future__ import annotations

from ..crypto.keys import KeyPair
from ..crypto.party import Party


def entropy_keypair(entropy: int) -> KeyPair:
    """Deterministic key pair from an integer seed (entropyToKeyPair)."""
    return KeyPair.generate(entropy.to_bytes(32, "little"))


ALICE_KEY = entropy_keypair(70)
ALICE = Party.of("Alice", ALICE_KEY.public)

BOB_KEY = entropy_keypair(80)
BOB = Party.of("Bob", BOB_KEY.public)

CHARLIE_KEY = entropy_keypair(90)
CHARLIE = Party.of("Charlie", CHARLIE_KEY.public)

MEGA_CORP_KEY = entropy_keypair(110)
MEGA_CORP = Party.of("MegaCorp", MEGA_CORP_KEY.public)

MINI_CORP_KEY = entropy_keypair(120)
MINI_CORP = Party.of("MiniCorp", MINI_CORP_KEY.public)

DUMMY_NOTARY_KEY = entropy_keypair(20)
DUMMY_NOTARY = Party.of("Notary Service", DUMMY_NOTARY_KEY.public)
