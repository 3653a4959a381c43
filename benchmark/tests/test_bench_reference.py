"""The plain reference: the frozen oracle on RFC 8032's vectors and on the
lane kinds the traffic makes."""

from __future__ import annotations

import ast

import numpy as np
import pytest

from benchmark.harness import core, signing
from benchmark.reference import ed25519

# RFC 8032 section 7.1, tests 1-3: (secret key, public key, message, sig).
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_oracle_on_rfc8032(sk, pk, msg, sig):
    sk, pk, msg, sig = (bytes.fromhex(x) for x in (sk, pk, msg, sig))
    assert ed25519.public_key(sk) == pk
    assert ed25519.sign(sk, msg) == sig
    assert ed25519.verify(pk, msg, sig)
    for k in (0, 31, 32, 63):
        bad = bytearray(sig)
        bad[k] ^= 0x01
        assert not ed25519.verify(pk, msg, bytes(bad))
    assert not ed25519.verify(pk, msg + b"x", sig)


def test_lane_kinds_and_labels():
    lanes = signing.sign_lanes(11, "t", 64, 4, 6, 3)
    assert int(np.sum(lanes["kind"] == signing.FLIPPED)) == 6
    assert int(np.sum(lanes["kind"] == signing.MALLEATED)) == 3
    got = [ed25519.verify(lanes["pk"][i].tobytes(), lanes["msg"][i].tobytes(),
                          lanes["sig"][i].tobytes()) for i in range(64)]
    assert got == list(lanes["label"])
    again = signing.sign_lanes(11, "t", 64, 4, 6, 3)
    assert np.array_equal(again["sig"], lanes["sig"])


def test_malleated_lanes_split_the_oracle_from_a_strict_verifier():
    from benchmark.controls import StrictVerifier
    from corda_tpu_torch.crypto.provider import VerifyJob

    lanes = signing.sign_lanes(12, "m", 16, 2, 0, 4)
    jobs = [VerifyJob(lanes["pk"][i].tobytes(), lanes["msg"][i].tobytes(),
                      lanes["sig"][i].tobytes()) for i in range(16)]
    strict = StrictVerifier().verify_batch(jobs)
    assert list(strict) == list(lanes["kind"] == signing.HONEST)
    assert all(lanes["label"])


def test_reference_imports_nothing_of_the_program():
    for path in (core.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & {"corda_tpu_torch", "corda_tpu", "jax",
                                "torch"}, (path, roots)
