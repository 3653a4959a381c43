"""The port's verify_stream on the CPU (the plain versions) against the
oracle and the JAX package's verify_stream.

Batches of 5, 9 and 3 signatures with valid and tampered rows, as in
tests/test_ed25519_jax.py's stream test, at depths 1 and 2; tx-id batches
take the device-hashed path. Results come back per batch and in order, at
most depth + 1 batches are taken from the input before the first result
is yielded, and malformed input raises as the packers do. Integer outputs:
tolerance 0.
"""

import pytest
import torch

from corda_tpu.ops import ed25519_jax as jed
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import ed25519 as ted


def _batches(txid: bool):
    batches, expects = [], []
    for b, size in enumerate((5, 9, 3)):
        pks, msgs, sigs, expect = [], [], [], []
        for i in range(size):
            sk = bytes([b * 16 + i + 1]) * 32
            m = b"stream-%d-%d" % (b, i)
            if txid:
                m = m.ljust(32, b"#")
            s = ref.sign(sk, m)
            ok = (i + b) % 3 != 2
            if not ok:
                s = s[:7] + bytes([s[7] ^ 0x20]) + s[8:]
            pks.append(ref.public_key(sk))
            msgs.append(m)
            sigs.append(s)
            expect.append(ok)
        batches.append((pks, msgs, sigs))
        expects.append(expect)
    return batches, expects


BATCHES, EXPECTS = _batches(txid=False)


@pytest.fixture(scope="module")
def jax_outs():
    return [o.tolist() for o in jed.verify_stream(iter(BATCHES), bucket=16,
                                                  depth=2)]


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_matches_oracle_and_jax(depth, jax_outs):
    outs = list(ted.verify_stream(iter(BATCHES), device="cpu", depth=depth))
    assert all(o.dtype == bool for o in outs)
    assert [o.tolist() for o in outs] == EXPECTS == jax_outs
    assert EXPECTS == [[ref.verify(*t) for t in zip(*b)] for b in BATCHES]


def test_stream_of_tx_ids_takes_the_device_hashed_path(monkeypatch):
    batches, expects = _batches(txid=True)
    hashed = []
    real = ted.verify_arrays_hashed
    monkeypatch.setattr(ted, "verify_arrays_hashed",
                        lambda *w: hashed.append(w[0].shape[1]) or real(*w))
    outs = list(ted.verify_stream(batches, device="cpu", depth=2))
    assert [o.tolist() for o in outs] == expects
    assert hashed == [5, 9, 3]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_holds_at_most_depth_plus_one_batches(depth):
    pulled = []

    def source():
        for k in range(6):
            pulled.append(k)
            yield [], [], []  # empty batches: nothing to launch

    stream = ted.verify_stream(source(), device="cpu", depth=depth)
    first = next(stream)
    assert first.shape == (0,) and first.dtype == bool
    assert len(pulled) == depth + 1
    assert len(list(stream)) == 5 and len(pulled) == 6


def test_stream_rejects_malformed_like_the_packer():
    pks, msgs, sigs = BATCHES[0]
    tx = [m.ljust(32, b"#") for m in msgs]
    bad = [(pks[:1] + [pks[1][:31]] + pks[2:], tx, sigs)]
    with pytest.raises(ValueError) as want:
        ted.precompute_batch_device(*bad[0])
    with pytest.raises(ValueError) as got:
        list(ted.verify_stream(bad, device="cpu"))
    assert str(got.value) == str(want.value) == "pubkeys must be 32 bytes"


def test_stream_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        next(ted.verify_stream(iter(BATCHES)))
