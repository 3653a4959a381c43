"""The port's columnar batch signing (corda_tpu_torch/crypto/batch_sign.py
over the port's native ``sign_many``), held to the JAX package's native
core and batch_sign, to the port's fast_ed25519 and to the oracle: Ed25519
signing is deterministic, so every path gives the same 64 bytes. Builders
signed in one batch serialize byte-identically to per-builder sign_with,
in the port and across the packages. Exact comparisons.
"""

import random

import pytest

from corda_tpu import native as jnative
from corda_tpu.crypto import batch_sign as jbatch
from corda_tpu_torch import native
from corda_tpu_torch.crypto import batch_sign, fast_ed25519, provider
from corda_tpu_torch.crypto import ref_ed25519 as ref


def _jobs(n: int, seed: int = 0):
    rng = random.Random(seed)
    return ([rng.randbytes(32) for _ in range(n)],
            [rng.randbytes(32) for _ in range(n)])


@pytest.fixture(scope="module")
def cores():
    core, jcore = native.load_cverify(), jnative.load_cverify()
    if core is None or jcore is None:
        pytest.skip("no native core on this host (gcc or libcrypto missing)")
    return core, jcore


# 1 and 4 run on one thread; 64 (PAR_MIN) and 300 fan out over threads.
@pytest.mark.parametrize("n", [1, 4, 64, 300])
def test_sign_many_byte_equal_to_jax_core_and_oracle(cores, n):
    core, jcore = cores
    seeds, msgs = _jobs(n, seed=n)
    packed = batch_sign.pack_jobs(seeds, msgs)
    sigs = core.sign_many(*packed)
    assert len(sigs) == 64 * n
    assert sigs == jcore.sign_many(*packed)
    want = [ref.sign(s, m) for s, m in zip(seeds[:8], msgs[:8])]
    assert [sigs[64 * i:64 * i + 64] for i in range(min(n, 8))] == want


def test_sign_many_rejects_ragged_buffers(cores):
    core, _ = cores
    with pytest.raises(ValueError, match="multiples of 32"):
        core.sign_many(bytes(32), bytes(31))
    with pytest.raises(ValueError, match="multiples of 32"):
        core.sign_many(bytes(33), bytes(33))
    assert core.sign_many(b"", b"") == b""


@pytest.mark.parametrize("n", [0, 1, 17, 200])
def test_sign_batch_equal_to_fast_ed25519_and_jax(n):
    seeds, msgs = _jobs(n, seed=100 + n)
    got = batch_sign.sign_batch(seeds, msgs)
    assert got == [fast_ed25519.sign(s, m) for s, m in zip(seeds, msgs)]
    assert got == jbatch.sign_batch(seeds, msgs)
    ok = provider.CpuVerifier().verify_batch(
        [provider.VerifyJob(fast_ed25519.public_key(s), m, g)
         for s, m, g in zip(seeds, msgs, got)])
    assert len(ok) == n and ok.all()


def test_sign_batch_ineligible_jobs_sign_one_by_one():
    seeds, msgs = _jobs(5, seed=9)
    msgs[2] = b"a message that is not 32 bytes long"
    assert batch_sign.pack_jobs(seeds, msgs) is None
    got = batch_sign.sign_batch(seeds, msgs)
    assert got == [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    with pytest.raises(ValueError, match="mismatch"):
        batch_sign.sign_batch(seeds, msgs[:4])


def test_sign_batch_without_the_native_core_is_byte_identical(monkeypatch):
    seeds, msgs = _jobs(70, seed=11)
    want = batch_sign.sign_batch(seeds, msgs)
    monkeypatch.setattr(batch_sign, "_native", lambda: None)
    assert batch_sign.sign_batch(seeds, msgs) == want


def _builders(pkg: str, n: int, width: int):
    """n (issue, move) builder pairs in the ingest firehose's shape, built
    in ``pkg`` ("port" or "jax") from fixed seeds, with their key lists."""
    if pkg == "port":
        from corda_tpu_torch.contracts.structures import Command
        from corda_tpu_torch.crypto.keys import KeyPair
        from corda_tpu_torch.crypto.party import Party
        from corda_tpu_torch.testing.dummies import (DummyCreate, DummyMove,
                                                     DummyMultiOwnerState)
        from corda_tpu_torch.transactions.builder import TransactionBuilder
    else:
        from corda_tpu.contracts.structures import Command
        from corda_tpu.crypto.keys import KeyPair
        from corda_tpu.crypto.party import Party
        from corda_tpu.testing.dummies import (DummyCreate, DummyMove,
                                               DummyMultiOwnerState)
        from corda_tpu.transactions.builder import TransactionBuilder
    notary = Party.of("Notary", KeyPair.generate(b"\x51" * 32).public)
    issuer = KeyPair.generate(b"\x52" * 32)
    keys = [KeyPair.generate(bytes([0x60 + i]) * 32) for i in range(width)]
    owners = tuple(k.public.composite for k in keys)
    issues, moves = [], []
    for i in range(n):
        issue = TransactionBuilder(notary=notary)
        issue.add_output_state(DummyMultiOwnerState(i, owners))
        issue.add_command(Command(DummyCreate(), (issuer.public.composite,)))
        move = TransactionBuilder(notary=notary)
        move.add_input_state(issue._wire_cached().out_ref(0))
        move.add_command(Command(DummyMove(), owners))
        move.add_output_state(DummyMultiOwnerState(i + n, owners))
        issues.append(issue)
        moves.append(move)
    return issues + moves, [(issuer,)] * n + [tuple(keys)] * n


def _blob(pkg, builder):
    if pkg == "port":
        from corda_tpu_torch.serialization.codec import serialize
    else:
        from corda_tpu.serialization.codec import serialize
    return serialize(builder.to_signed_transaction(
        check_sufficient_signatures=False)).bytes


@pytest.mark.parametrize("width", [1, 4])
def test_sign_builders_byte_identical_to_sign_with_and_jax(width):
    per_item, keys = _builders("port", 2, width)
    for b, ks in zip(per_item, keys):
        for k in ks:
            b.sign_with(k)
    batched, keys = _builders("port", 2, width)
    assert batch_sign.sign_builders(batched, keys) == 2 * (1 + width)
    jax_batched, jkeys = _builders("jax", 2, width)
    jbatch.sign_builders(jax_batched, jkeys)
    for a, b, j in zip(per_item, batched, jax_batched):
        assert _blob("port", a) == _blob("port", b) == _blob("jax", j)
    # A key that already signed is skipped, as sign_with's guard skips it.
    assert batch_sign.sign_builders(batched, keys) == 0
