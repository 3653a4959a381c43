"""Columnar batch Ed25519 signing: the ingest mirror of the verify plane.

The port's own copy of ``corda_tpu/crypto/batch_sign.py``. A whole corpus
of (seed, message) jobs packs into two contiguous n*32-byte buffers and
signs in ONE native call with the GIL released (``_cverify.sign_many``,
pthread fan-out), instead of one ``fast_ed25519.sign`` call a signature.

Byte-identity: RFC 8032 signing is deterministic, so libcrypto's output is
byte-identical to ``fast_ed25519.sign`` and to the ``ref_ed25519`` oracle.
When the native core is unavailable (no compiler or no libcrypto), or a
seed or message is not 32 bytes, jobs sign through ``fast_ed25519.sign``
one by one: the same bytes, slower. Signing runs on the host.
"""

from __future__ import annotations

from . import fast_ed25519


def _native():
    """The native ``sign_many``, or None without the native core."""
    from ..native import load_cverify

    core = load_cverify()
    return None if core is None else core.sign_many


def pack_jobs(seeds, msgs) -> "tuple[bytes, bytes] | None":
    """Columnar packing: (seeds, msgs) job lists -> two contiguous
    n*32-byte buffers (lane i at byte offset 32*i). Returns None when any
    job is ineligible for the fixed-width native path (seed or message not
    exactly 32 bytes): such batches sign one by one, never from a
    truncated buffer."""
    if any(len(s) != 32 for s in seeds) or any(len(m) != 32 for m in msgs):
        return None
    return b"".join(bytes(s) for s in seeds), b"".join(
        bytes(m) for m in msgs)


def sign_batch(seeds, msgs) -> list[bytes]:
    """Sign N (seed, message) jobs columnar; returns N 64-byte signatures
    in job order, byte-identical to calling fast_ed25519.sign per job.

    A native failure (or ineligible job shapes) re-signs on the Python
    path: deterministic signing makes it byte-identical, so a batch can
    never carry a wrong signature."""
    if len(seeds) != len(msgs):
        raise ValueError(
            f"sign_batch length mismatch: {len(seeds)} seeds, "
            f"{len(msgs)} msgs")
    n = len(seeds)
    if n == 0:
        return []
    native = _native()
    if native is not None:
        packed = pack_jobs(seeds, msgs)
        if packed is not None:
            try:
                sigs = native(packed[0], packed[1])
                return [sigs[64 * i:64 * i + 64] for i in range(n)]
            except ValueError:
                pass  # malformed batch or libcrypto fault: Python re-sign
    return [fast_ed25519.sign(seeds[i], msgs[i]) for i in range(n)]


def sign_builders(builders, keypairs_per_builder) -> int:
    """Batch-sign a corpus of TransactionBuilders: ONE columnar sign over
    every (builder, key) job, then attach the signatures in exactly the
    order a per-builder ``sign_with`` loop would, so the resulting
    SignedTransactions are byte-identical to the per-transaction path.

    ``keypairs_per_builder`` is a parallel sequence: builders[i] is signed
    by every KeyPair in keypairs_per_builder[i], in order. Returns the
    number of signatures attached."""
    from .keys import DigitalSignature

    seeds: list[bytes] = []
    msgs: list[bytes] = []
    slots: list = []  # (builder, keypair) parallel to the job arrays
    for builder, keys in zip(builders, keypairs_per_builder):
        # Builds the wire form (its Merkle id) as sign_with does; the skip
        # below mirrors sign_with's "already signed by this key" guard.
        msg = builder._wire_cached().id.bytes
        for kp in keys:
            if any(s.by == kp.public for s in builder.current_sigs):
                continue
            seeds.append(kp.private.seed)
            msgs.append(msg)
            slots.append((builder, kp))
    sigs = sign_batch(seeds, msgs)
    for (builder, kp), sig in zip(slots, sigs):
        builder.current_sigs.append(
            DigitalSignature.WithKey(bytes=sig, by=kp.public))
    return len(slots)
