"""SignedTransaction: the wire payload plus signatures — and the hot path.

The port's own copy of ``corda_tpu/transactions/signed.py``. Capability
match for the reference's SignedTransaction (reference:
core/src/main/kotlin/net/corda/core/transactions/SignedTransaction.kt). The
reference's checkSignaturesAreValid is a sequential per-signature loop
(SignedTransaction.kt:83-87) — THE notary hot loop this framework re-designs:
here every signature check goes through the pluggable BatchVerifier
(crypto/provider.py, ``TorchVerifier`` on the card by default), so one
transaction's signatures verify as a batch; a caller holding many
transactions (the resolve path) batches all their signatures in one
``verify_batch`` call.

The id is the WireTransaction Merkle root, so adding/removing signatures never
changes identity.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Sequence

from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.keys import DigitalSignature, SignatureError, by_keys
from ..crypto.provider import VerifyJob, get_verifier
from ..serialization.codec import (SerializedBytes, mark_cacheable, register,
                                   serialize)
from .wire import WireTransaction


from ..utils.excheckpoint import register_flow_exception


@register_flow_exception
class SignaturesMissingException(SignatureError):
    """Required signatures absent (SignedTransaction.kt:41-46).

    Survives checkpoint replay with its structure intact so restored flows
    can branch on isinstance / .missing exactly as live ones do.
    """

    def __init__(self, missing: set[CompositeKey], descriptions: list[str], id: SecureHash):
        super().__init__(
            f"Missing signatures for {descriptions} on transaction {id.prefix_chars()} "
            f"for {sorted(missing, key=repr)}"
        )
        self.missing = missing
        self.descriptions = descriptions
        self.id = id

    def __checkpoint_payload__(self):
        return (frozenset(self.missing), tuple(self.descriptions), self.id)

    @classmethod
    def __from_checkpoint__(cls, message, payload):
        missing, descriptions, id = payload
        return cls(set(missing), list(descriptions), id)


@register
@dataclass(frozen=True)
class SignedTransaction:
    """Serialized WireTransaction + signatures over its id."""

    tx_bits: SerializedBytes
    sigs: tuple[DigitalSignature.WithKey, ...]
    id: SecureHash

    def __post_init__(self):
        object.__setattr__(self, "sigs", tuple(self.sigs))
        if not self.sigs:
            raise ValueError("SignedTransaction requires at least one signature")

    @staticmethod
    def of(wtx: WireTransaction, sigs: Sequence[DigitalSignature.WithKey]) -> "SignedTransaction":
        return SignedTransaction(tx_bits=wtx.serialized, sigs=tuple(sigs), id=wtx.id)

    @property
    def tx(self) -> WireTransaction:
        """Deserialized payload; id cross-checked (SignedTransaction.kt:33-37)."""
        cached = getattr(self, "_tx", None)
        if cached is None:
            cached = self.tx_bits.deserialize()
            if cached.id != self.id:
                raise ValueError(
                    "Supplied transaction ID does not match deserialized transaction's ID"
                )
            object.__setattr__(self, "_tx", cached)
        return cached

    @staticmethod
    def prime_ids(stxs: "Sequence[SignedTransaction]",
                  device_min: int | None = None,
                  device: str = "cuda") -> str:
        """Batch the id cross-check of many payloads: every component leaf
        of every transaction hashes in ONE bulk call (ops/sha256.py's
        hash_many_auto: the SHA-256 kernel on ``device`` at or above
        ``device_min`` messages, hashlib below), and the per-object caches
        are seeded so later .tx / .id accesses are hits. Semantics are
        identical to touching .tx one transaction at a time, including the
        mismatch ValueError.

        This is the batched form of the reference's per-component hashing
        on the validating-notary resolve path (reference:
        core/.../transactions/MerkleTransaction.kt:26-38 driven by
        ResolveTransactionsFlow.kt:105-111). Returns the hashing backend
        used ("host" | "device").
        """
        from ..ops import sha256

        todo = [stx for stx in stxs if getattr(stx, "_tx", None) is None]
        wtxs = [stx.tx_bits.deserialize() for stx in todo]
        flat, spans = component_blobs(wtxs)
        digests, backend = sha256.hash_many_auto(flat, device_min=device_min,
                                                 device=device)
        seed_and_check_ids(todo, wtxs, spans, digests)
        return backend

    # -- signature verification (the hot path) ----------------------------

    def check_signatures_are_valid(self) -> None:
        """Mathematically validate every attached signature over the tx id.

        The reference loops one signature at a time
        (SignedTransaction.kt:83-87); here the whole set goes to the
        BatchVerifier in one call.
        """
        jobs = [
            VerifyJob(pubkey=sig.by.encoded, message=self.id.bytes, sig=sig.bytes)
            for sig in self.sigs
        ]
        ok = get_verifier().verify_batch(jobs)
        if not all(ok):
            bad = [self.sigs[i].by for i in range(len(jobs)) if not ok[i]]
            raise SignatureError(f"Signature did not match for keys: {bad}")

    def verify_signatures(self, *allowed_to_be_missing: CompositeKey) -> WireTransaction:
        """Check validity AND completeness of signatures
        (SignedTransaction.kt:59-74); returns the verified WireTransaction."""
        self.check_signatures_are_valid()
        missing = self.get_missing_signatures()
        if missing:
            needed = missing - set(allowed_to_be_missing)
            if needed:
                raise SignaturesMissingException(
                    needed, self._missing_key_descriptions(needed), self.id
                )
        if self.tx.id != self.id:
            raise ValueError("id mismatch")
        return self.tx

    def get_missing_signatures(self) -> set[CompositeKey]:
        sig_keys = by_keys(self.sigs)
        return {ck for ck in self.tx.must_sign if not ck.is_fulfilled_by(sig_keys)}

    def _missing_key_descriptions(self, missing: set[CompositeKey]) -> list[str]:
        out = []
        for cmd in self.tx.commands:
            if any(s in missing for s in cmd.signers):
                out.append(str(cmd))
        if self.tx.notary is not None and self.tx.notary.owning_key in missing:
            out.append("notary")
        return out

    # -- composition -------------------------------------------------------

    def with_additional_signature(self, sig: DigitalSignature.WithKey) -> "SignedTransaction":
        return replace(self, sigs=self.sigs + (sig,))

    def with_additional_signatures(
        self, sig_list: Iterable[DigitalSignature.WithKey]
    ) -> "SignedTransaction":
        return replace(self, sigs=self.sigs + tuple(sig_list))

    def __add__(self, sig):
        if isinstance(sig, DigitalSignature.WithKey):
            return self.with_additional_signature(sig)
        return self.with_additional_signatures(sig)

    def to_ledger_transaction(self, services):
        """verify_signatures + resolve dependencies (SignedTransaction.kt:131-137)."""
        return self.verify_signatures().to_ledger_transaction(services)


def component_blobs(wtxs: "Sequence[WireTransaction]"
                    ) -> tuple[list[bytes], list[tuple[int, int]]]:
    """prime_ids' first half: the canonical serialization of every
    component of every transaction, in the id's leaf order, as one flat
    list, and each transaction's [lo, hi) span in it."""
    flat: list[bytes] = []
    spans: list[tuple[int, int]] = []
    for wtx in wtxs:
        comps = [serialize(x).bytes
                 for group in (wtx.inputs, wtx.outputs,
                               wtx.attachments, wtx.commands)
                 for x in group]
        spans.append((len(flat), len(flat) + len(comps)))
        flat.extend(comps)
    return flat, spans


def seed_and_check_ids(stxs: "Sequence[SignedTransaction]",
                       wtxs: "Sequence[WireTransaction]",
                       spans: Sequence[tuple[int, int]],
                       digests: Sequence[bytes]) -> None:
    """prime_ids' second half: seed each payload's leaf hashes, reduce its
    Merkle tree on the host, hold the root to the signed id (the mismatch
    ValueError of .tx) and seed the .tx cache."""
    for stx, wtx, (lo, hi) in zip(stxs, wtxs, spans):
        object.__setattr__(
            wtx, "_leaves", [SecureHash(d) for d in digests[lo:hi]])
        if wtx.id != stx.id:  # tree reduce over the seeded leaves
            raise ValueError(
                "Supplied transaction ID does not match deserialized "
                "transaction's ID"
            )
        object.__setattr__(stx, "_tx", wtx)


# The checkpoint/wire hot object: a flow's SignedTransaction argument was
# re-encoded at every suspension; the instance is deeply immutable, so its
# canonical encoding is memoized (serialization/codec.py mark_cacheable).
mark_cacheable(SignedTransaction)
