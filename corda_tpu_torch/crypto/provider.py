"""Signature-verification providers: the batching seam, on PyTorch/CUDA.

Counterpart of ``corda_tpu/crypto/provider.py``. Everything that checks
signatures goes through a BatchVerifier, so the oracle loop and the
batched device path are interchangeable at every call site.

Providers:
  OracleVerifier -- the pure-Python oracle loop (crypto/ref_ed25519.py),
                    the accept/reject authority; slow by design.
  TorchVerifier  -- the batched device path: host packing, then the
                    SHA-512 challenge kernel and the verify kernel on the
                    card (or their plain PyTorch versions on device="cpu"),
                    with optional shadow sampling against the oracle.

This slice verifies ed25519 only: a job with any other ``scheme`` tag
rejects. The host tier (OpenSSL / native core), its size crossover and
the degrade/re-probe gate are later slices.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import ref_ed25519


@dataclass(frozen=True)
class VerifyJob:
    """One signature check: does ``sig`` by ``pubkey`` cover ``message``?
    ``scheme`` routes the job; only "ed25519" verifies in this package."""

    pubkey: bytes
    message: bytes
    sig: bytes
    scheme: str = "ed25519"


def _well_formed(job: VerifyJob) -> bool:
    return (job.scheme == "ed25519" and len(bytes(job.pubkey)) == 32
            and len(bytes(job.sig)) == 64)


class BatchVerifier:
    """Interface: verify many independent signatures at once."""

    name = "abstract"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """Returns bool[N]; malformed input rejects (False), never raises."""
        raise NotImplementedError


class OracleVerifier(BatchVerifier):
    """Pure-Python oracle loop: the conformance authority."""

    name = "oracle"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        return np.array([j.scheme == "ed25519" and ref_ed25519.verify(
            bytes(j.pubkey), bytes(j.message), bytes(j.sig)) for j in jobs],
            bool)


def _shadow_check(jobs: Sequence[VerifyJob], out: np.ndarray,
                  shadow_rate: float, rng: random.Random) -> None:
    """Re-verify a sample of kernel results on the oracle; a mismatch
    raises RuntimeError (divergence must never be silent)."""
    if shadow_rate <= 0.0:
        return
    for i, job in enumerate(jobs):
        if rng.random() < shadow_rate:
            want = job.scheme == "ed25519" and ref_ed25519.verify(
                bytes(job.pubkey), bytes(job.message), bytes(job.sig))
            if bool(out[i]) != want:
                raise RuntimeError(
                    f"device/oracle verify divergence at index {i}: "
                    f"kernel={bool(out[i])} oracle={want}")


# Warm batch sizes: 513 and 1025 (the JAX package's, which straddle its
# 1024 and 4096 buckets); here they build the kernels and run one launch
# of each path before traffic arrives.
WARM_SIZES = (513, 1025)


class _Packed:
    """A batch packed for the device: word tensors already on the device,
    the verify function that runs them, and where each lane's answer goes."""

    __slots__ = ("jobs", "good", "tensors", "verify_fn", "n")

    def __init__(self, jobs, good, tensors, verify_fn, n):
        self.jobs = jobs
        self.good = good
        self.tensors = tensors
        self.verify_fn = verify_fn
        self.n = n


class TorchVerifier(BatchVerifier):
    """The batched device verifier.

    device: "cuda" (default; raises if there is no card) or "cpu" (the
    plain PyTorch versions, for tests). shadow_rate: fraction of results
    re-verified on the oracle; a mismatch raises RuntimeError.

    Batches of 32-byte messages (tx ids) pack their raw words and hash on
    the device (SHA-512 challenge kernel, then the verify kernel); other
    batches hash on the host with hashlib and run the verify kernel only.
    The batch is packed to its exact size: the kernels take any N.
    """

    name = "torch"

    def __init__(self, device: str = "cuda", shadow_rate: float = 0.0,
                 rng: random.Random | None = None):
        from ..ops import require_cuda

        self.device = require_cuda(device)
        self.shadow_rate = shadow_rate
        self._rng = rng or random.Random(0)
        self.device_batches = 0

    @property
    def kernel_backend(self) -> str:
        return "cuda" if self.device.type == "cuda" else "torch-cpu"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        packed = self.pack_device(jobs)
        if packed is None:
            return np.zeros(len(jobs), bool)
        return self.verify_packed(packed)

    def pack_device(self, jobs: Sequence[VerifyJob]):
        """Host half of a device batch: pack the well-formed ed25519 jobs
        into word tensors on the device. Returns a handle for
        :meth:`verify_packed`, or None when no job is well-formed (every
        answer is then False). The sidecar packs batch N+1 here while batch
        N runs."""
        from ..ops import ed25519 as ted

        jobs = list(jobs)
        good = [i for i, j in enumerate(jobs) if _well_formed(j)]
        if not good:
            return None
        verify_fn, arrays, n = ted._precompute_auto(
            [jobs[i].pubkey for i in good], [jobs[i].message for i in good],
            [jobs[i].sig for i in good], len(good))
        tensors = tuple(ted.words_to_tensor(w, self.device) for w in arrays)
        return _Packed(jobs, good, tensors, verify_fn, n)

    def verify_packed(self, packed: _Packed) -> np.ndarray:
        """Run a packed batch on the device -> bool[len(jobs)]."""
        lanes = packed.verify_fn(*packed.tensors)[:packed.n].cpu().numpy()
        self.device_batches += 1
        out = np.zeros(len(packed.jobs), bool)
        out[packed.good] = lanes
        _shadow_check(packed.jobs, out, self.shadow_rate, self._rng)
        return out

    def warm(self) -> None:
        """Build the kernels and run both paths once (raises on failure).
        On the CPU there is nothing to build, and nothing runs."""
        if self.device.type != "cuda":
            return
        for n in WARM_SIZES:
            self.verify_batch([VerifyJob(bytes(32), bytes(32), bytes(64))] * n)
            self.verify_batch([VerifyJob(bytes(32), b"", bytes(64))])


def make_verifier(kind: str, device: str = "cuda") -> BatchVerifier:
    """Provider factory: torch | torch-shadow | oracle. Unknown names
    raise: a typo must not silently swap the notary's verifier."""
    if kind == "torch":
        return TorchVerifier(device=device)
    if kind == "torch-shadow":
        return TorchVerifier(device=device, shadow_rate=0.05)
    if kind == "oracle":
        return OracleVerifier()
    raise ValueError(
        f"unknown verifier {kind!r}: expected torch | torch-shadow | oracle")
