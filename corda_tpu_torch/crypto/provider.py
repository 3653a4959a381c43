"""Signature-verification providers: the batching seam, on PyTorch/CUDA.

Counterpart of ``corda_tpu/crypto/provider.py``. Everything that checks
signatures goes through a BatchVerifier, so the oracle loop, the host tier
and the batched device path are interchangeable at every call site.

Providers:
  OracleVerifier -- the pure-Python oracle loop (crypto/ref_ed25519.py,
                    crypto/ref_ecdsa_p256.py), the accept/reject authority;
                    slow by design.
  CpuVerifier    -- the host tier: the native libcrypto core
                    (native/_cverify.c, GIL released) accepts fast, and
                    every reject is re-checked through fast_ed25519 (OpenSSL,
                    then the oracle), so its accept set is the oracle's.
  TorchVerifier  -- the batched device path: host packing, then the
                    SHA-512 challenge kernel and the verify kernel on the
                    card (or their plain PyTorch versions on device="cpu"),
                    with optional shadow sampling against the oracle. Small
                    batches, and every batch while the device gate is
                    closed, take the host tier (DeviceRoutedVerifier).
  TorchMeshVerifier -- the same path over several devices: each batch
                    split into equal slices, one launch of each kernel a
                    device (ops/sharded.py).

Mixed-scheme batches split by ``VerifyJob.scheme``: ed25519 jobs take the
provider's batched path, ecdsa-p256 jobs verify on the host
(crypto/fast_ecdsa_p256.py, oracle-exact), unknown schemes reject; the
answers recombine in input order.

Spans: while the torch profiler collects, every TorchVerifier.verify_batch
call that takes the device records four spans into ``obs.trace.VERIFY``
(obs/stages.py PROVIDER_SPANS), under one trace id: provider_verify over
the whole call, and under it provider_pack, provider_copy_in and
provider_device_wait. Each also opens a ``record_function`` of its name, so
the profiler's timeline names the host's time by the same stages. With the
profiler off nothing is recorded.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..obs import trace as _obs
from . import fast_ed25519, ref_ed25519


@dataclass(frozen=True)
class VerifyJob:
    """One signature check: does ``sig`` by ``pubkey`` cover ``message``?
    ``scheme`` routes the job: "ed25519" (every ledger signature) or
    "ecdsa-p256" (host path); any other scheme rejects."""

    pubkey: bytes
    message: bytes
    sig: bytes
    scheme: str = "ed25519"


def _dispatch_mixed(jobs: Sequence[VerifyJob], ed25519_fn,
                    p256_fn=None) -> np.ndarray:
    """Split a mixed-scheme batch: the ed25519 subset goes to
    ``ed25519_fn`` (each provider's batched path); ecdsa-p256 jobs verify
    through ``p256_fn`` (default: the OpenSSL fast path with oracle-exact
    semantics, crypto/fast_ecdsa_p256.py); unknown schemes reject. Results
    recombine in input order."""
    if p256_fn is None:
        from . import fast_ecdsa_p256

        p256_fn = fast_ecdsa_p256.verify
    out = np.zeros(len(jobs), bool)
    ed_idx = [i for i, j in enumerate(jobs) if j.scheme == "ed25519"]
    if ed_idx:
        out[ed_idx] = ed25519_fn([jobs[i] for i in ed_idx])
    for i, job in enumerate(jobs):
        if job.scheme == "ecdsa-p256":
            out[i] = p256_fn(job.pubkey, job.message, job.sig)
    return out


class BatchVerifier:
    """Interface: verify many independent signatures at once."""

    name = "abstract"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """Returns bool[N]; malformed input rejects (False), never raises."""
        raise NotImplementedError


class CpuVerifier(BatchVerifier):
    """The host tier, with oracle-exact semantics.

    The native libcrypto core (native/_cverify.c) verifies the whole
    ed25519 batch in C with the GIL released. It accepts fast only:
    anything it rejects is re-checked through fast_ed25519 (OpenSSL retry,
    then the authoritative oracle), so the accept set stays the oracle's --
    e.g. S >= L signatures, which OpenSSL rejects and the oracle accepts by
    design. Without a toolchain or libcrypto every job takes fast_ed25519."""

    name = "cpu-openssl"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        return _dispatch_mixed(jobs, self._verify_ed25519_host)

    @staticmethod
    def _verify_ed25519_host(ed: Sequence[VerifyJob]) -> np.ndarray:
        from .. import native

        core = native.load_cverify()
        if core is None:
            return np.array([fast_ed25519.verify(j.pubkey, j.message, j.sig)
                             for j in ed], bool)
        accepted = core.verify_many([j.pubkey for j in ed],
                                    [j.message for j in ed],
                                    [j.sig for j in ed])
        out = np.frombuffer(accepted, np.uint8).astype(bool)
        for i in np.flatnonzero(~out):
            # A native reject is not authoritative: the oracle owns the
            # accept set (rejects are rare on honest traffic).
            out[i] = fast_ed25519.verify(ed[i].pubkey, ed[i].message,
                                         ed[i].sig)
        return out


class OracleVerifier(BatchVerifier):
    """Pure-Python oracle loop: the conformance authority."""

    name = "oracle"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        from . import ref_ecdsa_p256

        return _dispatch_mixed(jobs, lambda ed: np.array(
            [ref_ed25519.verify(bytes(j.pubkey), bytes(j.message),
                                bytes(j.sig)) for j in ed], bool),
            p256_fn=ref_ecdsa_p256.verify)


def _shadow_check(jobs: Sequence[VerifyJob], out: np.ndarray,
                  shadow_rate: float, rng: random.Random) -> None:
    """Re-verify a sample of ed25519 kernel results on the oracle; a
    mismatch raises RuntimeError (divergence must never be silent)."""
    if shadow_rate <= 0.0:
        return
    for i, job in enumerate(jobs):
        if rng.random() < shadow_rate:
            want = ref_ed25519.verify(bytes(job.pubkey), bytes(job.message),
                                      bytes(job.sig))
            if bool(out[i]) != want:
                raise RuntimeError(
                    f"device/oracle verify divergence at index {i}: "
                    f"kernel={bool(out[i])} oracle={want}")


# Below this many ed25519 jobs a batch takes the host tier; 0 sends every
# batch to the device. 4 is the crossover that chip_smoke.py's sweep
# measures on an H100 (PERF.md): the card answers an all-valid tx-id batch
# of 4 faster than the host tier, whose libcrypto verify costs a fraction
# of a millisecond per signature; only a single signature was cheaper on
# the host.
DEVICE_MIN_SIGS_DEFAULT = 4


class DeviceRoutedVerifier(BatchVerifier):
    """Routing shared by device-backed verifiers: the size crossover
    (batches under ``device_min_sigs`` take the host tier), the
    ``device_gate`` (while it is installed and clear, every batch takes the
    host tier: a warm-up in flight, or a degraded device awaiting its
    re-probe) and the host/device batch counters. Subclasses implement
    ``_verify_ed25519_device`` (no routing, no counting) and ``warm``."""

    def __init__(self, shadow_rate: float = 0.0,
                 rng: random.Random | None = None,
                 device_min_sigs: int = DEVICE_MIN_SIGS_DEFAULT):
        self.shadow_rate = shadow_rate
        self._rng = rng or random.Random(0)
        self.device_min_sigs = device_min_sigs
        self.host_batches = 0
        self.device_batches = 0
        self.device_gate: threading.Event | None = None
        # degrade_device bookkeeping: demotions and re-probe outcomes.
        self.degraded = 0
        self.reprobes_ok = 0
        self.reprobes_failed = 0
        self._reprobe_thread: threading.Thread | None = None

    def _routes_to_host(self, n: int) -> bool:
        return n < self.device_min_sigs or (
            self.device_gate is not None and not self.device_gate.is_set())

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        if not jobs:
            return np.zeros(0, bool)
        return _dispatch_mixed(jobs, self._verify_ed25519)

    def _verify_ed25519(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        if self._routes_to_host(len(jobs)):
            # The host tier is oracle-exact by construction: no shadow
            # sampling on this route.
            self.host_batches += 1
            return CpuVerifier._verify_ed25519_host(jobs)
        self.device_batches += 1
        out = self._verify_ed25519_device(jobs)
        _shadow_check(jobs, out, self.shadow_rate, self._rng)
        return out

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        raise NotImplementedError

    def warm(self) -> None:
        """Build and run this verifier's device path, bypassing the
        routing. Blocking and raising: the caller owns gating."""
        raise NotImplementedError


# Warm batch sizes: 513 and 1025 (the JAX package's, which straddle its
# 1024 and 4096 buckets); here they build the kernels and run one launch
# of each path before traffic arrives.
WARM_SIZES = (513, 1025)


class _Trace:
    """One traced device batch in ``obs.trace.VERIFY``: its trace id, the
    id of its provider_verify span (its stages' parent), and whether the
    device answered."""

    __slots__ = ("trace_id", "span_id", "ran")

    def __init__(self):
        self.trace_id = _obs.new_trace_id()
        self.span_id = _obs.new_span_id()
        self.ran = False


# The trace of the verify_batch call running on this thread, which its
# stages below record under; None outside a traced call (profiler off,
# warm-up, re-probe, the sidecar's pack_device / verify_packed).
_current = threading.local()

_NO_RANGE = contextlib.nullcontext()


def _range(trace: _Trace | None, name: str):
    """A ``torch.profiler.record_function`` named after a stage inside a
    traced call, else a no-op."""
    if trace is None:
        return _NO_RANGE
    import torch

    return torch.profiler.record_function(name)


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


class TorchVerifier(DeviceRoutedVerifier):
    """The batched device verifier.

    device: "cuda" (default; raises if there is no card) or "cpu" (the
    plain PyTorch versions, for tests). shadow_rate: fraction of device
    results re-verified on the oracle; a mismatch raises RuntimeError.
    device_min_sigs: the size crossover (DEVICE_MIN_SIGS_DEFAULT).

    Batches of 32-byte messages (tx ids) pack their raw words and hash on
    the device (SHA-512 challenge kernel, then the verify kernel); other
    batches hash on the host with hashlib and run the verify kernel only.
    The batch is packed to its exact size: the kernels take any N.
    """

    name = "torch"

    def __init__(self, device: str = "cuda", shadow_rate: float = 0.0,
                 rng: random.Random | None = None,
                 device_min_sigs: int = DEVICE_MIN_SIGS_DEFAULT):
        from ..ops import require_cuda

        super().__init__(shadow_rate=shadow_rate, rng=rng,
                         device_min_sigs=device_min_sigs)
        self.device = require_cuda(device)

    @property
    def kernel_backend(self) -> str:
        return "cuda" if self.device.type == "cuda" else "torch-cpu"

    def verify_batch(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """DeviceRoutedVerifier.verify_batch; while the torch profiler
        collects, a batch that takes the device also records its
        provider_verify span, over the whole call, and its three stage
        spans under it. A host-routed batch, or one with no well-formed
        job, records nothing."""
        from torch.autograd import _profiler_enabled

        if (not jobs or self._routes_to_host(len(jobs))
                or not _profiler_enabled()):
            return super().verify_batch(jobs)
        import torch

        trace = _Trace()
        with torch.profiler.record_function("provider_verify"):
            t0 = time.time()
            _current.trace = trace
            try:
                out = super().verify_batch(jobs)
            finally:
                _current.trace = None
            t1 = time.time()
        if trace.ran:
            _obs.VERIFY.record("provider_verify", t0, t1,
                               trace_id=trace.trace_id, span_id=trace.span_id)
        return out

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        packed = self._pack(jobs)
        if packed is None:
            return np.zeros(len(jobs), bool)
        return self._run(packed)

    def pack_device(self, jobs: Sequence[VerifyJob]):
        """Host half of a device batch, routed exactly like verify_batch:
        returns None when this batch would not take the device (the size
        crossover or the gate says host, the batch mixes schemes, or no job
        is well-formed); the caller then calls verify_batch, which routes
        the same way. Otherwise packs the well-formed jobs into word tensors
        on the device and returns a handle for :meth:`verify_packed`. The
        sidecar packs batch N+1 here while batch N runs."""
        jobs = list(jobs)
        if (not jobs or self._routes_to_host(len(jobs))
                or any(j.scheme != "ed25519" for j in jobs)):
            return None
        return self._pack(jobs)

    def _pack(self, jobs: Sequence[VerifyJob]) -> _Packed | None:
        """The well-formed jobs' words on the device, recording
        provider_pack and provider_copy_in inside a traced call; None when
        no job is well-formed."""
        from ..ops import ed25519 as ted

        trace = getattr(_current, "trace", None)
        with _range(trace, "provider_pack"):
            t0 = time.time()
            good = [i for i, j in enumerate(jobs)
                    if len(j.pubkey) == 32 and len(j.sig) == 64]
            if not good:
                return None
            verify_fn, arrays, n = ted._precompute_auto(
                [jobs[i].pubkey for i in good],
                [jobs[i].message for i in good],
                [jobs[i].sig for i in good], len(good))
            t1 = time.time()
        with _range(trace, "provider_copy_in"):
            tensors = tuple(ted.words_to_tensor(w, self.device)
                            for w in arrays)
            t2 = time.time()
        if trace is not None:
            _obs.VERIFY.record("provider_pack", t0, t1,
                               trace_id=trace.trace_id, parent=trace.span_id)
            _obs.VERIFY.record("provider_copy_in", t1, t2,
                               trace_id=trace.trace_id, parent=trace.span_id)
        return _Packed(jobs, good, tensors, verify_fn, n)

    def verify_packed(self, packed: _Packed) -> np.ndarray:
        """Run a handle from :meth:`pack_device` -> bool[len(jobs)]; counts
        as a device batch (routing was decided at pack time)."""
        self.device_batches += 1
        out = self._run(packed)
        _shadow_check(packed.jobs, out, self.shadow_rate, self._rng)
        return out

    def _run(self, packed: _Packed) -> np.ndarray:
        """Launch a packed batch and wait for its answers, recording
        provider_device_wait inside a traced call."""
        trace = getattr(_current, "trace", None)
        with _range(trace, "provider_device_wait"):
            t0 = time.time()
            lanes = packed.verify_fn(*packed.tensors)[:packed.n].cpu().numpy()
            t1 = time.time()
        if trace is not None:
            _obs.VERIFY.record("provider_device_wait", t0, t1,
                               trace_id=trace.trace_id, parent=trace.span_id)
            trace.ran = True
        out = np.zeros(len(packed.jobs), bool)
        out[packed.good] = lanes
        return out

    def warm(self) -> None:
        """Build the kernels and run both paths once, bypassing the routing
        (raises on failure). On the CPU there is nothing to build, and
        nothing runs."""
        if self.device.type != "cuda":
            return
        for n in WARM_SIZES:
            self._verify_ed25519_device(
                [VerifyJob(bytes(32), bytes(32), bytes(64))] * n)
            self._verify_ed25519_device(
                [VerifyJob(bytes(32), b"", bytes(64))])


class TorchMeshVerifier(DeviceRoutedVerifier):
    """The batched device verifier over several devices: each batch's lanes
    split into equal slices, one per device, and each device runs one
    launch of the challenge kernel and of the verify kernel on its slice
    (ops/sharded.py). Counterpart of the JAX package's ``MeshVerifier``;
    selectable as ``verifier = "torch-sharded"``.

    The mesh spans every local card by default (``n_devices`` limits it;
    ``devices`` names the devices outright, e.g. ``[torch.device("cpu")] *
    8`` for the plain versions). It is built on first use, and asking for
    more cards than the host has raises there: the port has no host-tier
    fallback for a mesh that cannot be built. With one device the path is
    TorchVerifier's."""

    name = "torch-sharded"

    def __init__(self, n_devices: int | None = None,
                 shadow_rate: float = 0.0,
                 rng: random.Random | None = None,
                 device_min_sigs: int = DEVICE_MIN_SIGS_DEFAULT,
                 devices=None):
        super().__init__(shadow_rate=shadow_rate, rng=rng,
                         device_min_sigs=device_min_sigs)
        if devices is None:
            from ..ops import require_cuda

            require_cuda("cuda")
        self.n_devices = n_devices
        self._devices = devices
        self._mesh = None

    @property
    def mesh(self):
        """The devices, in slice order; built (and checked) on first use."""
        if self._mesh is None:
            from ..ops import sharded

            # lint: allow(no-jit-in-hotpath) lazy one-time constructor: the mesh is built once and memoised on self._mesh; per-batch calls only read the cached object
            self._mesh = sharded.make_mesh(self.n_devices, self._devices)
        return self._mesh

    @property
    def device(self):
        """The mesh's first device (its type is every device's)."""
        return self.mesh[0]

    @property
    def kernel_backend(self) -> str:
        """Read without building the mesh: a mesh of cards unless the
        devices were named."""
        if self._devices is None:
            return "cuda"
        import torch

        cpu = torch.device(self._devices[0]).type == "cpu"
        return "torch-cpu" if cpu else "cuda"

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        from ..ops import sharded

        return sharded.verify_batch_sharded(
            [j.pubkey for j in jobs], [j.message for j in jobs],
            [j.sig for j in jobs], self.mesh)

    def pack_device(self, jobs: Sequence[VerifyJob]):
        """Host half of the mesh dispatch, routed exactly like
        verify_batch: None for a batch that would not take the device (the
        crossover or the gate says host, mixed schemes, nothing
        well-formed); else a handle for :meth:`verify_packed` whose slices
        are already on their devices."""
        jobs = list(jobs)
        if (not jobs or self._routes_to_host(len(jobs))
                or any(j.scheme != "ed25519" for j in jobs)):
            return None
        from ..ops import sharded

        return sharded.pack_batch_sharded(
            [j.pubkey for j in jobs], [j.message for j in jobs],
            [j.sig for j in jobs], self.mesh)

    def verify_packed(self, packed) -> np.ndarray:
        """Launch a handle from :meth:`pack_device` -> bool[packed.n];
        counts as a device batch (routing was decided at pack time)."""
        from ..ops import sharded

        self.device_batches += 1
        return sharded.dispatch_packed(packed)

    def warm(self) -> None:
        """Build the mesh (raising if the host cannot) and, on cards, the
        kernels, running both paths once on every device, bypassing the
        routing."""
        if self.device.type != "cuda":
            return
        for n in WARM_SIZES:
            self._verify_ed25519_device(
                [VerifyJob(bytes(32), bytes(32), bytes(64))] * n)
        self._verify_ed25519_device(
            [VerifyJob(bytes(32), b"", bytes(64))] * len(self.mesh))


def host_verify(jobs: Sequence[VerifyJob]) -> np.ndarray:
    """Verify a batch on the host tier regardless of any verifier's routing
    state -- the degrade path's re-verify (oracle-exact accept set, so a
    batch the device would have accepted is accepted here too)."""
    return _dispatch_mixed(jobs, CpuVerifier._verify_ed25519_host)


def degrade_device(verifier, cooldown_s: float) -> bool:
    """Demote a device-backed verifier to its host tier after a device-path
    failure, and schedule a re-probe that reopens the gate once the device
    answers again.

    Closes (or installs) ``verifier.device_gate`` -- every later batch
    takes the host tier -- then starts a daemon thread that sleeps
    ``cooldown_s``, runs the verifier's own device path on a throwaway
    batch, and sets the gate on success; on failure it keeps the gate
    closed and retries after another cooldown. Returns False (nothing done) for a verifier without a
    device tier. A second call while a re-probe is pending only bumps the
    counter."""
    if getattr(verifier, "device_min_sigs", None) is None:
        return False
    gate = verifier.device_gate
    if gate is None:
        gate = threading.Event()
        verifier.device_gate = gate
    probing = verifier._reprobe_thread
    already_probing = (not gate.is_set() and probing is not None
                       and probing.is_alive())
    gate.clear()
    verifier.degraded += 1
    if already_probing:
        return True

    def _reprobe() -> None:
        # Garbage jobs: the probe needs the device path to answer (all
        # False is fine), not the signatures to validate.
        probe = [VerifyJob(bytes(32), bytes(32), bytes(64))] * max(
            2, verifier.device_min_sigs)
        while not gate.is_set():
            time.sleep(cooldown_s)
            try:
                verifier._verify_ed25519_device(probe)
            except Exception:  # noqa: BLE001 -- counted; the gate stays shut
                verifier.reprobes_failed += 1
                continue
            verifier.reprobes_ok += 1
            gate.set()

    t = threading.Thread(target=_reprobe, daemon=True, name="verify-reprobe")
    verifier._reprobe_thread = t
    t.start()
    return True


_default: BatchVerifier | None = None


def get_verifier() -> BatchVerifier:
    """The process-wide verifier (``SignedTransaction.
    check_signatures_are_valid`` reads it). Defaults to
    ``make_verifier("torch")`` on the card, built on first use; there is
    no environment variable. Install another with :func:`set_verifier`."""
    global _default
    if _default is None:
        _default = make_verifier("torch")
    return _default


def set_verifier(verifier: BatchVerifier | None) -> None:
    """Install a provider (None resets to the default on next use)."""
    global _default
    _default = verifier


def make_verifier(kind: str, device: str = "cuda") -> BatchVerifier:
    """Provider factory: torch | torch-shadow | torch-sharded | cpu |
    oracle. Unknown names raise: a typo must not silently swap the
    notary's verifier. ``torch-sharded`` spans every card, or on
    device="cpu" a mesh of the one CPU device."""
    if kind == "torch":
        return TorchVerifier(device=device)
    if kind == "torch-shadow":
        return TorchVerifier(device=device, shadow_rate=0.05)
    if kind == "torch-sharded":
        return (TorchMeshVerifier() if device == "cuda"
                else TorchMeshVerifier(devices=[device]))
    if kind == "cpu":
        return CpuVerifier()
    if kind == "oracle":
        return OracleVerifier()
    raise ValueError(f"unknown verifier {kind!r}: expected torch | "
                     "torch-shadow | torch-sharded | cpu | oracle")
