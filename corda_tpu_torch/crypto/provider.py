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
  TorchMeshVerifier -- TorchVerifier over several devices: each batch's
                    lanes cut into equal slices, one launch of each kernel
                    a device (ops/sharded.py).

Mixed-scheme batches split by ``VerifyJob.scheme``: ed25519 jobs take the
provider's batched path, ecdsa-p256 jobs verify on the host
(crypto/fast_ecdsa_p256.py, oracle-exact), unknown schemes reject; the
answers recombine in input order.

Packing: a device batch of ed25519 jobs is packed by one native pass over
the job objects (native/_cverify.c ``pack_jobs``), which applies the
``good`` filter and writes the well-formed jobs' words into a host buffer
kept per thread (pinned on a card), copied to each device once. A batch
the pass does not take packs from lists: an all-ed25519 batch whose data
the pass cannot read (a field that is not bytes, bytearray or memoryview;
a message that is not 32 bytes, hashed on the host) whole, a batch that
mixes schemes after the scheme split. ``PACKS`` counts the packed batches
by path, ``PASS_THREADS`` the threads each batch of the pass ran on: it
reads a batch of slotted VerifyJobs by offset, spread over the calling
thread's cores.

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


@dataclass(frozen=True, slots=True)
class VerifyJob:
    """One signature check: does ``sig`` by ``pubkey`` cover ``message``?
    ``scheme`` routes the job: "ed25519" (every ledger signature) or
    "ecdsa-p256" (host path); any other scheme rejects. Slotted: the
    native pass reads each field at its fixed offset, off the calling
    thread."""

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
    re-probe) and the host/device batch counters. A device batch is packed
    whole where the subclass packs (``_pack``, run by its
    ``verify_packed``); any other batch splits by scheme, its ed25519 jobs
    routed again and run by ``_verify_ed25519_device`` (no routing, no
    counting). Subclasses implement that and ``warm``."""

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
        if not self._routes_to_host(len(jobs)):
            packed = self._pack(jobs)
            if packed is not None:
                return self.verify_packed(packed)
        return _dispatch_mixed(jobs, self._verify_ed25519)

    def pack_device(self, jobs: Sequence[VerifyJob]):
        """Host half of a device batch, routed exactly like verify_batch,
        for a caller that runs it later: the sidecar packs batch N+1 here
        while batch N runs. Returns a handle for ``verify_packed``, or None
        when the batch would not take that route (the crossover or the gate
        says host, the batch mixes schemes, no job is well-formed, or this
        verifier packs nothing); the caller then calls verify_batch, which
        routes the same way."""
        jobs = list(jobs)
        if not jobs or self._routes_to_host(len(jobs)):
            return None
        packed = self._pack(jobs)
        return packed if packed is not None and packed.n else None

    def _pack(self, jobs: Sequence[VerifyJob]):
        """A whole device batch packed for ``verify_packed``, or None when
        it takes the scheme split; here always None."""
        return None

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


# Batches packed for a TorchVerifier's device path, by the path that packed
# them: the native pass over the job objects, or the lists (mixed schemes,
# the host-hash path, fields that are not bytes, no native core).
PACKS = {"single_pass": 0, "fallback": 0}

# The batches the native pass packed, and the threads it ran them on, in
# sum: one thread a batch read by attribute or too small to split, else up
# to the cores of the calling thread's affinity mask.
PASS_THREADS = {"batches": 0, "threads": 0}


class _Packed:
    """A batch packed for the device: each device's four word tensors (one
    column slice of the lanes a device, in mesh order), the verify function
    that runs them, where each lane's answer goes (``good``: lane k answers
    job ``good[k]``), the real lanes ``n`` and the lanes dispatched
    (``lanes``: ``n`` padded to a multiple of the device count). ``n`` 0:
    no job is well-formed, nothing is on a device."""

    __slots__ = ("jobs", "good", "tensors", "verify_fn", "n", "lanes")

    def __init__(self, jobs, good, tensors=(), verify_fn=None, n=0, lanes=0):
        self.jobs = jobs
        self.good = good
        self.tensors = tensors
        self.verify_fn = verify_fn
        self.n = n
        self.lanes = lanes

    @property
    def n_devices(self) -> int:
        return len(self.tensors)


class TorchVerifier(DeviceRoutedVerifier):
    """The batched device verifier.

    device: "cuda" (default; raises if there is no card) or "cpu" (the
    plain PyTorch versions, for tests). shadow_rate: fraction of device
    results re-verified on the oracle; a mismatch raises RuntimeError.
    device_min_sigs: the size crossover (DEVICE_MIN_SIGS_DEFAULT).

    A device batch of ed25519 jobs is packed whole: by the native pass
    where it takes the batch, else from lists. A batch that mixes schemes
    takes the scheme split after the pass refused it, its ed25519 jobs
    packed from lists. Batches of 32-byte messages (tx ids) hash on the
    device (SHA-512 challenge kernel, then the verify kernel); other
    batches hash on the host with hashlib and run the verify kernel only.
    The lanes are the well-formed jobs, padded only to a multiple of the
    device count (none here): the kernels take any N.
    """

    name = "torch"

    def __init__(self, device: str = "cuda", shadow_rate: float = 0.0,
                 rng: random.Random | None = None,
                 device_min_sigs: int = DEVICE_MIN_SIGS_DEFAULT):
        from ..ops import require_cuda

        super().__init__(shadow_rate=shadow_rate, rng=rng,
                         device_min_sigs=device_min_sigs)
        self._mesh = (require_cuda(device),)
        # Each thread's host buffer for the native pass (``words``: int32,
        # 32 words a lane, pinned on a card), grown to the largest batch
        # the thread has packed: the sidecar packs on one thread while its
        # executor runs the batch before on another.
        self._host = threading.local()

    @property
    def mesh(self) -> tuple:
        """The devices, in slice order: here the one device."""
        return self._mesh

    @property
    def device(self):
        """The mesh's first device (its type is every device's)."""
        return self.mesh[0]

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

    def _pack(self, jobs: Sequence[VerifyJob]) -> _Packed | None:
        """The whole batch on the devices: by the native pass where it
        takes the batch, else from lists when every job is ed25519. None
        for a batch that mixes schemes: the split packs its ed25519 jobs
        from lists, without a second pass."""
        packed = self._single_pass(jobs)
        if packed is None and all(j.scheme == "ed25519" for j in jobs):
            packed = self._pack_lists(jobs)
        return packed

    def _single_pass(self, jobs: Sequence[VerifyJob]) -> _Packed | None:
        """The native pass over ``jobs`` into this thread's host buffer
        (grown first if the batch is larger than any before), its lanes
        then placed on the devices; records provider_pack and
        provider_copy_in inside a traced call. None when there is no
        native core or the pass does not take the batch."""
        from .. import native
        from ..ops import ed25519 as ted

        trace = getattr(_current, "trace", None)
        with _range(trace, "provider_pack"):
            t0 = time.time()
            core = native.load_cverify()
            if core is None:
                return None
            host = self._host
            words = getattr(host, "words", None)
            if words is None or words.numel() < 32 * len(jobs):
                import torch

                words = torch.empty(32 * len(jobs), dtype=torch.int32,
                                    pin_memory=self.device.type == "cuda")
                host.words, host.view = words, words.numpy()
            found = core.pack_jobs(jobs, host.view)
            t1 = time.time()
        if found is None:
            return None
        n, held, threads = found
        PACKS["single_pass"] += 1
        PASS_THREADS["batches"] += 1
        PASS_THREADS["threads"] += threads
        good = (range(len(jobs)) if held is None else np.delete(
            np.arange(len(jobs)), np.frombuffer(held, np.int64)))
        if not n:
            return _Packed(jobs, good)
        with _range(trace, "provider_copy_in"):
            tensors, lanes = self._place(host.words[:32 * n].view(4, 8, n), n)
            t2 = time.time()
        self._record_pack(trace, t0, t1, t2)
        return _Packed(jobs, good, tensors, ted.verify_arrays_hashed, n, lanes)

    def _pack_lists(self, jobs: Sequence[VerifyJob]) -> _Packed:
        """The well-formed jobs of an ed25519 batch on the devices, packed
        from lists: a batch the pass refused for its data (a field that is
        not bytes-like, a message that is not 32 bytes, no native core), or
        the ed25519 jobs of a batch that mixes schemes. Records
        provider_pack and provider_copy_in inside a traced call."""
        import torch

        from ..ops import ed25519 as ted
        from ..ops import sharded

        PACKS["fallback"] += 1
        trace = getattr(_current, "trace", None)
        with _range(trace, "provider_pack"):
            t0 = time.time()
            good = [i for i, j in enumerate(jobs)
                    if len(j.pubkey) == 32 and len(j.sig) == 64]
            if not good:
                return _Packed(jobs, good)
            verify_fn, arrays, n = ted._precompute_auto(
                [jobs[i].pubkey for i in good],
                [jobs[i].message for i in good],
                [jobs[i].sig for i in good],
                sharded.pad_to_devices(len(good), len(self.mesh)))
            t1 = time.time()
        with _range(trace, "provider_copy_in"):
            words = torch.from_numpy(np.stack(arrays).view(np.int32))
            tensors, lanes = self._place(words, n)
            t2 = time.time()
        self._record_pack(trace, t0, t1, t2)
        return _Packed(jobs, good, tensors, verify_fn, n, lanes)

    def _place(self, words, n: int):
        """(4, 8, >= n) int32 host words whose first ``n`` lanes are real
        -> (each device's four (8, lanes / D) word tensors in mesh order,
        lanes): the lanes padded with zero words to
        ``sharded.pad_to_devices(n, D)``, cut into one column slice a
        device, and each slice on its device when this returns, so the
        next pack may reuse the host buffer."""
        from ..ops import sharded

        mesh = self.mesh
        lanes = sharded.pad_to_devices(n, len(mesh))
        if words.shape[2] < lanes:
            padded = words.new_zeros(4, 8, lanes)
            padded[..., :n] = words[..., :n]
            words = padded
        per = lanes // len(mesh)
        return [words[..., k * per:(k + 1) * per].to(dev, copy=True).unbind()
                for k, dev in enumerate(mesh)], lanes

    @staticmethod
    def _record_pack(trace, t0: float, t1: float, t2: float) -> None:
        if trace is not None:
            _obs.VERIFY.record("provider_pack", t0, t1,
                               trace_id=trace.trace_id, parent=trace.span_id)
            _obs.VERIFY.record("provider_copy_in", t1, t2,
                               trace_id=trace.trace_id, parent=trace.span_id)

    def verify_packed(self, packed: _Packed) -> np.ndarray:
        """Run a handle from :meth:`pack_device` -> bool[len(jobs)]; counts
        as a device batch (routing was decided at pack time) and draws its
        shadow sample."""
        self.device_batches += 1
        out = self._run(packed)
        _shadow_check(packed.jobs, out, self.shadow_rate, self._rng)
        return out

    def _verify_ed25519_device(self, jobs: Sequence[VerifyJob]) -> np.ndarray:
        """The ed25519 jobs of a batch that mixes schemes (and the
        re-probe's), packed from lists."""
        return self._run(self._pack_lists(jobs))

    def _run(self, packed: _Packed) -> np.ndarray:
        """Launch a packed batch on every device before reading any, then
        read the answers back in mesh order (ops/sharded.py's rule);
        records provider_device_wait inside a traced call. A handle with
        no well-formed lane answers False without a launch."""
        if not packed.n:
            return np.zeros(len(packed.jobs), bool)
        from ..ops import sharded

        trace = getattr(_current, "trace", None)
        with _range(trace, "provider_device_wait"):
            t0 = time.time()
            lanes = sharded._gather(sharded._launch(
                packed.verify_fn, packed.tensors))[:packed.n]
            t1 = time.time()
        if trace is not None:
            _obs.VERIFY.record("provider_device_wait", t0, t1,
                               trace_id=trace.trace_id, parent=trace.span_id)
            trace.ran = True
        if packed.n == len(packed.jobs):
            return lanes
        out = np.zeros(len(packed.jobs), bool)
        out[packed.good] = lanes
        return out

    def warm(self) -> None:
        """Build the mesh (raising if the host cannot) and, on cards, the
        kernels, running both paths once on every device, bypassing the
        routing. On the CPU there is nothing to build, and nothing runs."""
        if self.device.type != "cuda":
            return
        for n in WARM_SIZES:
            self._run(self._pack(
                [VerifyJob(bytes(32), bytes(32), bytes(64))] * n))
            self._run(self._pack([VerifyJob(bytes(32), b"", bytes(64))]))


class TorchMeshVerifier(TorchVerifier):
    """TorchVerifier over several devices: each batch's lanes padded to a
    multiple of the device count and cut into equal column slices, one a
    device; every device runs one launch of the challenge kernel and of
    the verify kernel on its slice before any answer is read
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
        super().__init__(devices[0] if devices else "cuda", shadow_rate,
                         rng, device_min_sigs)
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
    def kernel_backend(self) -> str:
        """Read without building the mesh: a mesh of cards unless the
        devices were named."""
        if self._devices is None:
            return "cuda"
        import torch

        cpu = torch.device(self._devices[0]).type == "cpu"
        return "torch-cpu" if cpu else "cuda"


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
