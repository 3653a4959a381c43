"""The device provider's native pass (native/_cverify.c ``pack_jobs``, fed
by ``TorchVerifier``): one walk over the ed25519 VerifyJob objects that
applies the ``good`` filter and writes the well-formed jobs' words into a
per-thread host buffer.

Held against the lists it replaces: the words are the numpy packer's, byte
for byte; and on ``TorchVerifier("cpu")`` every batch -- mixed schemes,
malformed keys and signatures, bytearray and memoryview fields, fields the
pass refuses, host-hashed messages -- gives the answers, device and host
batch counts and shadow draws that the list path gives; and
``TorchMeshVerifier`` over 1, 3 and 8 copies of the CPU device is the same
verifier, its lanes padded to the device count. Most cases stand
a fast kernel in for the plain versions: it reads each lane's words back
into bytes and asks the oracle-exact host verifier, so a lane given
another job's words answers wrongly.
"""

import array
import dataclasses
import os
import queue
import random
import sys
import threading

import numpy as np
import pytest
import torch

from corda_tpu_torch import native
from corda_tpu_torch.crypto import fast_ed25519, provider
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import sharded


@pytest.fixture(scope="module")
def core():
    found = native.load_cverify()
    if found is None:
        pytest.skip("no gcc, Python headers or libcrypto on this host: "
                    "there is no pass")
    return found


# Without the native core no batch takes the pass: nothing to compare.
pytestmark = pytest.mark.usefixtures("core")

_KEYS: dict = {}


def _ed(i, msg_len=32, ok=True):
    """(pubkey, message, sig) of signer ``i``; ``ok`` False tampers the
    message after signing."""
    seed = bytes([i % 251 + 1]) * 32
    msg = (b"m%d" % i).ljust(msg_len, b".")[:msg_len]
    if seed not in _KEYS:
        _KEYS[seed] = ref.public_key(seed)
    sig = ref.sign(seed, msg)
    if not ok:
        msg = bytes([msg[0] ^ 1]) + msg[1:]
    return _KEYS[seed], msg, sig


def _p256(ok=True):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)

    key = ec.derive_private_key(0x4242, ec.SECP256R1())
    pub = key.public_key().public_bytes(Encoding.X962,
                                        PublicFormat.UncompressedPoint)
    msg = b"a p256 blob"
    sig = key.sign(msg, ec.ECDSA(hashes.SHA256()))
    return provider.VerifyJob(pub, msg if ok else b"other", sig,
                              "ecdsa-p256")


def _random_jobs(n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, 128), np.uint8)
    return [provider.VerifyJob(r[:32].tobytes(), r[32:64].tobytes(),
                               r[64:].tobytes()) for r in raw]


def _reference_words(jobs):
    """The numpy packer's (4, 8, n) int32 words of ``jobs``."""
    arrays, n = ted.precompute_batch_device_numpy(
        [j.pubkey for j in jobs], [j.message for j in jobs],
        [j.sig for j in jobs], len(jobs))
    return np.stack(arrays).view(np.int32)


def _bytes_of(words):
    """(8, n) int32 words -> n little-endian 32-byte strings."""
    raw = words.contiguous().numpy().astype("<u4").T.copy().tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(words.shape[1])]


class FakeKernel:
    """Stands in for ``verify_arrays_hashed``: records the words each call
    gets and answers each lane by verifying the bytes its words spell."""

    def __init__(self):
        self.seen = []

    def __call__(self, a, r, s, m):
        self.seen.append(torch.stack([a, r, s, m]).clone())
        lanes = zip(_bytes_of(a), _bytes_of(r), _bytes_of(s), _bytes_of(m))
        return torch.tensor([fast_ed25519.verify(pk, msg, rr + ss)
                             for pk, rr, ss, msg in lanes], dtype=torch.bool)


class HostHashKernel:
    """Stands in for ``verify_arrays`` (host-hashed words: the fourth
    array is h): records each call's words in ``kernel.seen`` and answers
    each lane by the oracle's group equation on the bytes its words
    spell."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __call__(self, a, r, s, h):
        self.kernel.seen.append(torch.stack([a, r, s, h]).clone())
        out = []
        for pk, rr, ss, hh in zip(_bytes_of(a), _bytes_of(r), _bytes_of(s),
                                  _bytes_of(h)):
            pt = ref.decompress(pk)
            out.append(pt is not None and ref.compress(
                ref.double_scalar_mult_sub(int.from_bytes(ss, "little"),
                                           int.from_bytes(hh, "little"),
                                           pt)) == rr)
        return torch.tensor(out, dtype=torch.bool)


@pytest.fixture
def kernel(monkeypatch):
    fake = FakeKernel()
    monkeypatch.setattr(ted, "verify_arrays_hashed", fake)
    return fake


@pytest.fixture
def packs(monkeypatch):
    counts = {"single_pass": 0, "fallback": 0}
    monkeypatch.setattr(provider, "PACKS", counts)
    return counts


def _verifiers(seed=7, **kw):
    """(the change, the list path), each with its own ``Random(seed)``:
    the list path is the same verifier with the pass switched off, so
    every batch packs from lists."""
    new = provider.TorchVerifier(device="cpu", rng=random.Random(seed), **kw)
    old = provider.TorchVerifier(device="cpu", rng=random.Random(seed), **kw)
    old._single_pass = lambda jobs: None
    return new, old


# -- the pass itself ---------------------------------------------------------

# The pass's two ways through a batch of slotted jobs: on one thread, and
# forced over four (ranges of ceil(n / 4) lanes, each on a thread of its
# own). Every case of this section runs both.
THREADS = pytest.mark.parametrize("threads", [1, 4],
                                  ids=["one_thread", "fanned"])


def _ranges(n, threads):
    """How many threads the offset pass runs ``n`` lanes on when asked
    for ``threads``."""
    chunk = -(-n // min(threads, max(n, 1)))
    return max(1, -(-n // chunk))


@THREADS
@pytest.mark.parametrize("n", [1, 7, 64, 257])
def test_words_equal_the_numpy_packer(n, threads, core):
    jobs = _random_jobs(n, n)
    buf = np.full(32 * n + 5, -1, np.int32)
    assert core.pack_jobs(jobs, buf, threads=threads) == (
        n, None, _ranges(n, threads))
    np.testing.assert_array_equal(buf[:32 * n].reshape(4, 8, n),
                                  _reference_words(jobs))


@THREADS
def test_words_of_a_malformed_batch_close_up_to_the_well_formed_lanes(
        threads, core):
    jobs = _random_jobs(40, 3)
    held = set()
    for i in range(0, 40, 5):
        j = jobs[i]
        jobs[i] = provider.VerifyJob(j.pubkey[:31], j.message, j.sig)
        held.add(i)
    for i in range(2, 40, 9):
        j = jobs[i]
        jobs[i] = provider.VerifyJob(j.pubkey, j.message, j.sig[:63])
        held.add(i)
    good = [j for i, j in enumerate(jobs) if i not in held]
    buf = np.full(32 * 40, -1, np.int32)
    n_good, positions, ran = core.pack_jobs(jobs, buf, threads=threads)
    assert n_good == len(good) and ran == threads
    assert np.frombuffer(positions, np.int64).tolist() == sorted(held)
    np.testing.assert_array_equal(buf[:32 * n_good].reshape(4, 8, n_good),
                                  _reference_words(good))


@THREADS
def test_bytearray_and_memoryview_fields_pack_as_bytes(threads, core):
    """A bytearray or memoryview field sends the batch to the attribute
    pass, on one thread, with the same words."""
    jobs = _random_jobs(6, 9)
    views = [provider.VerifyJob(bytearray(j.pubkey), memoryview(j.message),
                                memoryview(bytearray(j.sig))) for j in jobs]
    a, b = np.zeros(32 * 6, np.int32), np.zeros(32 * 6, np.int32)
    assert core.pack_jobs(jobs, a, threads=threads) == (
        6, None, _ranges(6, threads))
    assert core.pack_jobs(views, b, threads=threads) == (6, None, 1)
    np.testing.assert_array_equal(a, b)


@THREADS
def test_a_malformed_jobs_later_fields_are_not_read(threads, core):
    """A malformed job's fields past the one that rejected it are never
    read: a short key's signature and message may be anything."""
    ok = _random_jobs(1, 5)[0]
    jobs = [provider.VerifyJob(ok.pubkey[:31], None, None), ok,
            provider.VerifyJob(ok.pubkey, None, ok.sig[:10])]
    buf = np.zeros(32 * 3, np.int32)
    n_good, held, _ = core.pack_jobs(jobs, buf, threads=threads)
    assert (n_good, np.frombuffer(held, np.int64).tolist()) == (1, [0, 2])
    np.testing.assert_array_equal(buf[:32].reshape(4, 8, 1),
                                  _reference_words([ok]))


@THREADS
def test_a_bytearray_field_cannot_be_resized_while_it_is_read(threads, core):
    """A later field's getter may run Python code: a bytearray key read
    before it is held by an exported buffer, so resizing it raises in the
    getter, and the pass refuses the batch instead of reading freed
    memory."""
    ok = _random_jobs(1, 6)[0]
    key = bytearray(ok.pubkey)
    resized = []

    class Grows:
        scheme, pubkey, message = "ed25519", key, ok.message

        @property
        def sig(self):
            try:
                key.extend(bytes(1 << 20))
            except BufferError:
                resized.append(False)
                raise
            resized.append(True)
            return ok.sig

    assert core.pack_jobs([Grows()], np.zeros(32, np.int32),
                          threads=threads) is None
    assert resized == [False] and bytes(key) == ok.pubkey


def _refused():
    ok = _random_jobs(1, 11)[0]

    class NoScheme:
        pubkey, message, sig = ok.pubkey, ok.message, ok.sig

    return {
        "str_key": provider.VerifyJob("k" * 32, ok.message, ok.sig),
        "array_key": provider.VerifyJob(array.array("B", ok.pubkey),
                                        ok.message, ok.sig),
        "none_message": provider.VerifyJob(ok.pubkey, None, ok.sig),
        "33_byte_message": provider.VerifyJob(ok.pubkey, ok.message + b"!",
                                              ok.sig),
        "strided_view": provider.VerifyJob(ok.pubkey,
                                           memoryview(ok.message * 2)[::2],
                                           ok.sig),
        "wide_view": provider.VerifyJob(memoryview(ok.pubkey).cast("I"),
                                        ok.message, ok.sig),
        "no_scheme": NoScheme(),
        "p256_job": provider.VerifyJob(ok.pubkey, ok.message, ok.sig,
                                       "ecdsa-p256"),
        "unknown_scheme": provider.VerifyJob(ok.pubkey, ok.message, ok.sig,
                                             "rsa"),
    }


REFUSED = ("array_key", "no_scheme", "none_message", "str_key",
           "strided_view", "wide_view", "33_byte_message", "p256_job",
           "unknown_scheme")


@THREADS
@pytest.mark.parametrize("case", REFUSED)
def test_the_pass_refuses_a_batch_it_cannot_read_exactly(case, threads,
                                                         core):
    jobs = _random_jobs(5, 1) + [_refused()[case]] + _random_jobs(3, 2)
    assert core.pack_jobs(jobs, np.zeros(32 * 9, np.int32),
                          threads=threads) is None


@THREADS
def test_a_list_edited_by_a_field_getter_is_refused(threads, core):
    """A getter may run Python code: a list that shrinks under the pass is
    refused, never read past its end."""
    jobs = _random_jobs(6, 4)

    class Shrinks:
        pubkey, message, sig = jobs[0].pubkey, jobs[0].message, jobs[0].sig

        @property
        def scheme(self):
            del jobs[3:]
            return "ed25519"

    jobs.insert(1, Shrinks())
    assert core.pack_jobs(jobs, np.zeros(32 * 7, np.int32),
                          threads=threads) is None
    assert len(jobs) == 3


@THREADS
def test_the_buffer_must_hold_the_batch(threads, core):
    with pytest.raises(ValueError):
        core.pack_jobs(_random_jobs(3, 1), np.zeros(32 * 2, np.int32),
                       threads=threads)
    with pytest.raises(BufferError):
        core.pack_jobs(_random_jobs(1, 1), bytes(128), threads=threads)
    assert core.pack_jobs([], bytearray(), threads=threads) == (0, None, 1)
    with pytest.raises(ValueError):
        core.pack_jobs(_random_jobs(1, 1), np.zeros(32, np.int32),
                       threads=-1)


# -- the offset pass against the attribute pass --------------------------------


@dataclasses.dataclass(frozen=True)
class DictJob:
    """A VerifyJob without slots: its fields live in the instance's dict,
    so the pass reads it by attribute, as it read every job before the
    job was slotted."""

    pubkey: bytes
    message: bytes
    sig: bytes
    scheme: str = "ed25519"


class PropertySig(provider.VerifyJob):
    """A subclass whose ``sig`` is a property: its type keeps the slots,
    but reading ``sig`` by offset would not be what getattr gives."""

    __slots__ = ()

    @property
    def sig(self):
        return b"\x01" * 64


def _property_sig(job):
    """A PropertySig of ``job``'s fields, each set in its slot (the
    dataclass's __init__ would set ``sig`` through the property)."""
    out = object.__new__(PropertySig)
    for name in ("pubkey", "message", "sig", "scheme"):
        provider.VerifyJob.__dict__[name].__set__(out, getattr(job, name))
    return out


def _unset():
    """A VerifyJob whose slots were never set: reading one raises."""
    return object.__new__(provider.VerifyJob)


def _by_attribute(job):
    """``job`` as the attribute pass reads it: an exact VerifyJob as a
    DictJob of the same fields (an unset one as a DictJob with none),
    any other job as it is."""
    if type(job) is not provider.VerifyJob:
        return job
    try:
        fields = (job.pubkey, job.message, job.sig, job.scheme)
    except AttributeError:
        return object.__new__(DictJob)
    return DictJob(*fields)


class _StrScheme(str):
    pass


def _agreeing():
    """name -> a batch whose offset and attribute passes must agree, and
    the threads its fanned pass runs on (1: the batch is read by
    attribute)."""
    big = _random_jobs(8192, 21)
    edges = _random_jobs(40, 22)
    for i in (9, 10, 19, 29, 30, 39):      # ranges of 10 under four threads
        j = edges[i]
        edges[i] = provider.VerifyJob(j.pubkey, j.message, j.sig[:63]) \
            if i % 2 else provider.VerifyJob(j.pubkey[:31], j.message, j.sig)
    mid = list(big)
    j = mid[4100]
    mid[4100] = provider.VerifyJob(bytearray(j.pubkey), j.message, j.sig)
    mid[300] = provider.VerifyJob(mid[300].pubkey[:5], None, None)
    last = list(edges)
    last[37] = provider.VerifyJob(*dataclasses.astuple(last[37])[:3],
                                  scheme="rsa")
    unset = _random_jobs(12, 23)
    unset[7] = _unset()
    prop_mid = _random_jobs(12, 24)
    prop_mid[5] = _property_sig(prop_mid[5])
    prop_first = [_property_sig(j) for j in _random_jobs(12, 25)]
    built = _random_jobs(12, 26)
    runtime = "".join(["ed", "25519"])
    built = [provider.VerifyJob(j.pubkey, j.message, j.sig, runtime)
             for j in built]
    subclass = _random_jobs(12, 27)
    subclass[9] = provider.VerifyJob(*dataclasses.astuple(subclass[9])[:3],
                                     scheme=_StrScheme("ed25519"))
    from corda_tpu.crypto import provider as jax_provider

    jax_jobs = [jax_provider.VerifyJob(*dataclasses.astuple(j))
                for j in _random_jobs(12, 28)]
    return {
        "malformed_at_range_edges": (edges, 4),
        "bytearray_mid_large_batch": (mid, 1),
        "wrong_scheme_in_last_range": (last, None),
        "unset_slot": (unset, None),
        "property_subclass_mid_batch": (prop_mid, 1),
        "property_subclass_first": (prop_first, 1),
        "scheme_built_at_run_time": (built, 4),
        "str_subclass_scheme": (subclass, 1),
        "jax_package_jobs": (jax_jobs, 1),
    }


AGREEING = ("malformed_at_range_edges", "bytearray_mid_large_batch",
            "wrong_scheme_in_last_range", "unset_slot",
            "property_subclass_mid_batch", "property_subclass_first",
            "scheme_built_at_run_time", "str_subclass_scheme",
            "jax_package_jobs")


@THREADS
@pytest.mark.parametrize("case", AGREEING)
def test_the_offset_pass_agrees_with_the_attribute_pass(case, threads,
                                                        core):
    """The same lanes through the pass as it reads slotted jobs (by
    offset where it can) and as it reads their dict-backed twins (by
    attribute): the same (n_good, held) or refusal, and the same words."""
    jobs, fanned = _agreeing()[case]
    n = len(jobs)
    a = np.full(32 * n, -1, np.int32)
    b = np.full(32 * n, -2, np.int32)
    got = core.pack_jobs(jobs, a, threads=threads)
    want = core.pack_jobs([_by_attribute(j) for j in jobs], b,
                          threads=threads)
    if fanned is None:
        assert got is None and want is None
        return
    assert got[:2] == want[:2] and want[2] == 1
    assert got[2] == (1 if threads == 1 else fanned)
    np.testing.assert_array_equal(a[:32 * got[0]], b[:32 * got[0]])


@THREADS
def test_a_foreign_jobs_getter_runs_before_a_later_refusal(threads, core):
    """A job of another type sends the batch to the attribute pass, which
    runs its getter before it reaches a refusing lane further on, as it
    always has; the refusal is the same."""
    jobs = _random_jobs(12, 33)
    ran = []

    class Counts:
        pubkey, message, sig = jobs[0].pubkey, jobs[0].message, jobs[0].sig

        @property
        def scheme(self):
            ran.append(True)
            return "ed25519"

    jobs[1] = Counts()
    jobs[10] = provider.VerifyJob(*dataclasses.astuple(jobs[10])[:3],
                                  scheme="rsa")
    assert core.pack_jobs(jobs, np.zeros(32 * 12, np.int32),
                          threads=threads) is None
    assert ran == [True]


def test_fanned_passes_see_a_list_whole_while_other_threads_swap_it(core):
    """The caller holds the GIL while its threads read the jobs, so no
    Python code runs between their reads: six callers packing one list
    over four threads each, while two threads swap the list's contents
    between two batches, always get one batch's words whole."""
    n = 9000
    a, b = _random_jobs(n, 51), _random_jobs(n, 52)
    want = [_reference_words(a).ravel(), _reference_words(b).ravel()]
    shared = list(a)
    stop = threading.Event()
    errors = []

    def swap(k):
        while not stop.is_set():
            shared[:] = a if k % 2 else b
            k += 1

    def pack():
        buf = np.zeros(32 * n, np.int32)
        while not stop.is_set():
            if core.pack_jobs(shared, buf, threads=4) != (n, None, 4):
                errors.append("result")
            elif not any(np.array_equal(buf, w) for w in want):
                errors.append("mixed words")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=swap, args=(k,))
                    for k in range(2)]
                   + [threading.Thread(target=pack) for _ in range(6)])
        for t in threads:
            t.start()
        stop.wait(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- the slotted job -----------------------------------------------------------


def test_a_job_is_slotted_and_keeps_its_fields():
    job = provider.VerifyJob(b"k" * 32, b"m" * 32, b"s" * 64)
    assert not hasattr(job, "__dict__")
    assert provider.VerifyJob.__slots__ == ("pubkey", "message", "sig",
                                            "scheme")
    assert [f.name for f in dataclasses.fields(job)] == list(
        provider.VerifyJob.__slots__)
    # The default is the interned literal, which the pass compares first.
    assert job.scheme is sys.intern("ed25519")
    with pytest.raises(dataclasses.FrozenInstanceError):
        job.sig = b"t" * 64
    assert dataclasses.replace(job, scheme="rsa") == provider.VerifyJob(
        b"k" * 32, b"m" * 32, b"s" * 64, "rsa")


def test_equality_and_hash_are_the_fields():
    fields = (b"k" * 32, b"m" * 32, b"s" * 64, "ed25519")
    job = provider.VerifyJob(*fields)
    assert job == provider.VerifyJob(*fields[:3])
    assert hash(job) == hash(provider.VerifyJob(*fields)) == hash(fields)
    assert job != provider.VerifyJob(*fields[:3], "ecdsa-p256")
    assert job != DictJob(*fields) and job != fields
    assert len({job, provider.VerifyJob(*fields), _random_jobs(1, 3)[0]}) == 2


@pytest.mark.parametrize("protocol", range(2, 6))
def test_a_job_pickles_and_copies(protocol):
    import copy
    import pickle

    job = provider.VerifyJob(b"k" * 32, b"m" * 33, b"s" * 64, "ecdsa-p256")
    back = pickle.loads(pickle.dumps(job, protocol))
    assert back == job and type(back) is provider.VerifyJob
    assert back.scheme == "ecdsa-p256" and not hasattr(back, "__dict__")
    assert copy.copy(job) == job and copy.deepcopy(job) == job


def test_a_job_round_trips_through_the_codec(monkeypatch):
    from corda_tpu_torch.serialization import codec

    for table in ("_BY_NAME", "_BY_TYPE", "_ENC_PLAN", "_DEC_PLAN"):
        monkeypatch.setattr(codec, table, dict(getattr(codec, table)))
    codec.register_class(provider.VerifyJob)
    jobs = [provider.VerifyJob(b"k" * 32, b"m" * 32, b"s" * 64),
            provider.VerifyJob(b"k" * 31, b"m", b"s" * 63, "rsa")]
    for job in jobs:
        back = codec.deserialize(codec.serialize(job))
        assert back == job and type(back) is provider.VerifyJob
    # A sequence's wire form is a tuple.
    assert codec.deserialize(codec.serialize(jobs)) == tuple(jobs)


def test_the_sidecars_request_round_trips_and_reads_by_offset(core):
    from corda_tpu_torch.crypto import sidecar

    jobs = _random_jobs(9, 31)
    req_id, back = sidecar.decode_verify_request(
        sidecar.encode_verify_request(5, jobs))
    assert (req_id, back) == (5, jobs)
    req_id, back, lane, deadline = sidecar.decode_verify_request_qos(
        sidecar.encode_verify_request_qos(6, jobs,
                                          sidecar.LANE_CODE_BULK, 123))
    assert (req_id, back, lane, deadline) == (6, jobs,
                                              sidecar.LANE_CODE_BULK, 123)
    buf = np.zeros(32 * 9, np.int32)
    assert core.pack_jobs(back, buf, threads=3) == (9, None, 3)
    np.testing.assert_array_equal(buf.reshape(4, 8, 9),
                                  _reference_words(jobs))


def test_a_signed_transactions_jobs_read_by_offset(core, monkeypatch):
    """check_signatures_are_valid builds slotted jobs of exact bytes: the
    pass reads them by offset, over the threads asked for."""
    from corda_tpu_torch.crypto.keys import KeyPair
    from corda_tpu_torch.crypto.party import Party
    from corda_tpu_torch.testing import dummies

    seen = []

    class Recorder(provider.BatchVerifier):
        def verify_batch(self, jobs):
            seen.extend(jobs)
            return np.ones(len(jobs), bool)

    monkeypatch.setattr(provider, "_default", Recorder())
    notary = Party.of("N", KeyPair.generate(b"\x61" * 32).public)
    key = KeyPair.generate(b"\x62" * 32)
    party = Party.of("P", key.public)
    for i in range(3):
        b = dummies.DummyContract.generate_initial(
            party.ref(i.to_bytes(4, "big")), i, notary)
        b.sign_with(key)
        b.to_signed_transaction(
            check_sufficient_signatures=False).check_signatures_are_valid()
    assert len(seen) == 3
    assert all(type(j) is provider.VerifyJob for j in seen)
    buf = np.zeros(32 * 3, np.int32)
    assert core.pack_jobs(seen, buf, threads=3) == (3, None, 3)
    np.testing.assert_array_equal(buf.reshape(4, 8, 3),
                                  _reference_words(seen))


def _on_cores(cores, fn):
    """fn() on a thread of its own pinned to ``cores``; its answer."""
    out = []

    def run():
        os.sched_setaffinity(0, cores)
        out.append(fn())

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert out, "the pinned thread did not finish"
    return out[0]


@pytest.mark.parametrize("mask", ["one_core", "every_core"])
def test_pass_threads_counts_a_batch_on_the_callers_cores(mask, packs,
                                                         monkeypatch):
    """A 100,000-lane batch packs in one single-pass batch on as many
    threads as its caller's mask holds cores (at most 16): one under a
    one-core mask."""
    monkeypatch.setattr(ted, "verify_arrays_hashed", _echo)
    threads = {"batches": 0, "threads": 0}
    monkeypatch.setattr(provider, "PASS_THREADS", threads)
    cores = sorted(os.sched_getaffinity(0))
    cores = cores[:1] if mask == "one_core" else cores
    jobs, want = _echo_batch(100_000, 41)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    np.testing.assert_array_equal(_on_cores(cores,
                                            lambda: v.verify_batch(jobs)),
                                  want)
    assert packs == {"single_pass": 1, "fallback": 0}
    assert threads == {"batches": 1, "threads": min(len(cores), 16)}
    if mask == "every_core" and len(cores) > 1:
        assert threads["threads"] >= 2


def _pass_threads_reader():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "metrics" / "provider.pass_threads_per_batch.bulk.py")
    spec = importlib.util.spec_from_file_location("pass_threads_reader",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_the_benchmark_reads_the_mean_threads_a_batch(monkeypatch):
    """provider.pass_threads_per_batch.bulk: threads over batches in a
    traced run; nothing untraced, before a batch, or without the
    counter."""
    read, traced = _pass_threads_reader(), {"trace": {}, "calls": 1}
    monkeypatch.setattr(provider, "PASS_THREADS",
                        {"batches": 4, "threads": 17})
    assert read(traced) == pytest.approx(4.25)
    assert read({"calls": 1}) is None
    monkeypatch.setattr(provider, "PASS_THREADS",
                        {"batches": 0, "threads": 0})
    assert read(traced) is None
    monkeypatch.delattr(provider, "PASS_THREADS")
    assert read(traced) is None


@pytest.mark.parametrize("n", [1, 4096, 8191, 8192, 30_000])
def test_a_small_batch_stays_on_one_thread(n, core):
    """One thread a 4,096 lanes, whatever the mask holds beyond that."""
    cores = sorted(os.sched_getaffinity(0))
    jobs = _random_jobs(n, n)
    buf = np.zeros(32 * n, np.int32)
    found = _on_cores(cores, lambda: core.pack_jobs(jobs, buf))
    assert found == (n, None, max(1, min(len(cores), 16, n // 4096)))
    np.testing.assert_array_equal(buf.reshape(4, 8, n),
                                  _reference_words(jobs))


# -- the verifier: the pass against the lists --------------------------------


def _batches():
    """name -> (jobs, the path the change packs it by, or None when no
    batch takes the device)."""
    good = [provider.VerifyJob(*_ed(i, ok=i % 4 != 1)) for i in range(10)]
    pk, msg, sig = _ed(20)
    malformed = list(good)
    malformed[2] = provider.VerifyJob(pk[:31], msg, sig)
    malformed[5] = provider.VerifyJob(pk, msg, sig[:63])
    malformed[6] = provider.VerifyJob(bytearray(pk), memoryview(msg), sig)
    mixed = list(malformed)
    mixed.insert(3, _p256())
    mixed.insert(8, _p256(ok=False))
    mixed.insert(1, provider.VerifyJob(pk, msg, sig, "rsa"))
    array_key = list(good)
    array_key[4] = provider.VerifyJob(array.array("B", pk), msg, sig)
    long_msg = list(good)
    long_msg[7] = provider.VerifyJob(*_ed(30, msg_len=33))
    none_good = [provider.VerifyJob(j.pubkey, j.message, j.sig[:40])
                 for j in good[:5]]
    mixed_none_good = none_good + [_p256()]
    few_ed = [_p256(), _p256(False), _p256(), provider.VerifyJob(pk, msg,
                                                                 sig)]
    return {
        "all_good": (good, "single_pass"),
        "malformed": (malformed, "single_pass"),
        "mixed": (mixed, "fallback"),
        "array_field": (array_key, "fallback"),
        "host_hash": (long_msg, "fallback"),
        "none_well_formed": (none_good, "single_pass"),
        "mixed_none_well_formed": (mixed_none_good, "fallback"),
        "p256_only": ([_p256(), _p256(False), _p256(), _p256()], None),
        "few_ed25519": (few_ed, None),
    }


BATCHES = ("all_good", "malformed", "mixed", "array_field", "host_hash",
           "none_well_formed", "mixed_none_well_formed", "p256_only",
           "few_ed25519")


@pytest.mark.parametrize("case", BATCHES)
def test_answers_counts_and_shadow_draws_equal_the_list_path(
        case, kernel, packs, monkeypatch):
    jobs, path = _batches()[case]
    if case == "host_hash":
        # Host-hashed words reach verify_arrays (the 4th array is h, not
        # M): both sides run the plain version there.
        monkeypatch.setattr(ted, "verify_arrays", ted.verify_arrays_reference)
    new, old = _verifiers(shadow_rate=0.5, device_min_sigs=4)
    got = new.verify_batch(jobs)
    packed_by = dict(packs)
    seen_new, kernel.seen = kernel.seen, []
    want = old.verify_batch(jobs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and len(got) == len(jobs)
    np.testing.assert_array_equal(got, provider.OracleVerifier()
                                  .verify_batch(jobs))
    assert (new.device_batches, new.host_batches) == (
        old.device_batches, old.host_batches)
    assert new._rng.getstate() == old._rng.getstate()
    assert len(seen_new) == len(kernel.seen)
    for a, b in zip(seen_new, kernel.seen):
        assert torch.equal(a, b)
    if path is None:
        assert new.device_batches == 0 and packed_by == dict.fromkeys(
            packed_by, 0)
    else:
        assert new.device_batches == 1
        assert packed_by[path] == 1 and sum(packed_by.values()) == 1


@pytest.mark.parametrize("case", ["malformed", "mixed"])
def test_the_plain_versions_answer_a_mixed_batch_alike(case):
    """No stand-in: the change and the list path through the plain
    versions, against the oracle."""
    jobs, _ = _batches()[case]
    new, old = _verifiers(device_min_sigs=0)
    want = provider.OracleVerifier().verify_batch(jobs)
    np.testing.assert_array_equal(new.verify_batch(jobs), want)
    np.testing.assert_array_equal(old.verify_batch(jobs), want)


@pytest.mark.parametrize("case", ["malformed", "mixed"])
def test_a_shadow_divergence_still_raises(case, monkeypatch):
    jobs, _ = _batches()[case]
    monkeypatch.setattr(ted, "verify_arrays_hashed", lambda a, r, s, m:
                        torch.ones(a.shape[1], dtype=torch.bool))
    v = provider.TorchVerifier(device="cpu", shadow_rate=1.0,
                               device_min_sigs=0)
    with pytest.raises(RuntimeError, match="divergence"):
        v.verify_batch(jobs)


def test_every_batch_counts_by_the_path_that_packed_it(kernel, packs):
    v = provider.TorchVerifier(device="cpu", device_min_sigs=4)
    good = [provider.VerifyJob(*_ed(i)) for i in range(6)]
    v.verify_batch(good)
    assert packs == {"single_pass": 1, "fallback": 0}
    v.verify_batch(good[:3])                       # host tier: not packed
    assert packs == {"single_pass": 1, "fallback": 0}
    v.verify_batch(good[:5] + [provider.VerifyJob(
        array.array("B", good[5].pubkey), good[5].message, good[5].sig)])
    assert packs == {"single_pass": 1, "fallback": 1}
    packed = v.pack_device(good)                   # the sidecar's split
    assert packs == {"single_pass": 2, "fallback": 1}
    assert v.verify_packed(packed).all()
    assert (v.device_batches, v.host_batches) == (3, 1)


@pytest.mark.parametrize("case", ["mixed", "array_field", "host_hash"])
def test_a_refused_batch_runs_the_pass_once(case, kernel, monkeypatch):
    """A batch the pass refuses goes to the lists without a second pass
    over its ed25519 jobs."""
    jobs, _ = _batches()[case]
    if case == "host_hash":
        monkeypatch.setattr(ted, "verify_arrays", ted.verify_arrays_reference)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    passes = []
    single_pass = v._single_pass
    v._single_pass = lambda js: passes.append(len(js)) or single_pass(js)
    v.verify_batch(jobs)
    assert passes == [len(jobs)]


def test_pack_device_refuses_mixed_schemes_without_packing(kernel, packs):
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    jobs, _ = _batches()["mixed"]
    assert v.pack_device(jobs) is None
    assert packs == {"single_pass": 0, "fallback": 0}


# -- the mesh: the same verifier over more devices -----------------------------


def _ed_lanes(jobs):
    """The positions of the ed25519 jobs, and how many are well-formed."""
    ed = [i for i, j in enumerate(jobs) if j.scheme == "ed25519"]
    return ed, sum(len(jobs[i].pubkey) == 32 and len(jobs[i].sig) == 64
                   for i in ed)


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("case", BATCHES)
def test_the_mesh_answers_counts_and_pads_as_one_verifier(case, d, kernel,
                                                         packs, monkeypatch):
    """TorchMeshVerifier on D copies of the CPU device: the oracle's
    answers and ops/sharded's on the ed25519 jobs, the single-device
    verifier's counts and pack path, and its lanes padded to
    ``pad_to_devices(n_good, D)``, one equal slice a device."""
    monkeypatch.setattr(ted, "verify_arrays", HostHashKernel(kernel))
    jobs, path = _batches()[case]
    ed, n_good = _ed_lanes(jobs)
    v = provider.TorchMeshVerifier(devices=["cpu"] * d, device_min_sigs=4)
    got = v.verify_batch(jobs)
    packed_by, seen, kernel.seen = dict(packs), kernel.seen, []
    np.testing.assert_array_equal(got, provider.OracleVerifier()
                                  .verify_batch(jobs))
    np.testing.assert_array_equal(got[ed], sharded.verify_batch_sharded(
        [jobs[i].pubkey for i in ed], [jobs[i].message for i in ed],
        [jobs[i].sig for i in ed], v.mesh))
    one = provider.TorchVerifier(device="cpu", device_min_sigs=4)
    one.verify_batch(jobs)
    assert (v.device_batches, v.host_batches) == (one.device_batches,
                                                  one.host_batches)
    if path is None:
        assert packed_by == dict.fromkeys(packed_by, 0)
    else:
        assert packed_by[path] == 1 and sum(packed_by.values()) == 1
    lanes = sharded.pad_to_devices(n_good, d)
    if path is None or not n_good:
        assert seen == []
    else:
        assert [w.shape for w in seen] == [(4, 8, lanes // d)] * d
    if path is not None and n_good and len(ed) == len(jobs):
        handle = v.pack_device(jobs)
        assert (handle.n_devices, handle.n, handle.lanes) == (d, n_good,
                                                              lanes)


# -- the per-thread buffer -----------------------------------------------------


def test_the_buffer_grows_to_the_largest_batch_and_is_kept(kernel):
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    big = [provider.VerifyJob(*_ed(i)) for i in range(9)]
    assert v.verify_batch(big[:4]).all()
    small = v._host.words
    assert small.numel() == 32 * 4 and not small.is_pinned()
    assert v.verify_batch(big).all()
    grown = v._host.words
    assert grown.numel() == 32 * 9
    assert v.verify_batch(big[2:5]).all()
    assert v._host.words is grown


def _echo(a, r, s, m):
    """A stand-in kernel answering each lane with its message's first
    bit: what a lane answers shows whose words it was given."""
    return (m[0] & 1).to(torch.bool)


def _echo_batch(n, tag):
    """n jobs of random bytes whose message's first bit is their answer;
    the answers differ from batch to batch."""
    jobs = _random_jobs(n, tag)
    bits = np.random.default_rng(tag + 1000).integers(0, 2, n).astype(bool)
    jobs = [provider.VerifyJob(j.pubkey, bytes([j.message[0] & 0xFE | int(b)])
                               + j.message[1:], j.sig)
            for j, b in zip(jobs, bits)]
    return jobs, bits


def test_a_packed_batch_is_its_own_once_pack_returns(monkeypatch):
    """The sidecar packs batch N + 1 while batch N runs: a handle must not
    read the buffer the next pack writes."""
    monkeypatch.setattr(ted, "verify_arrays_hashed", _echo)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    (a, want_a), (b, want_b) = _echo_batch(50, 1), _echo_batch(50, 2)
    pa = v.pack_device(a)
    pb = v.pack_device(b)
    np.testing.assert_array_equal(v.verify_packed(pa), want_a)
    np.testing.assert_array_equal(v.verify_packed(pb), want_b)


def test_two_threads_pack_and_answer_at_once(monkeypatch):
    """The sidecar's pattern and two callers side by side: a packer thread
    hands handles to an executor thread while another thread calls
    verify_batch; every answer is its own batch's."""
    monkeypatch.setattr(ted, "verify_arrays_hashed", _echo)
    v = provider.TorchVerifier(device="cpu", device_min_sigs=0)
    batches = [_echo_batch(20 + 13 * k, k) for k in range(12)]
    handles: queue.Queue = queue.Queue()
    errors = []

    def packer():
        for jobs, want in batches:
            handles.put((v.pack_device(jobs), want))
        handles.put(None)

    def executor():
        while (item := handles.get(timeout=30)) is not None:
            packed, want = item
            if not np.array_equal(v.verify_packed(packed), want):
                errors.append("executor")

    def caller():
        for jobs, want in reversed(batches):
            if not np.array_equal(v.verify_batch(jobs), want):
                errors.append("caller")

    threads = [threading.Thread(target=f) for f in (packer, executor, caller)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
