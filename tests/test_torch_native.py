"""The port's native core (corda_tpu_torch/native/_cverify.c) against the
JAX package's (corda_tpu/native/_cverify.c) and the port's numpy packer.

pack_words must write byte-equal word arrays and raise the same
ValueErrors in the same order; verify_many must give the same accept
bytes on the golden corpus, a subset of the oracle's accept set. The
loader builds into build/corda_tpu_torch/native/<sha256 of the source>/,
survives several processes building at once, and gives None (the numpy
path) where it cannot build. Every comparison is exact.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from corda_tpu import native as jnative
from corda_tpu_torch import native
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import ed25519 as ted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cores():
    ours, theirs = native.load_cverify(), jnative.load_cverify()
    if ours is None or theirs is None:
        pytest.skip("no gcc or libcrypto on this host: nothing to compare")
    return ours, theirs


def _random_cols(n, seed=7):
    rng = np.random.default_rng(seed)
    pks = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    msgs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    sigs = [bytes(rng.integers(0, 256, 64, dtype=np.uint8)) for _ in range(n)]
    return pks, msgs, sigs


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("extra", [0, 37], ids=["bucket=n", "bucket>n"])
def test_pack_words_byte_equal_to_jax_and_numpy(cores, n, extra):
    ours, theirs = cores
    pks, msgs, sigs = _random_cols(n)
    bucket = n + extra
    got = ours.pack_words(pks, msgs, sigs, bucket)
    assert got == theirs.pack_words(pks, msgs, sigs, bucket)
    if bucket == 0:
        return  # the Python packers read bucket 0 as "pick one"
    words, m = ted.precompute_batch_device(pks, msgs, sigs, bucket)
    numpy_words, numpy_m = ted.precompute_batch_device_numpy(
        pks, msgs, sigs, bucket)
    assert m == numpy_m == n
    for raw, w, nw in zip(got, words, numpy_words):
        assert w.dtype == np.uint32 and w.shape == (8, bucket)
        assert raw == w.tobytes() == nw.tobytes()


def test_precompute_batch_device_takes_the_native_packer(cores, monkeypatch):
    pks, msgs, sigs = _random_cols(5)
    calls = []
    real = cores[0].pack_words

    class Spy:
        def pack_words(self, *args):
            calls.append(len(args[0]))
            return real(*args)

    monkeypatch.setattr(native, "load_cverify", lambda: Spy())
    (a, _, _, _), n = ted.precompute_batch_device(pks, msgs, sigs)
    assert calls == [5] and n == 5 and a.shape == (8, 64)


@pytest.mark.parametrize("mutate", ["lengths", "bucket", "pk", "msg", "sig",
                                    "pk_and_msg", "msg_and_sig"])
def test_pack_words_rejects_like_numpy_and_jax(cores, mutate):
    ours, theirs = cores
    pks, msgs, sigs = _random_cols(4)
    bucket = 8
    if mutate == "lengths":
        pks = pks[:-1]
    elif mutate == "bucket":
        bucket = 2
    if mutate in ("pk", "pk_and_msg"):
        pks[2] = bytes(31)
    if mutate in ("msg", "pk_and_msg", "msg_and_sig"):
        msgs[1] = b"short"
    if mutate in ("sig", "msg_and_sig"):
        sigs[0] = bytes(63)
    errors = []
    for fn in (lambda: ours.pack_words(pks, msgs, sigs, bucket),
               lambda: theirs.pack_words(pks, msgs, sigs, bucket),
               lambda: ted.precompute_batch_device(pks, msgs, sigs, bucket),
               lambda: ted.precompute_batch_device_numpy(pks, msgs, sigs,
                                                         bucket)):
        with pytest.raises(ValueError) as exc:
            fn()
        errors.append(str(exc.value))
    assert len(set(errors)) == 1, errors


def _golden():
    """(pk, msg, sig) cases: valid over variable-length messages, tampered,
    S + L (the oracle accepts, libcrypto rejects), non-canonical A, an
    invalid point, wrong key and signature lengths."""
    cases = []
    for i in range(6):
        seed = bytes([i + 3]) * 32
        msg = bytes([i]) * (11 * i)
        cases.append((ref.public_key(seed), msg, ref.sign(seed, msg)))
    pk, msg, sig = cases[1]
    s_plus_l = int.from_bytes(sig[32:], "little") + ref.L
    cases += [(pk, msg, sig[:32] + s_plus_l.to_bytes(32, "little")),
              (pk, msg + b"!", sig),
              (pk, msg, sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]),
              (pk[:31], msg, sig), (pk, msg, sig[:63]), (pk, msg, sig + b"\0")]
    for y in range(19):
        x = ref._recover_x(y, 0)
        if x is not None:
            enc = int.from_bytes(ref.compress((x, y)), "little") + ref.P
            cases.append((enc.to_bytes(32, "little"), b"m", bytes(64)))
            break
    for y in range(2, 100):
        if ref._recover_x(y, 0) is None:
            cases.append((y.to_bytes(32, "little"), msg, sig))
            break
    return cases


def test_verify_many_equals_jax_and_accepts_a_subset_of_the_oracle(cores):
    ours, theirs = cores
    cases = _golden()
    cols = [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases]
    got = ours.verify_many(*cols)
    assert got == theirs.verify_many(*cols)
    want = [ref.verify(*c) for c in cases]
    accepted = list(got)
    assert all(w for a, w in zip(accepted, want) if a)
    s_plus_l = 6
    assert want[s_plus_l] and not accepted[s_plus_l]
    # the non-canonical A lane (S = 0, R = 0) verifies on both sides
    assert accepted == [1] * 6 + [0] * 6 + [1, 0]


def test_pack_backend_and_build_path(cores):
    assert native.pack_backend() == "native"
    path = native.build_path("_cverify")
    with open(os.path.join(REPO, "corda_tpu_torch", "native", "_cverify.c"),
              "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert path.startswith(os.path.join(REPO, "build", "corda_tpu_torch",
                                        "native", digest) + os.sep)
    assert os.path.exists(path) and cores[0].__file__ == path


def test_no_libcrypto_gives_the_numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_libcrypto_path", lambda: None)
    monkeypatch.setattr(native, "_CACHE", {})
    assert native.load_cverify() is None
    assert native.pack_backend() == "numpy"
    pks, msgs, sigs = _random_cols(3)
    words, n = ted.precompute_batch_device(pks, msgs, sigs, 4)
    want, _ = ted.precompute_batch_device_numpy(pks, msgs, sigs, 4)
    assert n == 3 and all(np.array_equal(w, v) for w, v in zip(words, want))


def test_failed_build_gives_none_and_leaves_no_temp_file(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "_CACHE", {})

    def no_gcc(*args, **kwargs):
        raise FileNotFoundError("gcc")

    monkeypatch.setattr(native.subprocess, "run", no_gcc)
    assert native.load_cverify() is None
    assert native.pack_backend() == "numpy"
    leftovers = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert leftovers == []


_RACE = r"""
import sys
from corda_tpu_torch import native
native.BUILD_ROOT = sys.argv[1]
core = native.load_cverify()
assert core is not None and core.__file__ == native.build_path("_cverify")
pks = [bytes([i]) * 32 for i in range(3)]
assert core.pack_words(pks, pks, [p + p for p in pks], 3)[0][:4] == bytes(4)
print("built-ok")
"""


def test_concurrent_builds_each_load_a_whole_extension(cores, tmp_path):
    """Processes that find no build at once each compile to a temp name and
    os.replace it: every one of them loads a complete extension."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert all(o.strip() == "built-ok" for o, _ in outs)
    built = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert built == [os.path.basename(native.build_path("_cverify"))]
