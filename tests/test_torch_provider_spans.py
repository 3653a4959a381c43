"""The device verify provider's spans (crypto/provider.py into
obs/trace.py's ``VERIFY`` ring, names in obs/stages.py ``PROVIDER_SPANS``),
on ``TorchVerifier("cpu")``: the plain versions stand in for the kernels.

While the torch profiler collects, a batch that takes the device leaves one
provider_verify span and, under its trace id, one provider_pack,
provider_copy_in and provider_device_wait span, inside it and in that
order, and the profiler sees each as a range of the same name on the same
clock. The sidecar's split path and host-routed batches record nothing;
with the profiler off nothing is recorded and no range is opened.
"""

import threading

import numpy as np
import pytest
import torch

from corda_tpu_torch.crypto import provider
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.obs import stages
from corda_tpu_torch.obs import trace as obs

STAGES = ("provider_pack", "provider_copy_in", "provider_device_wait")


def _ed(i, msg_len=32):
    seed = bytes([i + 1]) * 32
    msg = (b"m%d" % i).ljust(msg_len, b".")[:msg_len]
    return ref.public_key(seed), msg, ref.sign(seed, msg)


def _p256():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)

    key = ec.derive_private_key(0x4242, ec.SECP256R1())
    pub = key.public_key().public_bytes(Encoding.X962,
                                        PublicFormat.UncompressedPoint)
    msg = b"a p256 blob"
    return pub, msg, key.sign(msg, ec.ECDSA(hashes.SHA256()))


def _mixed_jobs():
    """Six ed25519 tx-id jobs (one tampered), a short key, a short
    signature, and a valid and a tampered ecdsa-p256 job."""
    jobs = [provider.VerifyJob(*_ed(i)) for i in range(6)]
    pk, msg, sig = _ed(7)
    jobs[2] = provider.VerifyJob(pk, msg, sig[:5] + bytes([sig[5] ^ 1])
                                 + sig[6:])
    jobs += [provider.VerifyJob(pk[:31], msg, sig),
             provider.VerifyJob(pk, msg, sig[:63])]
    ec_pub, ec_msg, ec_sig = _p256()
    jobs += [provider.VerifyJob(ec_pub, ec_msg, ec_sig, "ecdsa-p256"),
             provider.VerifyJob(ec_pub, b"other", ec_sig, "ecdsa-p256")]
    return jobs


def _recorded(fn):
    """Runs ``fn`` and returns (its result, the VERIFY spans recorded
    meanwhile, grouped by trace id)."""
    before = {s["span_id"] for s in obs.VERIFY.snapshot()}
    out = fn()
    traces = {}
    for s in obs.VERIFY.snapshot():
        if s["span_id"] not in before:
            traces.setdefault(s["trace_id"], []).append(s)
    return out, traces


def _one_batch(traces):
    """The spans of the one device batch among ``traces``, by name."""
    outer = [t for t in traces.values()
             if any(s["name"] == "provider_verify" for s in t)]
    assert len(outer) == 1, traces
    spans = outer[0]
    by_name = {s["name"]: s for s in spans}
    assert sorted(s["name"] for s in spans) == sorted(stages.PROVIDER_SPANS)
    return by_name


def _recorded_profiled(fn):
    """:func:`_recorded` under a CPU torch profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return _recorded(fn)


def _kineto_ranges(prof, names):
    """(name, start s, end s) of the profiler's host events of ``names``,
    on the epoch clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            out.append((e.name(), e.start_ns() / 1e9,
                        (e.start_ns() + e.duration_ns()) / 1e9))
    return out


@pytest.fixture(scope="module")
def profiled_batch():
    """One mixed batch through TorchVerifier("cpu") under a CPU profiler:
    (jobs, answers, the batch's spans by name, the profiler's ranges)."""
    jobs = _mixed_jobs()
    v = provider.TorchVerifier("cpu", device_min_sigs=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out, traces = _recorded(lambda: v.verify_batch(jobs))
    assert v.device_batches == 1 and v.host_batches == 0
    return jobs, out, _one_batch(traces), _kineto_ranges(
        prof, set(stages.PROVIDER_SPANS))


def test_provider_spans_are_registered_beside_the_reference_names():
    assert set(stages.PROVIDER_SPANS) <= stages.SPAN_NAMES
    assert not set(stages.PROVIDER_SPANS) & set(stages.STAGES)
    assert obs.VERIFY.capacity == obs.DEFAULT_CAPACITY


def test_answers_are_the_host_tiers(profiled_batch):
    jobs, out, _, _ = profiled_batch
    np.testing.assert_array_equal(out,
                                  provider.CpuVerifier().verify_batch(jobs))
    assert out.tolist() == [True, True, False, True, True, True, False,
                            False, True, False]


def test_device_batch_records_one_outer_span_over_three_children(
        profiled_batch):
    _, _, spans, _ = profiled_batch
    outer = spans["provider_verify"]
    assert outer["parent"] is None
    for name in STAGES:
        assert spans[name]["trace_id"] == outer["trace_id"]
        assert spans[name]["parent"] == outer["span_id"]
    assert len({s["span_id"] for s in spans.values()}) == 4


def test_children_lie_inside_the_outer_span_and_do_not_overlap(
        profiled_batch):
    _, _, spans, _ = profiled_batch
    outer = spans["provider_verify"]
    last = outer["t_start"]
    for name in STAGES:
        s = spans[name]
        assert last <= s["t_start"] <= s["t_end"] <= outer["t_end"], name
        last = s["t_end"]


def test_profiler_sees_the_four_stages(profiled_batch):
    """The native pass refuses the mixed batch (it takes ed25519 jobs
    only): its try is a provider_pack range of its own before the list
    path's, and the spans count it in the call's dispatch."""
    _, _, _, ranges = profiled_batch
    assert sorted(name for name, _, _ in ranges) == sorted(
        stages.PROVIDER_SPANS + ("provider_pack",))


def test_a_batch_the_pass_takes_opens_each_range_once():
    from corda_tpu_torch import native

    if native.load_cverify() is None:
        pytest.skip("no native core on this host: no batch takes the pass")
    jobs = _mixed_jobs()[:8]
    v = provider.TorchVerifier("cpu", device_min_sigs=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out, traces = _recorded(lambda: v.verify_batch(jobs))
    _one_batch(traces)
    ranges = _kineto_ranges(prof, set(stages.PROVIDER_SPANS))
    assert sorted(name for name, _, _ in ranges) == sorted(
        stages.PROVIDER_SPANS)
    np.testing.assert_array_equal(out,
                                  provider.CpuVerifier().verify_batch(jobs))


def test_a_long_stage_agrees_with_its_profiler_range(profiled_batch):
    """The spans' clock (time.time) is the profiler's: on the device wait,
    tens of milliseconds or more on the plain versions, both ends agree
    within 5 ms."""
    _, _, spans, ranges = profiled_batch
    span = spans["provider_device_wait"]
    assert span["t_end"] - span["t_start"] >= 0.05
    (_, start, end), = [r for r in ranges if r[0] == "provider_device_wait"]
    assert abs(start - span["t_start"]) < 0.005
    assert abs(end - span["t_end"]) < 0.005


def test_profiler_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    jobs = [provider.VerifyJob(*_ed(i)) for i in range(3)]
    v = provider.TorchVerifier("cpu", device_min_sigs=0)
    out, traces = _recorded(lambda: v.verify_batch(jobs))
    assert out.tolist() == [True] * 3
    assert v.device_batches == 1
    assert traces == {}


def test_split_path_records_nothing():
    """pack_device and verify_packed, on two threads as the sidecar runs
    them, record nothing even while the profiler collects: no program
    reader takes them, and the sidecar times the same work itself
    (pack_s_total, verify_s)."""
    jobs = [provider.VerifyJob(*_ed(i)) for i in range(4)]
    v = provider.TorchVerifier("cpu", device_min_sigs=0)

    def split():
        packed = v.pack_device(jobs)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            out=v.verify_packed(packed)))
        t.start()
        t.join(timeout=300)
        assert not t.is_alive()
        return result["out"]

    out, traces = _recorded_profiled(split)
    assert out.tolist() == [True] * 4
    assert v.device_batches == 1
    assert traces == {}


@pytest.mark.parametrize("case", ["crossover", "gate", "mixed-under-crossover",
                                  "nothing-well-formed"])
def test_batches_that_do_not_reach_the_device_record_nothing(case):
    ed = [provider.VerifyJob(*_ed(i)) for i in range(3)]
    v = provider.TorchVerifier("cpu", device_min_sigs=4)
    if case == "crossover":
        jobs = ed
    elif case == "gate":
        jobs = ed * 2
        v.device_gate = threading.Event()  # installed and clear: host
    elif case == "mixed-under-crossover":
        ec = provider.VerifyJob(*_p256(), scheme="ecdsa-p256")
        jobs = ed + [ec] * 3
    else:
        v.device_min_sigs = 0
        pk, msg, sig = ed[0].pubkey, ed[0].message, ed[0].sig
        jobs = [provider.VerifyJob(pk[:31], msg, sig),
                provider.VerifyJob(pk, msg, sig[:63])] * 3
    out, traces = _recorded_profiled(lambda: v.verify_batch(jobs))
    assert traces == {}
    np.testing.assert_array_equal(out,
                                  provider.CpuVerifier().verify_batch(jobs))
    assert v.pack_device(jobs) is None
