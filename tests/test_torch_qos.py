"""The port's admission control (corda_tpu_torch/qos/admission.py,
qos/calibrate.py) against the JAX package's.

Both packages' controllers read the same fake monotonic clock and take the
same seeded requests: every verdict, retry-after, bucket level, counter and
stats dict must be equal. ``calibrate_admission`` gets the same seeded
sweeps (dicts and objects, an SLO met, missed at once, and a miss followed
by a rate under the SLO again) and must derive the same knobs. Then the
notary's entry point sheds through an attached controller the same way in
both packages. Tolerance everywhere: exact equality.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu.flows.notary import NotaryClientFlow as JaxNotaryClientFlow
from corda_tpu.qos import admission as jadmission
from corda_tpu.qos import calibrate as jcalibrate
from corda_tpu.testing.dummies import DummyContract as JaxDummyContract
from corda_tpu.testing.mock_network import MockNetwork as JaxMockNetwork
from corda_tpu_torch.crypto.provider import CpuVerifier
from corda_tpu_torch.qos import admission, calibrate
from corda_tpu_torch.testing import notary_load as nl

LANES = ("interactive", "bulk", "other")


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, read by its admission module."""
    ours, theirs = _Clock(), _Clock()
    monkeypatch.setattr(admission, "time", ours)
    monkeypatch.setattr(jadmission, "time", theirs)
    return ours, theirs


@pytest.mark.parametrize("rate,burst", [(0.0, 5.0), (0.5, 2.0), (3.0, 0.2),
                                        (10.0, 32.0)])
def test_token_bucket_equal_jax(clocks, rate, burst):
    rng = np.random.default_rng(int(rate * 10 + burst))
    steps = rng.exponential(0.5 / max(rate, 1.0), 300)
    records = []
    for mod in (admission, jadmission):
        bucket = mod.TokenBucket(rate, burst)
        now = bucket._t_last
        rec = [(bucket.rate, bucket.burst, bucket.tokens)]
        for dt in steps:
            now += float(dt)
            rec.append((bucket.try_take(now), bucket.tokens,
                        bucket.retry_after_s()))
        records.append(rec)
    assert records[0] == records[1]
    if rate > 0:
        assert any(not r[0] for r in records[0][1:]), "nothing was refused"


CONTROLLERS = {
    "unlimited": dict(),
    "bulk-limited": dict(bulk_rate=2.0, bulk_burst=3.0),
    "interactive-limited": dict(interactive_rate=0.5, interactive_burst=1.0),
    "watermark": dict(queue_watermark=5, bulk_rate=4.0),
    "both": dict(interactive_rate=5.0, interactive_burst=4.0, bulk_rate=1.0,
                 bulk_burst=2.0, queue_watermark=12),
}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_admission_controller_equal_jax(clocks, name):
    rng = np.random.default_rng(len(name))
    lanes = rng.choice(len(LANES), 400)
    depths = rng.integers(0, 20, 400)
    steps = rng.exponential(0.2, 400)
    knobs = dict(interactive_rate=float(rng.uniform(0.5, 8)),
                 bulk_rate=float(rng.uniform(0.5, 8)), bulk_burst=None,
                 queue_watermark=int(rng.integers(3, 15)))
    records = []
    for mod, clock in ((admission, clocks[0]), (jadmission, clocks[1])):
        adm = mod.AdmissionController(**CONTROLLERS[name])
        rec = []
        for k in range(400):
            clock.now += float(steps[k])
            if k == 200:
                adm.reconfigure(**knobs)
            rec.append(adm.admit(LANES[lanes[k]], int(depths[k])))
        records.append((rec, adm.stats(), adm.counters))
    assert records[0] == records[1]


def _sweep(rng, p99s, as_dicts):
    results = {}
    for rate, p99 in zip((100, 200, 400, 800, 1600), p99s):
        lanes = {lane: {"p99_ms": p99 * (1.0 if lane == "interactive" else 3),
                        "tx_per_sec": float(rng.uniform(0.2, 0.6) * rate)}
                 for lane in ("interactive", "bulk")}
        results[rate] = (lanes if as_dicts else SimpleNamespace(
            **{k: SimpleNamespace(**v) for k, v in lanes.items()}))
    return results


SWEEPS = {
    "knee": (20, 30, 45, 90, 300),
    "missed-at-once": (80, 90, 120, 150, 400),
    "noise-after-knee": (20, 60, 40, 35, 500),
    "all-met": (5, 6, 7, 8, 9),
}


@pytest.mark.parametrize("as_dicts", [True, False])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_calibrate_admission_equal_jax(clocks, name, as_dicts):
    results = _sweep(np.random.default_rng(7), SWEEPS[name], as_dicts)
    ours = calibrate.calibrate_admission(results, 50.0, safety=0.7,
                                         bulk_burst=8.0)
    theirs = jcalibrate.calibrate_admission(results, 50.0, safety=0.7,
                                            bulk_burst=8.0)
    assert ours == theirs
    adm, jadm = admission.AdmissionController(), jadmission.AdmissionController()
    calibrate.apply_calibration(adm, ours)
    jcalibrate.apply_calibration(jadm, theirs)
    assert adm.stats() == jadm.stats()


def test_calibrate_admission_refuses_an_empty_sweep():
    for mod in (calibrate, jcalibrate):
        with pytest.raises(ValueError, match="empty sweep results"):
            mod.calibrate_admission({}, 50.0)


JAX = (SimpleNamespace(MockNetwork=JaxMockNetwork,
                       DummyContract=JaxDummyContract,
                       NotaryClientFlow=JaxNotaryClientFlow),
       jadmission, JaxCpuVerifier)
PORT = (nl.port_api(), admission, CpuVerifier)


def _shed_scenario(side, validating):
    api, mod, verifier_cls = side
    net, notary, alice, bob = nl.make_network(api, verifier_cls(), validating)
    try:
        work = nl.build_workload(api, notary, alice, bob, 6, 0, 0, 21)
        adm = mod.AdmissionController(interactive_rate=0.5,
                                      interactive_burst=3.0)
        notary.notary_service.admission = adm
        res = nl.run_workload(api, net, notary, alice, bob, work)
        return (res["outcomes"], res["committed"], adm.stats(),
                {k: (v["verify_batches"], v["verify_sigs"])
                 for k, v in res["nodes"].items()})
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("validating", [False, True])
def test_notary_admission_sheds_equal_jax(clocks, validating):
    ours = _shed_scenario(PORT, validating)
    theirs = _shed_scenario(JAX, validating)
    assert ours == theirs
    kinds = sorted(o[:2] if o[0] != "ok" else ("ok",) for o in ours[0])
    assert kinds == [("NotaryException", "OverloadedError")] * 3 + [("ok",)] * 3
    assert ours[2]["admitted_interactive"] == 3
    assert ours[2]["shed_interactive"] == 3
