"""Fault injection on the port's notary path (testing/faults.py's restored
partition and fsync hooks, the in-memory transport's send / recv rules)
against the JAX package's, and the verify pump's device-fault degrade.

Each package arms its own copy of the same plan and runs the same seeded
notary scenario (corda_tpu_torch/testing/notary_load.py) over its own
MockNetwork with the host tier: every flow's outcome (or the error that
stopped the run), the fault counters and the per-point event counts must
be equal. Then a ``verify.device`` failure in the async pump installed on
a MockNode's state machine manager must degrade that node's device-backed
verifier, re-verify the batch through ``host_verify``, complete every flow,
count one ``verify_device_degraded``, and re-open the gate after the given
cooldown. On a verifier whose device tier is the CUDA kernels the same
failure reaches the flows as an error instead, and nothing degrades.
"""

import time
from types import SimpleNamespace

import pytest

from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu.flows.notary import NotaryClientFlow as JaxNotaryClientFlow
from corda_tpu.testing import faults as jfaults
from corda_tpu.testing.dummies import DummyContract as JaxDummyContract
from corda_tpu.testing.mock_network import MockNetwork as JaxMockNetwork
from corda_tpu_torch.crypto.async_verify import AsyncVerifyService
from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier
from corda_tpu_torch.flows import NotaryClientFlow
from corda_tpu_torch.flows.api import FlowException
from corda_tpu_torch.testing import faults
from corda_tpu_torch.testing import notary_load as nl

JAX = (SimpleNamespace(MockNetwork=JaxMockNetwork,
                       DummyContract=JaxDummyContract,
                       NotaryClientFlow=JaxNotaryClientFlow),
       jfaults, JaxCpuVerifier)
PORT = (nl.port_api(), faults, CpuVerifier)


def _scenario(side, make_plan, validating, bind=None):
    api, fmod, verifier_cls = side
    net, notary, alice, bob = nl.make_network(api, verifier_cls(), validating)
    work = nl.build_workload(api, notary, alice, bob, 6, 1, 1, 99)
    plan = fmod.arm(make_plan(fmod))
    try:
        if bind is not None:
            fmod.bind_partition_nodes(
                [str({"alice": alice, "notary": notary, "bob": bob}[n]
                     .messaging.my_address) for n in bind])
        try:
            res = nl.run_workload(api, net, notary, alice, bob, work)
            outcome = res["outcomes"]
        except Exception as e:  # noqa: BLE001 -- compared across packages
            outcome = ("raised", type(e).__name__, str(e))
        return (outcome, plan.injected(), plan.event_counts(),
                len(net.messaging_network.sent_messages))
    finally:
        fmod.disarm()
        net.stop_nodes()


PARTITIONS = {
    "split-notary": (
        lambda f: f.FaultPlan(5, [], partitions=[
            f.PartitionSpec("split", after=6, duration=5)]),
        ("notary", "alice")),
    "split-held": (
        lambda f: f.FaultPlan(5, [], partitions=[
            f.PartitionSpec("split", after=20)]),
        ("alice", "notary", "bob")),
    "asym-alice": (
        lambda f: f.FaultPlan(6, [], partitions=[
            f.PartitionSpec("asym", after=0, duration=3)]),
        ("alice", "notary")),
    "flap-seeded": (
        lambda f: f.FaultPlan(7, [], partitions=[
            f.PartitionSpec("flap", after=2, duration=400)]),
        ("notary", "alice")),
}


@pytest.mark.parametrize("validating", [False, True])
@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_inmem_partition_cuts_equal_jax(name, validating):
    make_plan, bind = PARTITIONS[name]
    theirs = _scenario(JAX, make_plan, validating, bind)
    ours = _scenario(PORT, make_plan, validating, bind)
    assert ours == theirs
    assert ours[1].get("transport.partition:cut", 0) >= 1


RULES = {
    "send-drop": [dict(point="transport.send", action="drop", p=0.2)],
    "send-duplicate": [dict(point="transport.send", action="duplicate",
                            p=0.3)],
    "send-reorder": [dict(point="transport.send", action="reorder", p=0.4)],
    "recv-delay": [dict(point="transport.recv", action="delay", p=0.3,
                        delay_s=3)],
    "recv-drop-late": [dict(point="transport.recv", action="drop", after=12,
                            max_fires=2)],
    "checkpoint-stall": [dict(point="checkpoint.write", action="stall",
                              p=0.5, delay_s=0.001)],
    "checkpoint-fail": [dict(point="checkpoint.write", action="fail",
                             after=3, max_fires=1)],
}


@pytest.mark.parametrize("validating", [False, True])
@pytest.mark.parametrize("name", sorted(RULES))
def test_inmem_and_checkpoint_rules_equal_jax(name, validating):
    def make_plan(f):
        return f.FaultPlan(11, [f.FaultRule(**r) for r in RULES[name]])

    theirs = _scenario(JAX, make_plan, validating)
    ours = _scenario(PORT, make_plan, validating)
    assert ours == theirs
    assert ours[1], "the plan injected nothing"


def test_device_fault_degrades_to_host_verify_and_reopens():
    cooldown_s = 0.3
    api = nl.port_api()
    net, notary, alice, bob = nl.make_network(api, CpuVerifier(), False)
    device = TorchVerifier(device="cpu", device_min_sigs=0)
    svc = AsyncVerifyService(device, depth=2)
    alice.smm.async_verify = svc
    alice.smm.reprobe_cooldown_s = cooldown_s
    work = nl.build_workload(api, notary, alice, bob, 4, 0, 0, 5)
    for issue in work.issues:
        alice.record_transaction(issue)
    faults.arm(faults.FaultPlan(13, [faults.FaultRule(
        "verify.device", "fail", max_fires=1)]))
    try:
        t0 = time.monotonic()
        handles = [alice.start_flow(NotaryClientFlow(s)) for s in work.moves]
        nl.run_network_async(net)
        assert faults.injected() == {"verify.device:fail": 1}
    finally:
        faults.disarm()
    try:
        for stx, h in zip(work.moves, handles):
            h.result.result().verify(stx.id.bytes)
        assert notary.uniqueness_provider.committed_count == 4
        assert alice.smm.metrics["verify_device_degraded"] == 1
        assert device.degraded == 1
        # The own-signature batch failed on the device and was re-verified
        # on the host; the response batch found the gate shut.
        assert svc.failed_batches == 1 and device.host_batches >= 1
        assert device.device_gate.wait(120.0), "the re-probe never reopened"
        assert time.monotonic() - t0 >= cooldown_s
        assert device.reprobes_ok == 1 and device.reprobes_failed == 0
    finally:
        assert svc.close()
        net.stop_nodes()


class _KernelBackedVerifier(TorchVerifier):
    """A TorchVerifier on the CPU that reports the CUDA kernels as its
    device tier (the fault fires before any verify runs)."""

    kernel_backend = "cuda"


def test_device_fault_on_the_kernels_reaches_the_flows():
    api = nl.port_api()
    net, notary, alice, bob = nl.make_network(api, CpuVerifier(), False)
    device = _KernelBackedVerifier(device="cpu", device_min_sigs=0)
    svc = AsyncVerifyService(device, depth=2)
    alice.smm.async_verify = svc
    work = nl.build_workload(api, notary, alice, bob, 4, 0, 0, 5)
    for issue in work.issues:
        alice.record_transaction(issue)
    faults.arm(faults.FaultPlan(13, [faults.FaultRule(
        "verify.device", "fail", max_fires=1)]))
    try:
        handles = [alice.start_flow(NotaryClientFlow(s)) for s in work.moves]
        nl.run_network_async(net)
        assert faults.injected() == {"verify.device:fail": 1}
    finally:
        faults.disarm()
    try:
        # The own-signature batch of all four moves raised: every flow
        # fails with the device error, nothing was notarised, and the
        # verifier was neither degraded nor gated.
        for h in handles:
            with pytest.raises(FlowException,
                               match="RuntimeError: fault injected"):
                h.result.result()
        assert notary.uniqueness_provider.committed_count == 0
        assert svc.failed_batches == 1
        assert alice.smm.metrics["verify_device_degraded"] == 0
        assert device.degraded == 0 and device.device_gate is None
        assert device.host_batches == 0
    finally:
        assert svc.close()
        net.stop_nodes()
