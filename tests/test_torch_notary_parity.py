"""The port's notary path against the JAX package's, on one seeded scenario.

The workload of corda_tpu_torch/testing/notary_load.py (DummyContract
issue-and-move pairs, two with a flipped signature byte, two second spends)
runs through each package's own MockNetwork, flows and notary service:
the JAX package with its CpuVerifier, the port with its host tier and with
the device path's plain PyTorch versions. With both notary kinds, in one
burst and in waves, the two runs must agree exactly on the transaction ids,
every outcome, the notary's signature bytes, the committed input set and
each node's verify batch and signature counts. Every wire frame either
package sent must decode in the other and re-encode to the same bytes, and
the session payloads (SignRequest, NotarySuccess, NotaryFailure, the fetch
traffic) must be byte-equal between the two runs.
"""

from types import SimpleNamespace

import pytest

from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu.flows.notary import NotaryClientFlow as JaxNotaryClientFlow
from corda_tpu.serialization import codec as jcodec
from corda_tpu.testing.dummies import DummyContract as JaxDummyContract
from corda_tpu.testing.mock_network import MockNetwork as JaxMockNetwork
from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier
from corda_tpu_torch.serialization import codec as tcodec
from corda_tpu_torch.testing import notary_load as nl

N, N_BAD, N_DOUBLE, SEED = 24, 2, 2, 20261017

JAX_API = SimpleNamespace(MockNetwork=JaxMockNetwork,
                          DummyContract=JaxDummyContract,
                          NotaryClientFlow=JaxNotaryClientFlow)
PORT_VERIFIERS = {
    "cpu": CpuVerifier,
    "torch-cpu": lambda: TorchVerifier(device="cpu", device_min_sigs=0),
}


def _run(api, verifier, validating, wave):
    net, notary, alice, bob = nl.make_network(api, verifier, validating)
    try:
        work = nl.build_workload(api, notary, alice, bob, N, N_BAD, N_DOUBLE,
                                 SEED)
        res = nl.run_workload(api, net, notary, alice, bob, work, wave=wave)
        res["frames"] = [bytes(m.message.data)
                         for m in net.messaging_network.sent_messages]
        res["work"] = work
        return res
    finally:
        net.stop_nodes()


_JAX_RUNS = {}


def _jax_run(validating, wave):
    key = (validating, wave)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run(JAX_API, JaxCpuVerifier(), validating, wave)
    return _JAX_RUNS[key]


def _payloads(codec, frames):
    """Sorted encodings of every session payload the frames carry (the
    session ids around them are random per run)."""
    out = []
    for blob in frames:
        frame = codec.deserialize(blob)
        payload = getattr(frame, "payload", getattr(frame, "first_payload",
                                                    None))
        if payload is not None:
            out.append(codec.serialize(payload).bytes)
    return sorted(out)


CASES = [(v, kind, None) for v in (False, True) for kind in sorted(PORT_VERIFIERS)]
CASES += [(v, "cpu", 8) for v in (False, True)]


@pytest.mark.parametrize("validating,kind,wave", CASES,
                         ids=lambda x: str(x))
def test_notary_scenario_equals_jax(validating, kind, wave):
    theirs = _jax_run(validating, wave)
    ours = _run(nl.port_api(), PORT_VERIFIERS[kind](), validating, wave)

    assert ours["tx_ids"] == theirs["tx_ids"]
    assert ours["outcomes"] == theirs["outcomes"]
    kinds = [o[:1] if o[0] == "ok" else o for o in ours["outcomes"]]
    assert kinds == nl.expected_outcomes(ours["work"])
    assert ours["notarised"] == N - N_BAD
    assert ours["committed"] == theirs["committed"]
    assert ours["committed_count"] == ours["notarised"]
    for name in nl.NODE_NAMES:
        for key in ("verify_batches", "verify_sigs", "largest_batch",
                    "verify_device_degraded"):
            assert ours["nodes"][name][key] == theirs["nodes"][name][key], \
                (name, key)
    if validating:
        assert ours["nodes"]["Notary"]["verify_sigs"] > 0
    assert _payloads(tcodec, ours["frames"]) == \
        _payloads(jcodec, theirs["frames"])


@pytest.mark.parametrize("validating", [False, True])
def test_wire_frames_byte_equal_both_ways(validating):
    theirs = _jax_run(validating, None)
    ours = _run(nl.port_api(), CpuVerifier(), validating, None)
    assert len(ours["frames"]) == len(theirs["frames"]) > 0
    for blob in ours["frames"]:
        assert jcodec.serialize(jcodec.deserialize(blob)).bytes == blob
    for blob in theirs["frames"]:
        assert tcodec.serialize(tcodec.deserialize(blob)).bytes == blob
    names = {type(tcodec.deserialize(p)).__name__
             for p in _payloads(tcodec, ours["frames"])}
    assert {"SignRequest", "NotarySuccess", "NotaryFailure"} <= names
