"""BASELINE config 4 in the port: Cash owned by a 3-of-3 CompositeKey,
against the JAX package. The mirror of
tests/test_attachments_multisig.py:59 on both packages; the chip phase's
burst of board moves (corda_tpu_torch/testing/multisig_load.run_moves)
at a small size, equal between the packages; and bench_multisig's batch
(bench.py:478-522) through the port's TorchVerifier on the CPU (the
plain PyTorch versions) and CpuVerifier, lane for lane equal to the JAX
package's CpuVerifier and to the oracle, with the composite walk's
fulfilled count equal to the bench's assert.
"""

import importlib
import os
import sys

import numpy as np
import pytest

from corda_tpu_torch.testing import multisig_load as ml

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_oracle import jax_api  # noqa: E402

PKGS = ("corda_tpu", "corda_tpu_torch")


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _three_of_three(pkg):
    """tests/test_attachments_multisig.py:59: a cash state owned by the
    board moves only with all three signatures."""
    s = _m(pkg, "contracts.structures")
    fin = _m(pkg, "finance")
    notary_flows = _m(pkg, "flows.notary")
    CompositeKey = _m(pkg, "crypto.composite").CompositeKey
    KeyPair = _m(pkg, "crypto.keys").KeyPair
    net = _m(pkg, "testing.mock_network").MockNetwork(
        verifier=_m(pkg, "crypto.provider").CpuVerifier())
    try:
        notary = net.create_notary_node("Notary", validating=True)
        treasury = net.create_node("Treasury")
        signer_keys = [KeyPair.generate(bytes([0x61 + i]) * 32)
                       for i in range(3)]
        board = CompositeKey.Builder().add_keys(
            *[kp.public for kp in signer_keys]).build(threshold=3)
        issue = fin.Cash.generate_issue(
            fin.Amount(9_000, "USD"), treasury.identity.ref(b"\x01"), board,
            notary.identity)
        issue.sign_with(treasury.key)
        issue_stx = issue.to_signed_transaction()
        treasury.record_transaction(issue_stx)

        def build_move(signers):
            tx = _m(pkg, "transactions.builder").TransactionBuilder(
                notary=notary.identity)
            tx.add_input_state(issue_stx.tx.out_ref(0))
            tx.add_output_state(fin.CashState(
                fin.Amount(9_000, s.Issued(treasury.identity.ref(b"\x01"),
                                           "USD")),
                treasury.identity.owning_key))
            tx.add_command(s.Command(_m(pkg, "finance.cash").CashMove(),
                                     (board,)))
            for kp in signers:
                tx.sign_with(kp)
            return tx.to_signed_transaction(check_sufficient_signatures=False)

        h1 = treasury.start_flow(notary_flows.NotaryClientFlow(
            build_move(signer_keys[:2])))
        net.run_network()
        with pytest.raises(Exception) as info:
            h1.result.result()
        assert notary.uniqueness_provider.committed_count == 0
        stx = build_move(signer_keys)
        h2 = treasury.start_flow(notary_flows.NotaryClientFlow(stx))
        net.run_network()
        sig = h2.result.result()
        sig.verify(stx.id.bytes)
        assert notary.uniqueness_provider.committed_count == 1
        return (type(info.value).__name__,
                type(getattr(info.value, "error", None)).__name__,
                bytes(stx.id.bytes), bytes(sig.bytes))
    finally:
        net.stop_nodes()


def test_three_of_three_composite_multisig_cash():
    ours = _three_of_three("corda_tpu_torch")
    assert ours[:2] == ("NotaryException", "NotarySignaturesMissing")
    assert ours == _three_of_three("corda_tpu")


@pytest.mark.parametrize("kind", ["cpu", "torch-cpu"])
def test_board_moves_equal_the_jax_package(kind):
    """The chip phase's burst at 16 moves: every eighth (two signatures)
    refused with NotarySignaturesMissing, the rest committed, each
    outcome, notary signature and committed input equal to the JAX
    package's run."""
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier

    runs = []
    for api, verifier in (
            (ml.port_api(), CpuVerifier() if kind == "cpu" else
             TorchVerifier(device="cpu", device_min_sigs=0)),
            (jax_api(ml.port_api()), JaxCpuVerifier())):
        net, notary, treasury = ml.make_move_network(api, verifier)
        try:
            issues, moves = ml.build_moves(api, notary, treasury, 16, 7)
            runs.append(ml.run_moves(api, net, notary, treasury, issues,
                                     moves))
        finally:
            net.stop_nodes()
    ours, theirs = runs
    assert [o[0] for o in ours["outcomes"]] == [
        "NotaryException" if ml.is_short(i) else "ok" for i in range(16)]
    assert {o[1] for o in ours["outcomes"] if o[0] != "ok"} == {
        "NotarySignaturesMissing"}
    assert len(ours["committed"]) == 14
    for key in ("outcomes", "tx_ids", "committed"):
        assert ours[key] == theirs[key], key


def _oracle_mask(jobs, n_distinct_jobs):
    """The oracle's answer for the first ``n_distinct_jobs`` jobs (one tile
    of the batch), tiled over all of them."""
    ref = _m("corda_tpu_torch", "crypto.ref_ed25519")
    one = [ref.verify(j.pubkey, j.message, j.sig)
           for j in jobs[:n_distinct_jobs]]
    return np.array([one[k % n_distinct_jobs] for k in range(len(jobs))])


@pytest.mark.parametrize("tile_to,want", [(2_048, 1_792), (10_000, 8_750)])
def test_bench_multisig_batch(tile_to, want):
    """bench_multisig's batch: 5,888 signatures at 2,048 transactions (the
    bench's size, through the port's TorchVerifier on the CPU as well) and
    28,750 at 10,000 (BASELINE config 4's size): every verifier's mask
    equals the oracle's lane for lane, and the composite walk fulfils
    exactly the transactions with three signatures."""
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier

    composite, txs, jobs, spans = ml.multisig_batch(ml.port_api(), tile_to)
    n_sigs = {2_048: 5_888, 10_000: 28_750}[tile_to]
    assert len(jobs) == n_sigs
    jc, jtxs, jjobs, jspans = ml.multisig_batch(jax_api(ml.port_api()),
                                                tile_to)
    assert [(j.pubkey, j.message, j.sig) for j in jjobs] == \
        [(j.pubkey, j.message, j.sig) for j in jobs]
    oracle = _oracle_mask(jobs, spans[ml.N_DISTINCT - 1][1])
    masks = {"cpu": CpuVerifier().verify_batch(jobs),
             "jax-cpu": JaxCpuVerifier().verify_batch(jjobs)}
    if tile_to == 2_048:
        masks["torch-cpu"] = TorchVerifier(
            device="cpu", device_min_sigs=0).verify_batch(jobs)
    expect = [not ml.is_short(i % ml.N_DISTINCT) for i in range(tile_to)]
    for name, mask in masks.items():
        assert np.asarray(mask, bool).tolist() == oracle.tolist(), name
        walk = (ml.fulfilled(jc, jtxs, jspans, mask) if name == "jax-cpu"
                else ml.fulfilled(composite, txs, spans, mask))
        assert walk == expect, name
        assert sum(walk) == want, name
