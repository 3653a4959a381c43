"""The port's flow framework end to end over its MockNetwork: the mirror of
tests/test_flows_e2e.py's TestNotarisation, TestFinality,
TestSingleSigPump, TestRecovery, TestKillAtEveryStep and TestSessionErrors
(TestNotaryChange needs state_replacement, which is not ported yet).

Every case runs twice: with the host tier (``CpuVerifier()``) and with the
device path's plain PyTorch versions (``TorchVerifier(device="cpu",
device_min_sigs=0)``, every micro-batch through the verify path the card
runs). The verifier is always passed explicitly: the default is the card.
"""

import pytest

from corda_tpu_torch.crypto.keys import SignatureError
from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier
from corda_tpu_torch.flows import (
    FinalityFlow,
    FlowLogic,
    NotaryClientFlow,
    NotaryConflict,
    NotaryException,
    register_flow,
)
from corda_tpu_torch.testing.dummies import DummyContract
from corda_tpu_torch.testing.mock_network import MockNetwork

VERIFIERS = {
    "cpu": CpuVerifier,
    "torch-cpu": lambda: TorchVerifier(device="cpu", device_min_sigs=0),
}


@pytest.fixture(params=sorted(VERIFIERS))
def verifier(request):
    return VERIFIERS[request.param]()


@pytest.fixture()
def net(verifier):
    network = MockNetwork(verifier=verifier)
    yield network
    network.stop_nodes()


def make_parties(net):
    notary = net.create_notary_node("Notary")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    return notary, alice, bob


def issue_to(net, node, notary_party, magic=1):
    """Issue a dummy state on `node`'s ledger (no notary sig needed: no inputs)."""
    builder = DummyContract.generate_initial(
        node.identity.ref(b"\x00"), magic, notary_party
    )
    builder.sign_with(node.key)
    stx = builder.to_signed_transaction()
    node.record_transaction(stx)
    return stx


def move_to(issue_stx, new_owner, signer):
    move = DummyContract.move(issue_stx.tx.out_ref(0), new_owner.identity.owning_key)
    move.sign_with(signer.key)
    return move.to_signed_transaction(check_sufficient_signatures=False)


_CONTENT = b"notary-signed-content-0123456789ab"


@register_flow
class CheckSigFlow(FlowLogic):
    """Validates one signature over _CONTENT through the verify pump."""

    def __init__(self, sig):
        self.sig = sig

    def call(self):
        yield self.verify_signature_batched(self.sig, _CONTENT)
        return "ok"


@register_flow
class UnknownInitiator(FlowLogic):
    """Opens a session no responder is registered for."""

    def __init__(self, other):
        self.other = other

    def call(self):
        reply = yield self.send_and_receive(self.other, "hello?")
        return reply


class TestNotarisation:
    def test_notarise_move(self, net):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=7)
        move_stx = move_to(issue_stx, bob, alice)

        handle = alice.start_flow(NotaryClientFlow(move_stx))
        net.run_network()

        sig = handle.result.result()
        assert sig.by in notary.identity.owning_key.keys
        sig.verify(move_stx.id.bytes)
        assert notary.uniqueness_provider.committed_count == 1

    def test_double_spend_rejected(self, net):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=8)
        stx1 = move_to(issue_stx, bob, alice)
        stx2 = move_to(issue_stx, alice, alice)
        assert stx1.id != stx2.id

        h1 = alice.start_flow(NotaryClientFlow(stx1))
        net.run_network()
        h1.result.result()  # first spend accepted

        h2 = alice.start_flow(NotaryClientFlow(stx2))
        net.run_network()
        with pytest.raises(NotaryException) as exc:
            h2.result.result()
        assert isinstance(exc.value.error, NotaryConflict)

    def test_unsigned_transaction_rejected(self, net):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=9)
        stx = move_to(issue_stx, bob, bob)  # wrong key: owner is alice

        handle = alice.start_flow(NotaryClientFlow(stx))
        net.run_network()
        with pytest.raises(Exception):
            handle.result.result()
        assert notary.uniqueness_provider.committed_count == 0


class TestFinality:
    def test_finality_notarises_and_broadcasts(self, net):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=10)
        stx = move_to(issue_stx, bob, alice)

        handle = alice.start_flow(FinalityFlow(stx, (bob.identity,)))
        net.run_network()
        final_stx = handle.result.result()

        # Notary signature attached; both nodes recorded the transaction.
        assert len(final_stx.sigs) == 2
        a_txs = alice.services.storage_service.validated_transactions
        b_txs = bob.services.storage_service.validated_transactions
        assert a_txs.get_transaction(stx.id) is not None
        assert b_txs.get_transaction(stx.id) is not None
        # Bob resolved the dependency (the issue tx) too.
        assert b_txs.get_transaction(issue_stx.id) is not None
        # Bob's vault sees the new state; alice's vault consumed hers.
        assert len(bob.services.vault_service.current_vault.states) == 1
        assert len(alice.services.vault_service.current_vault.states) == 0

    def test_batched_verification_actually_batches(self, net):
        """Concurrent notarisations verify in shared batches."""
        notary, alice, bob = make_parties(net)
        stxs = [move_to(issue_to(net, alice, notary.identity, magic=20 + i),
                        bob, alice) for i in range(4)]

        handles = [alice.start_flow(NotaryClientFlow(stx)) for stx in stxs]
        net.run_network()
        for h in handles:
            h.result.result()
        # Deferred flushing batches the 4 concurrent flows' checks into ONE
        # verify call per phase: the clients' own-signature round and their
        # notary-response-signature round (2 on alice), and the notary's
        # request-validation round.
        assert alice.smm.metrics["verify_sigs"] >= 8
        assert alice.smm.metrics["verify_batches"] == 2
        assert notary.smm.metrics["verify_sigs"] >= 4
        assert notary.smm.metrics["verify_batches"] <= 2


class TestSingleSigPump:
    def test_bad_signature_rejected_via_pump(self, net):
        """verify_signature_batched delivers SignatureError for a corrupted
        signature (the notary-response validation path)."""
        _, alice, _ = make_parties(net)
        good = alice.key.sign(_CONTENT)
        bad = type(good)(good.bytes[:5] + bytes([good.bytes[5] ^ 1])
                         + good.bytes[6:], good.by)

        h_good = alice.start_flow(CheckSigFlow(good))
        h_bad = alice.start_flow(CheckSigFlow(bad))
        net.run_network()
        assert h_good.result.result() == "ok"
        with pytest.raises(SignatureError):
            h_bad.result.result()
        # Both checks rode one micro-batch.
        assert alice.smm.metrics["verify_batches"] == 1
        assert alice.smm.metrics["verify_sigs"] == 2


class TestRecovery:
    def test_notary_restart_mid_flow(self, net):
        """Kill the notary between request arrival and processing; restore
        from checkpoints must complete the protocol."""
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=30)
        stx = move_to(issue_stx, bob, alice)

        handle = alice.start_flow(NotaryClientFlow(stx))
        pumped = 0
        while net.messaging_network.pump():
            pumped += 1
            if pumped == 2:
                notary = notary.restart()
        net.run_network()
        sig = handle.result.result()
        sig.verify(stx.id.bytes)

    def test_client_restart_resumes_from_checkpoint(self, net):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=31)
        stx = move_to(issue_stx, bob, alice)

        alice.start_flow(NotaryClientFlow(stx))
        alice = alice.restart()
        net.run_network()
        assert notary.uniqueness_provider.committed_count == 1


class TestKillAtEveryStep:
    """The notarisation protocol completes wherever a node crashes, because
    every suspension is checkpointed."""

    @pytest.mark.parametrize("crash_after", [1, 2, 3, 4, 5])
    @pytest.mark.parametrize("victim", ["client", "notary"])
    def test_crash_at_step(self, net, crash_after, victim):
        notary, alice, bob = make_parties(net)
        issue_stx = issue_to(net, alice, notary.identity, magic=50 + crash_after)
        stx = move_to(issue_stx, bob, alice)

        alice.start_flow(NotaryClientFlow(stx))
        steps = 0
        crashed = False
        while True:
            progressed = net.messaging_network.pump()
            if not progressed:
                flushed = sum(n.smm.flush_pending_verifies() for n in net.nodes)
                if not flushed:
                    break
            steps += 1
            if steps == crash_after and not crashed:
                crashed = True
                if victim == "client":
                    alice = alice.restart()
                else:
                    notary = notary.restart()
        net.run_network()
        assert notary.uniqueness_provider.committed_count == 1, (
            f"crash_after={crash_after} victim={victim}: protocol did not complete"
        )


class TestSessionErrors:
    def test_unregistered_flow_rejected(self, net):
        notary, alice, bob = make_parties(net)
        handle = alice.start_flow(UnknownInitiator(bob.identity))
        net.run_network()
        with pytest.raises(Exception):
            handle.result.result()
