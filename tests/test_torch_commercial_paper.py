"""The port's CommercialPaper contract (corda_tpu_torch/finance/
commercial_paper.py) on its own ledger DSL (testing/ledger_dsl.py): the
mirror of tests/test_commercial_paper.py, every rule case run on the JAX
package and on the port from the same keys and instants, with the same
verdict and the same failure text; then the trader demo's DvP trade of a
paper over each package's MockNetwork, the port under its host tier and
under the device path's plain PyTorch versions, with byte-equal
transactions.
"""

import importlib
from types import SimpleNamespace

import pytest

from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier

PACKAGES = ("corda_tpu", "corda_tpu_torch")
USD = "USD"
WEEK = 7 * 24 * 3600 * 1_000_000
NOW = 1_800_000_000_000_000  # the instant every rule case is stamped around


def _pkg(name):
    def m(path):
        return importlib.import_module(f"{name}.{path}")

    structures = m("contracts.structures")
    cp = m("finance.commercial_paper")
    cash = m("finance.cash")
    dsl = m("testing.ledger_dsl")
    keys, party = m("crypto.keys"), m("crypto.party")
    ns = SimpleNamespace(
        Issued=structures.Issued, Timestamp=structures.Timestamp,
        Amount=m("finance.amount").Amount, CashState=cash.CashState,
        CashMove=cash.CashMove, CommercialPaper=cp.CommercialPaper,
        CPIssue=cp.CPIssue, CPMove=cp.CPMove, CPRedeem=cp.CPRedeem,
        CPState=cp.CPState, ledger=dsl.ledger, DslError=dsl.DslError,
        name=name)
    ns.MEGA_KEY = keys.KeyPair.generate(b"\x41" * 32)
    ns.MEGA = party.Party.of("MegaCorp", ns.MEGA_KEY.public)
    ns.ALICE_KEY = keys.KeyPair.generate(b"\x42" * 32)
    ns.ALICE = party.Party.of("Alice", ns.ALICE_KEY.public)
    ns.NOTARY = party.Party.of(
        "Notary", keys.KeyPair.generate(b"\x43" * 32).public)
    return ns


@pytest.fixture(params=PACKAGES)
def p(request):
    return _pkg(request.param)


def issued_usd(p, qty):
    return p.Amount(qty, p.Issued(p.MEGA.ref(b"\x01"), USD))


def paper(p, owner=None, maturity=None):
    return p.CPState(p.MEGA.ref(b"\x01"), owner or p.MEGA.owning_key,
                     issued_usd(p, 1000), maturity or NOW + WEEK)


class TestCommercialPaperRules:
    def test_issue_move_redeem_lifecycle(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.output("paper", paper(p))
            tx.command(p.CPIssue(), p.MEGA.owning_key)
            tx.timestamp(p.Timestamp.around(NOW, 1000))
            tx.verifies()
        with l.transaction() as tx:
            tx.input("paper")
            tx.output("alice's paper", paper(p, owner=p.ALICE.owning_key))
            tx.command(p.CPMove(), p.MEGA.owning_key)
            tx.verifies()
        with l.transaction() as tx:  # redeem at maturity for cash
            tx.input("alice's paper")
            tx.output(p.CashState(issued_usd(p, 1000), p.ALICE.owning_key))
            tx.input(p.CashState(issued_usd(p, 1000), p.MEGA.owning_key))
            tx.command(p.CPRedeem(), p.ALICE.owning_key)
            tx.command(p.CashMove(), p.MEGA.owning_key)
            tx.timestamp(p.Timestamp.around(NOW + WEEK, 1000))
            tx.verifies()

    def test_issue_requires_issuer_signature(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.output(paper(p))
            tx.command(p.CPIssue(), p.ALICE.owning_key)  # not the issuer
            tx.timestamp(p.Timestamp.around(NOW, 1000))
            tx.fails_with("signed by the issuer")

    def test_issue_requires_future_maturity(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.output(paper(p, maturity=NOW - WEEK))
            tx.command(p.CPIssue(), p.MEGA.owning_key)
            tx.timestamp(p.Timestamp.around(NOW, 1000))
            tx.fails_with("maturity date is in the future")

    def test_issue_requires_a_bounded_timestamp(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.output(paper(p))
            tx.command(p.CPIssue(), p.MEGA.owning_key)
            tx.fails_with("fully-bounded timestamp")

    def test_cannot_redeem_before_maturity_with_tweak(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.output("paper", paper(p, owner=p.ALICE.owning_key))
            tx.command(p.CPIssue(), p.MEGA.owning_key)
            tx.timestamp(p.Timestamp.around(NOW, 1000))
            tx.verifies()
        with l.transaction() as tx:
            tx.input("paper")
            tx.output(p.CashState(issued_usd(p, 1000), p.ALICE.owning_key))
            tx.input(p.CashState(issued_usd(p, 1000), p.MEGA.owning_key))
            tx.command(p.CPRedeem(), p.ALICE.owning_key)
            tx.command(p.CashMove(), p.MEGA.owning_key)
            with tx.tweak() as tw:  # too early
                tw.timestamp(p.Timestamp.around(NOW, 1000))
                tw.fails_with("must have matured")
            tx.timestamp(p.Timestamp.around(NOW + WEEK, 1000))
            tx.verifies()

    def test_redeem_must_pay_face_value(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.input(paper(p, owner=p.ALICE.owning_key))
            tx.output(p.CashState(issued_usd(p, 600),
                                  p.ALICE.owning_key))  # short
            tx.output(p.CashState(issued_usd(p, 400), p.MEGA.owning_key))
            tx.input(p.CashState(issued_usd(p, 1000), p.MEGA.owning_key))
            tx.command(p.CPRedeem(), p.ALICE.owning_key)
            tx.command(p.CashMove(), p.MEGA.owning_key)
            tx.timestamp(p.Timestamp.around(NOW + WEEK, 1000))
            tx.fails_with("face value")

    def test_move_cannot_change_terms(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.input(paper(p))
            bigger = p.CPState(p.MEGA.ref(b"\x01"), p.ALICE.owning_key,
                               issued_usd(p, 2000), NOW + WEEK)
            tx.output(bigger)
            tx.command(p.CPMove(), p.MEGA.owning_key)
            # Different face value = a different group with no inputs and no
            # issue command -> rejected.
            tx.fails_with("CPRedeem")

    def test_move_must_be_signed_by_the_owner(self, p):
        l = p.ledger(p.NOTARY)
        with l.transaction() as tx:
            tx.input(paper(p))
            tx.output(paper(p, owner=p.ALICE.owning_key))
            tx.command(p.CPMove(), p.ALICE.owning_key)  # not the owner
            tx.fails_with("signed by the owner")

    def test_dsl_requires_verification_call(self, p):
        l = p.ledger(p.NOTARY)
        with pytest.raises(p.DslError, match="without verifies"):
            with l.transaction() as tx:
                tx.output(paper(p))

    def test_dsl_names_a_missing_label(self, p):
        l = p.ledger(p.NOTARY)
        with pytest.raises(p.DslError, match="no output labeled"):
            with l.transaction() as tx:
                tx.input("never made")


def test_two_identical_papers_cannot_share_one_payment(p):
    """Regression: N identical papers in one group must each claim their own
    cash — a single face-value payment cannot extinguish both."""
    l = p.ledger(p.NOTARY)
    with l.transaction() as tx:
        tx.input(paper(p, owner=p.ALICE.owning_key))
        tx.input(paper(p, owner=p.ALICE.owning_key))  # identical twin
        tx.output(p.CashState(issued_usd(p, 1000),
                              p.ALICE.owning_key))  # only ONE
        tx.input(p.CashState(issued_usd(p, 1000), p.MEGA.owning_key))
        tx.command(p.CPRedeem(), p.ALICE.owning_key)
        tx.command(p.CashMove(), p.MEGA.owning_key)
        tx.timestamp(p.Timestamp.around(NOW + WEEK, 1000))
        tx.fails_with("face value")
    with l.transaction() as tx:  # paying for both is fine
        tx.input(paper(p, owner=p.ALICE.owning_key))
        tx.input(paper(p, owner=p.ALICE.owning_key))
        tx.output(p.CashState(issued_usd(p, 2000), p.ALICE.owning_key))
        tx.input(p.CashState(issued_usd(p, 2000), p.MEGA.owning_key))
        tx.command(p.CPRedeem(), p.ALICE.owning_key)
        tx.command(p.CashMove(), p.MEGA.owning_key)
        tx.timestamp(p.Timestamp.around(NOW + WEEK, 1000))
        tx.verifies()


def test_paper_encodings_equal_across_packages():
    """A paper, its issue and the contract's generated move encode to the
    same bytes in both packages (so their transaction ids are equal)."""
    jp, tp = _pkg("corda_tpu"), _pkg("corda_tpu_torch")
    blobs = []
    for q in (jp, tp):
        codec = importlib.import_module(f"{q.name}.serialization.codec")
        issue = q.CommercialPaper.generate_issue(
            q.MEGA.ref(b"\x07"), issued_usd(q, 500), NOW + WEEK, q.NOTARY)
        issue.set_time(q.Timestamp.around(NOW, 1000))
        issue.sign_with(q.MEGA_KEY)
        stx = issue.to_signed_transaction(check_sufficient_signatures=False)
        move = importlib.import_module(
            f"{q.name}.transactions.builder").TransactionBuilder(
            notary=q.NOTARY)
        q.CommercialPaper.generate_move(move, stx.tx.out_ref(0),
                                        q.ALICE.owning_key)
        move.sign_with(q.MEGA_KEY)
        blobs.append((codec.serialize(paper(q)).bytes,
                      codec.serialize(stx).bytes,
                      codec.serialize(move.to_signed_transaction(
                          check_sufficient_signatures=False)).bytes))
    assert blobs[0] == blobs[1]


PORT_VERIFIERS = {
    "cpu": CpuVerifier,
    "torch-cpu": lambda: TorchVerifier(device="cpu", device_min_sigs=0),
}


def _dvp_trade(name, verifier):
    """tests/test_commercial_paper.py's trader-demo shape: the seller holds
    a notarised paper, the buyer pays cash, one atomic swap through the
    validating notary. Returns the issue's and the settled trade's blobs,
    the new owner and the notary's committed count."""
    q = _pkg(name)

    def m(path):
        return importlib.import_module(f"{name}.{path}")

    Cash = m("finance.cash").Cash
    trade = m("finance.trade")
    codec = m("serialization.codec")
    net = m("testing.mock_network").MockNetwork(verifier=verifier)
    try:
        notary = net.create_notary_node("Notary", validating=True)
        seller = net.create_node("Seller")
        buyer = net.create_node("Buyer")
        issue = q.CommercialPaper.generate_issue(
            seller.identity.ref(b"\x01"), q.Amount(
                900, q.Issued(seller.identity.ref(b"\x01"), USD)),
            NOW + WEEK, notary.identity)
        issue.set_time(q.Timestamp.around(NOW, 30_000_000))
        issue.sign_with(seller.key)
        issue_stx = issue.to_signed_transaction(
            check_sufficient_signatures=False)
        # The paper's issue carries the notary's signature (a validating
        # notary checks the timestamp against its own clock, so the test
        # signs as the notary instead of notarising a fixed-instant issue).
        issue_stx = issue_stx.with_additional_signature(
            notary.key.sign(issue_stx.id.bytes))
        seller.record_transaction(issue_stx)

        cash_issue = Cash.generate_issue(
            q.Amount(1_000, USD), buyer.identity.ref(b"\x02"),
            buyer.identity.owning_key, notary.identity)
        cash_issue.sign_with(buyer.key)
        buyer.record_transaction(cash_issue.to_signed_transaction())

        buyer.register_initiated_flow(
            "SellerFlow",
            lambda party: trade.BuyerFlow(party, q.Amount(800, USD),
                                          notary.identity))
        handle = seller.start_flow(trade.SellerFlow(
            buyer.identity, issue_stx.tx.out_ref(0), q.Amount(750, USD)))
        net.run_network()
        final = handle.result.result()
        papers = [o.data for o in final.tx.outputs
                  if isinstance(o.data, q.CPState)]
        assert [x.owner for x in papers] == [buyer.identity.owning_key]
        return {"issue": codec.serialize(issue_stx).bytes,
                "final": codec.serialize(final).bytes,
                "owner": papers[0].owner.to_base58_string(),
                "committed": notary.uniqueness_provider.committed_count}
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("kind", sorted(PORT_VERIFIERS))
def test_dvp_trade_of_commercial_paper_equals_jax(kind):
    theirs = _dvp_trade("corda_tpu", JaxCpuVerifier())
    ours = _dvp_trade("corda_tpu_torch", PORT_VERIFIERS[kind]())
    assert ours == theirs
    assert ours["committed"] == 2  # the paper and the one cash state
