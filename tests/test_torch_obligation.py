"""The port's Obligation contract (corda_tpu_torch/finance/obligation.py)
against the JAX package's: the mirror of tests/test_obligation.py's eleven
cases, each run on both packages through its own ledger DSL with the same
keys; then one transaction of each lifecycle (issue, move, partial
settle, bilateral net) built by both packages, which must serialize to the
same bytes and id and get the same verdict; then the seeded workload of
``testing/obligation_load.py`` (the chip phase's, cut to 40 transactions)
through each package's validating notary over MockNetwork, with equal
outcomes and the ones the signature mask predicts.
"""

import importlib
from types import SimpleNamespace

import pytest

from corda_tpu_torch.testing import obligation_load as ol

PKGS = ("corda_tpu", "corda_tpu_torch")


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def api_of(pkg) -> SimpleNamespace:
    """The names the cases use, from ``pkg``; the parties are built from
    the same seeds in both packages."""
    ob = _m(pkg, "finance.obligation")
    st = _m(pkg, "contracts.structures")
    KeyPair = _m(pkg, "crypto.keys").KeyPair
    Party = _m(pkg, "crypto.party").Party
    ns = SimpleNamespace(
        pkg=pkg, Obligation=ob.Obligation, ObligationIssue=ob.ObligationIssue,
        ObligationMove=ob.ObligationMove, ObligationNet=ob.ObligationNet,
        ObligationSettle=ob.ObligationSettle,
        ObligationState=ob.ObligationState, Issued=st.Issued,
        StateAndRef=st.StateAndRef, StateRef=st.StateRef,
        TransactionState=st.TransactionState, Command=st.Command,
        KeyPair=KeyPair, Party=Party,
        Amount=_m(pkg, "finance").Amount,
        CashState=_m(pkg, "finance").CashState,
        CashMove=_m(pkg, "finance.cash").CashMove,
        SecureHash=_m(pkg, "crypto.hashes").SecureHash,
        TransactionBuilder=_m(pkg, "transactions.builder").TransactionBuilder,
        ledger=_m(pkg, "testing.ledger_dsl").ledger,
        serialize=_m(pkg, "serialization.codec").serialize)
    ns.keys = {name: KeyPair.generate(bytes([seed]) * 32) for name, seed in
               (("Alice", 0x71), ("Bob", 0x72), ("Bank", 0x73),
                ("Notary", 0x74), ("Eve", 0x75))}
    for name, kp in ns.keys.items():
        setattr(ns, name.upper(), Party.of(name, kp.public))
    ns.TOKEN = ns.Issued(ns.BANK.ref(b"\x01"), "USD")
    return ns


@pytest.fixture(params=PKGS)
def api(request):
    return api_of(request.param)


def owed(api, obligor, owner, qty, token=None):
    return api.ObligationState(obligor.owning_key,
                               api.Amount(qty, token or api.TOKEN),
                               owner.owning_key)


def cash(api, owner, qty):
    return api.CashState(api.Amount(qty, api.TOKEN), owner.owning_key)


# ---------------------------------------------------------------------------
# tests/test_obligation.py, on both packages
# ---------------------------------------------------------------------------


def test_issue_and_full_settle(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.output("iou", owed(a, a.ALICE, a.BOB, 1000))
        tx.command(a.ObligationIssue(1), a.ALICE.owning_key)
        tx.verifies()
    with l.transaction() as tx:
        tx.input("iou")
        tx.input(cash(a, a.ALICE, 1000))
        tx.output(cash(a, a.BOB, 1000))
        tx.command(a.ObligationSettle(a.Amount(1000, a.TOKEN)),
                   a.ALICE.owning_key)
        tx.command(a.CashMove(), a.ALICE.owning_key)
        tx.verifies()


def test_partial_settle_leaves_remainder(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.output(owed(a, a.ALICE, a.BOB, 400))
        tx.input(cash(a, a.ALICE, 600))
        tx.output(cash(a, a.BOB, 600))
        tx.command(a.ObligationSettle(a.Amount(600, a.TOKEN)),
                   a.ALICE.owning_key)
        tx.command(a.CashMove(), a.ALICE.owning_key)
        tx.verifies()


def test_settle_without_cash_rejected(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.command(a.ObligationSettle(a.Amount(1000, a.TOKEN)),
                   a.ALICE.owning_key)
        tx.fails_with("cash moves to each beneficiary")


def test_settle_underpayment_rejected(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.input(cash(a, a.ALICE, 500))
        tx.output(cash(a, a.BOB, 500))
        tx.command(a.ObligationSettle(a.Amount(1000, a.TOKEN)),
                   a.ALICE.owning_key)
        tx.command(a.CashMove(), a.ALICE.owning_key)
        tx.fails_with("cash moves to each beneficiary")


def test_move_reassigns_beneficiary_only(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.output(owed(a, a.ALICE, a.BANK, 1000))
        tx.command(a.ObligationMove(), a.BOB.owning_key)
        tx.verifies()
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.output(owed(a, a.BANK, a.BOB, 1000))
        tx.command(a.ObligationMove(), a.BOB.owning_key)
        tx.fails_with("terms other than the beneficiary")


def test_bilateral_netting(api):
    a = api
    l = a.ledger(a.NOTARY)
    both = (a.ALICE.owning_key, a.BOB.owning_key)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.input(owed(a, a.BOB, a.ALICE, 300))
        tx.output(owed(a, a.ALICE, a.BOB, 700))
        tx.command(a.ObligationNet(), *both)
        tx.verifies()
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 500))
        tx.input(owed(a, a.BOB, a.ALICE, 500))
        tx.command(a.ObligationNet(), *both)
        tx.verifies()
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.input(owed(a, a.BOB, a.ALICE, 300))
        tx.output(owed(a, a.ALICE, a.BOB, 900))
        tx.command(a.ObligationNet(), *both)
        tx.fails_with("right direction and size")
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.input(owed(a, a.BOB, a.ALICE, 300))
        tx.output(owed(a, a.ALICE, a.BOB, 700))
        tx.command(a.ObligationNet(), a.ALICE.owning_key)
        tx.fails_with("both parties signed")


def _sar(a, state, seed):
    return a.StateAndRef(a.TransactionState(state, a.NOTARY),
                         a.StateRef(a.SecureHash.sha256(seed), 0))


def test_generate_settle_roundtrip(api):
    a = api
    iou = _sar(a, owed(a, a.ALICE, a.BOB, 1000), b"iou")
    money = _sar(a, cash(a, a.ALICE, 1500), b"cash")
    tx = a.TransactionBuilder(notary=a.NOTARY)
    a.Obligation.generate_settle(tx, [iou], [money], a.Amount(600, a.TOKEN))
    l = a.ledger(a.NOTARY)
    with l.transaction() as t:
        for out in tx.outputs:
            t.output(out.data)
        t.input(iou.state.data)
        t.input(money.state.data)
        for cmd in tx.commands:
            t.command(cmd.value, *cmd.signers)
        t.verifies()


def test_move_with_multiple_obligors_in_one_group(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 100))
        tx.input(owed(a, a.BANK, a.BOB, 50))
        tx.output(owed(a, a.ALICE, a.NOTARY, 100))
        tx.output(owed(a, a.BANK, a.NOTARY, 50))
        tx.command(a.ObligationMove(), a.BOB.owning_key)
        tx.verifies()


def test_settle_cannot_reassign_remainder_obligor(api):
    a = api
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.output(owed(a, a.EVE, a.BOB, 400))
        tx.input(cash(a, a.ALICE, 600))
        tx.output(cash(a, a.BOB, 600))
        tx.command(a.ObligationSettle(a.Amount(600, a.TOKEN)),
                   a.ALICE.owning_key)
        tx.command(a.CashMove(), a.ALICE.owning_key)
        tx.fails_with("original obligor")


def test_net_command_does_not_hijack_unrelated_group(api):
    a = api
    other = a.Issued(a.ALICE.ref(b"\x02"), "GBP")
    l = a.ledger(a.NOTARY)
    with l.transaction() as tx:
        tx.input(owed(a, a.ALICE, a.BOB, 1000))
        tx.input(owed(a, a.BOB, a.ALICE, 300))
        tx.output(owed(a, a.ALICE, a.BOB, 700))
        tx.command(a.ObligationNet(), a.ALICE.owning_key, a.BOB.owning_key)
        tx.input(owed(a, a.ALICE, a.BOB, 100, other))
        tx.input(owed(a, a.BANK, a.BOB, 50, other))
        tx.output(owed(a, a.ALICE, a.NOTARY, 100, other))
        tx.output(owed(a, a.BANK, a.NOTARY, 50, other))
        tx.command(a.ObligationMove(), a.BOB.owning_key)
        tx.verifies()


def test_generate_settle_rejects_mixed_pairs(api):
    a = api
    iou1 = _sar(a, owed(a, a.ALICE, a.BOB, 500), b"a")
    iou2 = _sar(a, owed(a, a.BANK, a.BOB, 500), b"b")
    tx = a.TransactionBuilder(notary=a.NOTARY)
    with pytest.raises(ValueError, match="single .obligor, beneficiary."):
        a.Obligation.generate_settle(tx, [iou1, iou2], [],
                                     a.Amount(600, a.TOKEN))


# ---------------------------------------------------------------------------
# One transaction of each lifecycle, built by both packages
# ---------------------------------------------------------------------------


def _lifecycle(a, kind):
    """A signed transaction of ``kind``, built only through the package's
    generators and builder."""
    tb = a.TransactionBuilder(notary=a.NOTARY)
    if kind == "issue":
        tb = a.Obligation.generate_issue(
            a.ALICE.owning_key, a.BOB.owning_key, a.Amount(1000, a.TOKEN),
            a.NOTARY, nonce=7)
        signers = ("Alice",)
    elif kind == "move":
        sar = _sar(a, owed(a, a.ALICE, a.BOB, 1000), b"iou")
        tb.add_input_state(sar)
        cmd, moved = sar.state.data.with_new_owner(a.BANK.owning_key)
        tb.add_output_state(moved)
        tb.add_command(a.Command(cmd, (a.BOB.owning_key,)))
        signers = ("Bob",)
    elif kind in ("settle", "underpaid"):
        iou = _sar(a, owed(a, a.ALICE, a.BOB, 1000), b"iou")
        money = _sar(a, cash(a, a.ALICE, 1500), b"cash")
        a.Obligation.generate_settle(tb, [iou], [money],
                                     a.Amount(600, a.TOKEN))
        if kind == "underpaid":  # claim more than the cash pays
            tb.commands[-1] = a.Command(
                a.ObligationSettle(a.Amount(700, a.TOKEN)),
                tb.commands[-1].signers)
        signers = ("Alice",)
    elif kind == "net":
        a.Obligation.generate_net(tb, [
            _sar(a, owed(a, a.ALICE, a.BOB, 1000), b"ab"),
            _sar(a, owed(a, a.BOB, a.ALICE, 300), b"ba")])
        signers = ("Alice", "Bob")
    else:
        raise ValueError(kind)
    for name in signers:
        tb.sign_with(a.keys[name])
    return tb.to_signed_transaction(check_sufficient_signatures=False)


def _verdict(a, stx, inputs):
    """The contract's verdict on ``stx``'s components with its inputs'
    states (the StateAndRefs the builder consumed), through the ledger
    DSL."""
    try:
        with a.ledger(a.NOTARY).transaction() as t:
            for sar in inputs:
                t.input(sar.state.data)
            for out in stx.tx.outputs:
                t.output(out.data)
            for cmd in stx.tx.commands:
                t.command(cmd.value, *cmd.signers)
            t.verifies()
        return "verifies"
    except Exception as e:  # noqa: BLE001 -- the verdict is the record
        return f"{type(e).__name__}: {e}"


LIFECYCLE_INPUTS = {
    "issue": [], "move": [("iou", 1000, "Alice", "Bob")],
    "settle": [("iou", 1000, "Alice", "Bob"), ("cash", 1500, "Alice")],
    "underpaid": [("iou", 1000, "Alice", "Bob"), ("cash", 1500, "Alice")],
    "net": [("ab", 1000, "Alice", "Bob"), ("ba", 300, "Bob", "Alice")],
}


def _inputs(a, kind):
    out = []
    for spec in LIFECYCLE_INPUTS[kind]:
        seed = spec[0].encode()
        if spec[0] == "cash":
            out.append(_sar(a, cash(a, getattr(a, spec[2].upper()), spec[1]),
                            seed))
        else:
            out.append(_sar(a, owed(a, getattr(a, spec[2].upper()),
                                    getattr(a, spec[3].upper()), spec[1]),
                            seed))
    return out


@pytest.mark.parametrize("kind", sorted(LIFECYCLE_INPUTS))
def test_lifecycle_wire_bytes_ids_and_verdicts_equal(kind):
    made = {}
    for pkg in PKGS:
        a = api_of(pkg)
        stx = _lifecycle(a, kind)
        made[pkg] = (a.serialize(stx).bytes, bytes(stx.id.bytes),
                     _verdict(a, stx, _inputs(a, kind)))
    port, ref = made["corda_tpu_torch"], made["corda_tpu"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert (port[2] == "verifies") is (kind != "underpaid"), port[2]


def test_port_decodes_the_references_obligation_transaction():
    ref, port = api_of("corda_tpu"), api_of("corda_tpu_torch")
    blob = ref.serialize(_lifecycle(ref, "net"))
    back = _m("corda_tpu_torch", "serialization.codec").deserialize(blob.bytes)
    assert type(back.tx.outputs[0].data) is port.ObligationState
    assert port.serialize(back).bytes == blob.bytes


# ---------------------------------------------------------------------------
# The chip phase's workload, cut to 40 transactions, through both notaries
# ---------------------------------------------------------------------------


def jax_api() -> SimpleNamespace:
    """obligation_load's ``port_api()`` with each name from the JAX
    package's module of the same path."""
    out = {}
    for name, obj in vars(ol.port_api()).items():
        module = importlib.import_module(
            obj.__module__.replace("corda_tpu_torch.", "corda_tpu.", 1))
        out[name] = getattr(module, obj.__name__)
    return SimpleNamespace(**out)


@pytest.fixture(scope="module")
def workload_runs():
    from corda_tpu_torch.crypto import ref_ed25519

    runs = {}
    for pkg, api in (("corda_tpu", jax_api()),
                     ("corda_tpu_torch", ol.port_api())):
        verifier = _m(pkg, "crypto.provider").CpuVerifier
        net, notary, alice, bob = ol.make_network(api, verifier())
        w = ol.build_obligations(api, notary, alice, bob, 40, 3, 5)
        jobs, spans = ol.signature_jobs(api, w)
        mask = [bool(x) for x in verifier().verify_batch(jobs)]
        oracle = [ref_ed25519.verify(j.pubkey, j.message, j.sig)
                  for j in jobs] if pkg == "corda_tpu_torch" else None
        run = ol.run_obligations(api, net, notary, alice, bob, w)
        runs[pkg] = dict(run, workload=w, mask=mask, oracle=oracle,
                         spans=spans, wire=[api_of(pkg).serialize(s).bytes
                                            for s in w.txs])
    return runs


def test_workload_wire_bytes_equal(workload_runs):
    port, ref = workload_runs["corda_tpu_torch"], workload_runs["corda_tpu"]
    assert port["wire"] == ref["wire"]
    assert len(port["workload"].txs) == 40
    assert port["workload"].bad == ref["workload"].bad


def test_workload_mask_equals_oracle_and_reference(workload_runs):
    port, ref = workload_runs["corda_tpu_torch"], workload_runs["corda_tpu"]
    assert port["mask"] == port["oracle"] == ref["mask"]
    assert port["mask"].count(False) == 3


def test_workload_outcomes_equal_and_predicted(workload_runs):
    port, ref = workload_runs["corda_tpu_torch"], workload_runs["corda_tpu"]
    assert port["outcomes"] == ref["outcomes"]
    assert port["tx_ids"] == ref["tx_ids"]
    want = ol.expected_ok(port["workload"], port["spans"], port["mask"])
    assert [o[0] == "ok" for o in port["outcomes"]] == want
    assert port["notarised"] == sum(want) < len(want)
    w = port["workload"]
    for k, o in zip(w.with_inputs, port["outcomes"]):
        if k in w.bad:
            assert o[0] != "ok"
    assert port["committed_count"] == ref["committed_count"]


def test_workload_n_must_be_whole_groups():
    api = ol.port_api()
    fake = SimpleNamespace(identity=None, key=None)
    with pytest.raises(ValueError):
        ol.build_obligations(api, fake, fake, fake, 6, 0, 1)


def test_tampered_byte_changes_only_its_signature():
    api = ol.port_api()
    from corda_tpu_torch.crypto.provider import CpuVerifier

    net, notary, alice, bob = ol.make_network(api, CpuVerifier())
    clean = ol.build_obligations(api, notary, alice, bob, 8, 0, 9)
    dirty = ol.build_obligations(api, notary, alice, bob, 8, 2, 9)
    for k, (c, d) in enumerate(zip(clean.txs, dirty.txs)):
        assert c.id == d.id
        diff = [i for i, (x, y) in enumerate(zip(c.sigs, d.sigs))
                if x.bytes != y.bytes]
        assert len(diff) == (1 if k in dirty.bad else 0)
