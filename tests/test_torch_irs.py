"""The port's IRS over the network (corda_tpu_torch/finance/irs.py on the
universal contract, the rate oracle's tear-off signature, the notary)
against the JAX package's: the mirror of tests/test_irs_network.py, each
case run on both packages from MockNetwork's counter keys and one fixed
instant, the issue, fixing and settlement transactions byte-equal, the
kill-at-every-step cases included; then the chip phase's IRS workload
(corda_tpu_torch/testing/simm_load.run_swaps) at a small size, equal
between the packages.
"""

import datetime as dt
import importlib
import os
import sys

import pytest

from corda_tpu_torch.contracts.structures import now_micros
from corda_tpu_torch.testing import simm_load as sl

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_oracle import jax_api  # noqa: E402

PKGS = ("corda_tpu", "corda_tpu_torch")
START = (dt.date(2016, 9, 1) - dt.date(1970, 1, 1)).days
END = (dt.date(2018, 9, 1) - dt.date(1970, 1, 1)).days
SCALE = 10_000
RATE = SCALE  # 1.0%


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.fixture()
def fixed_clock(monkeypatch):
    """One instant for both packages' IrsSettleFlow (its timestamp window
    is read from now_micros), so their settlements are byte-equal."""
    now = now_micros()
    for pkg in PKGS:
        monkeypatch.setattr(_m(pkg, "finance.irs"), "now_micros",
                            lambda: now)
    return now


def _net(pkg):
    return _m(pkg, "testing.mock_network").MockNetwork(
        verifier=_m(pkg, "crypto.provider").CpuVerifier())


def build_network(pkg, network):
    """tests/test_irs_network.py:43-64: a simple notary, ACME, HighSt and
    an Oracle holding 1.0% for LIBOR 3M on the start day; the swap issued
    by HighSt, both legs signing, and finalised."""
    oracle_mod = _m(pkg, "flows.oracle")
    notary = network.create_notary_node("Notary", validating=False)
    acme = network.create_node("ACME")
    highst = network.create_node("HighSt")
    oracle_node = network.create_node("Oracle")
    oracle_mod.RateOracle(oracle_node.smm, oracle_node.key,
                          {oracle_mod.FixOf("LIBOR", START, "3M"): RATE})
    swap = _m(pkg, "finance.irs").interest_rate_swap(
        notional=50_000_000 * SCALE, currency="EUR",
        fixed_rate=SCALE // 2, floating_index="LIBOR", index_tenor="3M",
        oracle=oracle_node.identity, fixed_leg_payer=acme.identity,
        floating_leg_payer=highst.identity, start_day=START, end_day=END,
        frequency=_m(pkg, "finance.types").Tenor("3M"))
    builder = _m(pkg, "contracts.universal").generate_issue(
        swap, highst.identity.ref(b"\x01"), notary.identity)
    builder.sign_with(highst.key)
    builder.sign_with(acme.key)
    issue_stx = builder.to_signed_transaction()
    h = highst.start_flow(_m(pkg, "flows.finality").FinalityFlow(
        issue_stx, (highst.identity, acme.identity)))
    network.run_network()
    h.result.result()
    return notary, acme, highst, oracle_node, issue_stx


def _full_period(pkg):
    u = _m(pkg, "contracts.universal")
    irs = _m(pkg, "finance.irs")
    s = _m(pkg, "contracts.structures")
    serialize = _m(pkg, "serialization.codec").serialize
    net = _net(pkg)
    try:
        notary, acme, highst, oracle_node, issue_stx = build_network(pkg, net)
        for node in (acme, highst):
            assert any(isinstance(x.state.data.details, u.RollOut) for x in
                       node.services.vault_service.current_vault.states)
        h = highst.start_flow(irs.IrsFixFlow(
            s.StateRef(issue_stx.id, 0), oracle_node.identity,
            acme.identity))
        net.run_network()
        fixed_stx = h.result.result()
        oracle_keys = oracle_node.identity.owning_key.keys
        assert any(sig.by in oracle_keys for sig in fixed_stx.sigs)

        h2 = acme.start_flow(irs.IrsSettleFlow(
            s.StateRef(fixed_stx.id, 0), highst.identity))
        net.run_network()
        settle_stx = h2.result.result()
        outs = [o.data.details for o in settle_stx.tx.outputs]
        transfers = [d for d in outs if isinstance(d, u.Transfer)]
        rolls = [d for d in outs if isinstance(d, u.RollOut)]
        assert len(transfers) == 2 and len(rolls) == 1
        to_acme = next(t for t in transfers if t.to_party == acme.identity)
        to_highst = next(t for t in transfers
                         if t.to_party == highst.identity)
        days = rolls[0].start_day - START
        assert u.eval_amount(None, to_acme.amount) == \
            (50_000_000 * SCALE * (SCALE // 2) * days) // (100 * SCALE * 365)
        assert u.eval_amount(None, to_highst.amount) == 0
        assert rolls[0].end_day == END
        assert notary.uniqueness_provider.committed_count == 2

        h3 = acme.start_flow(irs.IrsSettleFlow(
            s.StateRef(fixed_stx.id, 0), highst.identity))
        net.run_network()
        assert h3.result.result().id == settle_stx.id  # idempotent

        state = acme.services.load_state(s.StateRef(fixed_stx.id, 0))
        rogue = _m(pkg, "transactions.builder").TransactionBuilder(
            notary=notary.identity)
        rogue.add_input_state(s.StateAndRef(state,
                                            s.StateRef(fixed_stx.id, 0)))
        rogue.add_output_state(u.UniversalState(state.data.parts, rolls[0]))
        rogue.add_command(u.UAction("settle"), acme.identity.owning_key)
        rogue.sign_with(acme.key)
        h4 = acme.start_flow(_m(pkg, "flows.notary").NotaryClientFlow(
            rogue.to_signed_transaction(check_sufficient_signatures=False)))
        net.run_network()
        with pytest.raises(_m(pkg, "flows.notary").NotaryException):
            h4.result.result()
        return [serialize(x).bytes for x in (issue_stx, fixed_stx,
                                             settle_stx)]
    finally:
        net.stop_nodes()


def test_full_period_over_network(fixed_clock):
    assert _full_period("corda_tpu_torch") == _full_period("corda_tpu")


def _refusal(pkg, case):
    irs = _m(pkg, "finance.irs")
    s = _m(pkg, "contracts.structures")
    net = _net(pkg)
    try:
        notary, acme, highst, oracle_node, issue_stx = build_network(pkg, net)
        ref = s.StateRef(issue_stx.id, 0)
        if case == "wrong oracle":
            h = highst.start_flow(irs.IrsFixFlow(ref, acme.identity,
                                                 acme.identity))
        else:
            h = acme.start_flow(irs.IrsSettleFlow(ref, highst.identity))
        net.run_network()
        with pytest.raises(_m(pkg, "flows.api").FlowException) as info:
            h.result.result()
        assert notary.uniqueness_provider.committed_count == 0
        return str(info.value)
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("case,match", [
    ("wrong oracle", "different oracle"),
    ("unfixed", "fixing before settling")])
def test_refused_before_any_transaction(case, match):
    ours = _refusal("corda_tpu_torch", case)
    assert match in ours
    assert ours == _refusal("corda_tpu", case)


@pytest.mark.parametrize("pkg", PKGS)
def test_settle_before_period_end_fails_cleanly(pkg):
    oracle_mod = _m(pkg, "flows.oracle")
    irs = _m(pkg, "finance.irs")
    s = _m(pkg, "contracts.structures")
    net = _net(pkg)
    try:
        notary = net.create_notary_node("Notary", validating=False)
        acme = net.create_node("ACME2")
        highst = net.create_node("HighSt2")
        oracle_node = net.create_node("Oracle2")
        today = s.now_micros() // (86_400 * 1_000_000)
        fix_of = oracle_mod.FixOf("LIBOR", today, "3M")
        oracle_mod.RateOracle(oracle_node.smm, oracle_node.key,
                              {fix_of: RATE})
        swap = irs.interest_rate_swap(
            notional=1_000 * SCALE, currency="EUR", fixed_rate=SCALE // 2,
            floating_index="LIBOR", index_tenor="3M",
            oracle=oracle_node.identity, fixed_leg_payer=acme.identity,
            floating_leg_payer=highst.identity, start_day=today,
            end_day=today + 720,
            frequency=_m(pkg, "finance.types").Tenor("3M"))
        builder = _m(pkg, "contracts.universal").generate_issue(
            swap, highst.identity.ref(b"\x02"), notary.identity)
        builder.sign_with(highst.key)
        builder.sign_with(acme.key)
        issue_stx = builder.to_signed_transaction()
        h = highst.start_flow(_m(pkg, "flows.finality").FinalityFlow(
            issue_stx, (highst.identity, acme.identity)))
        net.run_network()
        h.result.result()
        h1 = highst.start_flow(irs.IrsFixFlow(
            s.StateRef(issue_stx.id, 0), oracle_node.identity,
            acme.identity))
        net.run_network()
        fixed_stx = h1.result.result()
        h2 = acme.start_flow(irs.IrsSettleFlow(
            s.StateRef(fixed_stx.id, 0), highst.identity))
        net.run_network()
        with pytest.raises(_m(pkg, "flows.api").FlowException,
                           match="not ended yet"):
            h2.result.result()
    finally:
        net.stop_nodes()


# --- TestIrsFixKillAtEveryStep (tests/test_irs_network.py:181-240) ---------


def _crash(pkg, crash_after, victim):
    """Start the fixing, restart ``victim`` after ``crash_after`` pump
    steps (a rebooted oracle node re-wires its RateOracle, which must
    restore the flows' ``rate-oracle`` checkpoint token), run to the end.
    Returns the committed count and each party's fixed-state blobs."""
    oracle_mod = _m(pkg, "flows.oracle")
    u = _m(pkg, "contracts.universal")
    serialize = _m(pkg, "serialization.codec").serialize
    net = _net(pkg)
    try:
        notary, acme, highst, oracle_node, issue_stx = build_network(pkg, net)
        highst.start_flow(_m(pkg, "finance.irs").IrsFixFlow(
            _m(pkg, "contracts.structures").StateRef(issue_stx.id, 0),
            oracle_node.identity, acme.identity))
        steps, crashed = 0, False
        while True:
            if not net.messaging_network.pump():
                if not sum(n.smm.flush_pending_verifies() for n in net.nodes):
                    break
            steps += 1
            if steps == crash_after and not crashed:
                crashed = True
                if victim == "fixer":
                    highst = highst.restart()
                else:
                    oracle_node = oracle_node.restart()
                    oracle_mod.RateOracle(
                        oracle_node.smm, oracle_node.key,
                        {oracle_mod.FixOf("LIBOR", START, "3M"): RATE})
        net.run_network()
        fixed = {}
        for node in (highst, acme):
            fixed[node.name] = sorted(
                serialize(x.state).bytes for x in
                node.services.vault_service.current_vault.states
                if isinstance(x.state.data.details, u.Actions))
        return notary.uniqueness_provider.committed_count, fixed
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("crash_after", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("victim", ["fixer", "oracle"])
def test_fixing_commits_once_whoever_crashes(crash_after, victim):
    committed, fixed = _crash("corda_tpu_torch", crash_after, victim)
    assert committed == 1
    assert all(len(blobs) == 1 for blobs in fixed.values()), fixed
    assert (committed, fixed) == _crash("corda_tpu", crash_after, victim)


# --- the chip phase's IRS workload at a small size --------------------------


def _swaps(api, verifier, n):
    net, *nodes = sl.make_irs_network(api, verifier, n)
    try:
        issues = sl.build_swaps(api, *nodes, n)
        return sl.run_swaps(api, net, nodes, issues)
    finally:
        net.stop_nodes()


def test_swaps_at_batch_equal_the_jax_package(fixed_clock):
    """simm_load's swaps (issue, fix through the oracle, settle, against a
    validating notary) succeed in the port and equal the JAX package's
    run: the fixings byte-equal, every settlement's transfers and outputs
    equal, the same inputs committed."""
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier

    n = 4
    ours = _swaps(sl.port_api(), CpuVerifier(), n)
    theirs = _swaps(jax_api(sl.port_api()), JaxCpuVerifier(), n)
    assert sl.check_swaps(sl.port_api(), ours, n) == []
    assert sl.swap_record(ours) == sl.swap_record(theirs)
    assert [o[1] for o in ours["settle"]["outcomes"]] == \
        [o[1] for o in theirs["settle"]["outcomes"]]  # the fixed clock
    for name in sl.IRS_NAMES:
        assert ours["nodes"][name]["verify_sigs"] == \
            theirs["nodes"][name]["verify_sigs"], name
