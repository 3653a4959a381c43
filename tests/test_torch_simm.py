"""The port's SIMM margin model and portfolio agreement
(corda_tpu_torch/tools/simm.py, tools/portfolio.py) against the JAX
package's: the mirror of tests/test_simm.py and of the two portfolio
cases of tests/test_schema_portfolio.py (:100, :155), each case run on
both packages; the margin of 100-trade portfolios equal for eight seeds;
the portfolio's wire types byte-equal and decoded by the other package;
then the chip phase's agreement workload
(corda_tpu_torch/testing/simm_load.run_valuations) at a small size, equal
between the packages, under the port's host tier and the plain versions.
"""

import dataclasses
import importlib
import os
import random
import sys

import pytest

from corda_tpu_torch.testing import simm_load as sl

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_oracle import jax_api  # noqa: E402

PKGS = ("corda_tpu", "corda_tpu_torch")
RATE = 2_5000


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _api(pkg):
    return sl.port_api() if pkg == "corda_tpu_torch" else jax_api(
        sl.port_api())


def _portfolio(pkg, n, seed=42):
    return sl.random_portfolio(_api(pkg), n, seed)


# --- the margin model (tests/test_simm.py:28-84) ----------------------------


@pytest.mark.parametrize("seed", range(8))
def test_initial_margin_equals_the_jax_package(seed):
    margins = {}
    for pkg in PKGS:
        simm = _m(pkg, "tools.simm")
        trades = _portfolio(pkg, 100, seed)
        curve = simm.curve_from_fix(RATE)
        margins[pkg] = (simm.initial_margin(trades, RATE),
                        simm.portfolio_sensitivities(trades, curve),
                        [simm.trade_pv(t, curve) for t in trades])
    assert margins["corda_tpu_torch"] == margins["corda_tpu"]
    assert margins["corda_tpu_torch"][0] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_margin_is_deterministic_and_integer(pkg):
    simm = _m(pkg, "tools.simm")
    trades = _portfolio(pkg, 100)
    a = simm.initial_margin(trades, RATE)
    assert isinstance(a, int) and a == simm.initial_margin(tuple(trades),
                                                           RATE) > 0
    shuffled = list(trades)
    random.Random(1).shuffle(shuffled)
    assert simm.initial_margin(tuple(shuffled), RATE) == a


@pytest.mark.parametrize("pkg", PKGS)
def test_sensitivity_structure_and_hedges(pkg):
    simm = _m(pkg, "tools.simm")
    T = simm.IRSTrade
    trade = T(1_000_000, 250, 3 * 365)
    curve = simm.curve_from_fix(RATE)
    sens = simm.trade_sensitivities(trade, curve)
    assert any(s < 0 for s in sens)
    assert all(sens[k] == 0 for k, t in enumerate(simm.TENOR_DAYS)
               if t > trade.maturity_days)
    assert simm.trade_sensitivities(T(-1_000_000, 250, 3 * 365), curve) == \
        tuple(-s for s in sens)
    a, b = (T(2_000_000, 250, 5 * 365),), (T(-2_000_000, 250, 5 * 365),)
    assert simm.initial_margin(a + b, RATE) == 0
    tilted = (T(2_000_000, 250, 5 * 365), T(-1_000_000, 250, 5 * 365))
    assert 0 < simm.initial_margin(tilted, RATE) < simm.initial_margin(a,
                                                                      RATE)


def test_model_constants_equal_the_jax_package():
    names = ("SCALE", "TENOR_DAYS", "RISK_WEIGHTS", "RHO_PCT",
             "CURVE_SLOPE_BP")
    ours, theirs = _m("corda_tpu_torch", "tools.simm"), _m("corda_tpu",
                                                            "tools.simm")
    assert [getattr(ours, n) for n in names] == \
        [getattr(theirs, n) for n in names]
    n = len(ours.TENOR_DAYS)
    for k in range(n):
        assert ours.RHO_PCT[k][k] == 100
        for j in range(n):
            assert ours.RHO_PCT[k][j] == ours.RHO_PCT[j][k]
            assert 0 < ours.RHO_PCT[k][j] <= 100


# --- agreement over the network (tests/test_simm.py:87-250,
# tests/test_schema_portfolio.py:100-152) ------------------------------------


def _network(pkg, verifier=None):
    oracle_mod = _m(pkg, "flows.oracle")
    verifier = verifier or _m(pkg, "crypto.provider").CpuVerifier()
    net = _m(pkg, "testing.mock_network").MockNetwork(verifier=verifier)
    notary = net.create_notary_node("Notary")
    a = net.create_node("Dealer A")
    b = net.create_node("Dealer B")
    o = net.create_node("Oracle")
    rate_ref = oracle_mod.FixOf("IM-RATE", 20_200, "1D")
    oracle_mod.RateOracle(o.smm, o.key, {rate_ref: RATE})
    _m(pkg, "tools.portfolio").install_simm_responder(b.smm)
    return net, notary, a, b, o, rate_ref


def _record(pkg, node_set, trades, nodes, uid=b"\x01" * 16):
    net, notary, a, b, o, rate_ref = node_set
    p = _m(pkg, "tools.portfolio")
    s = _m(pkg, "contracts.structures")
    state = p.PortfolioState(
        party_a=a.identity, party_b=b.identity, oracle=o.identity,
        rate_ref=rate_ref, trades=trades,
        uid=s.UniqueIdentifier(external_id="shared", id=uid))
    tx = _m(pkg, "transactions.builder").TransactionBuilder(
        notary=notary.identity)
    tx.add_output_state(state)
    tx.add_command(s.Command(p.ValueCommand(), (a.identity.owning_key,
                                                b.identity.owning_key)))
    tx.sign_with(a.key)
    tx.sign_with(b.key)
    stx = tx.to_signed_transaction()
    for node in nodes:
        node.record_transaction(stx)
    return stx


def _agree(pkg, trades):
    p = _m(pkg, "tools.portfolio")
    serialize = _m(pkg, "serialization.codec").serialize
    node_set = _network(pkg)
    net, _notary, a, b, _o, _ref = node_set
    try:
        stx = _record(pkg, node_set, trades, (a, b))
        handle = a.start_flow(p.SimmValuationFlow(stx.tx.out_ref(0).ref))
        net.run_network()
        final = handle.result.result()
        valued = [x.data for x in final.tx.outputs
                  if isinstance(x.data, p.PortfolioState)]
        assert valued[0].valuation == p.compute_valuation(trades, RATE) > 0
        for node in (a, b):
            assert node.services.storage_service.validated_transactions \
                .get_transaction(final.id) is not None
        return serialize(final).bytes
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("case", ["hundred random trades", "three trades"])
def test_portfolio_agrees_on_ledger(case):
    """tests/test_simm.py:87's 100-trade portfolio and
    tests/test_schema_portfolio.py:100's three trades: both dealers compute
    the same margin and the agreed valuation is notarised and recorded by
    both; the final transaction is byte-equal between the packages."""
    final = {}
    for pkg in PKGS:
        T = _m(pkg, "tools.simm").IRSTrade
        trades = (_portfolio(pkg, 100) if case == "hundred random trades"
                  else (T(1_000_000, 260, 5 * 365), T(-400_000, 240, 2 * 365),
                        T(250_000, 255, 10 * 365)))
        final[pkg] = _agree(pkg, trades)
    assert final["corda_tpu_torch"] == final["corda_tpu"]


@pytest.mark.parametrize("pkg", PKGS)
def test_tampered_portfolio_refuses_to_ledger(pkg):
    p = _m(pkg, "tools.portfolio")
    node_set = _network(pkg)
    net, _notary, a, b, _o, _ref = node_set
    try:
        trades = _portfolio(pkg, 10)
        stx_a = _record(pkg, node_set, trades, (a,))
        doctored = (dataclasses.replace(
            trades[0], notional=trades[0].notional * 2),) + trades[1:]
        _record(pkg, node_set, doctored, (b,))
        handle = a.start_flow(p.SimmValuationFlow(stx_a.tx.out_ref(0).ref))
        net.run_network()
        with pytest.raises(_m(pkg, "flows.api").FlowException):
            handle.result.result()
        assert len(b.services.vault_service.unconsumed_states(
            p.PortfolioState)) == 1
    finally:
        net.stop_nodes()


def test_diverging_valuations_refuse_to_ledger():
    """tests/test_simm.py:195 as simm_load runs it on the card: the
    dealers' margin runs disagree, the agree step refuses, nothing is
    committed and neither dealer's portfolio is valued; the same outcome
    in both packages."""
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier

    ours = sl.run_diverging_valuation(sl.port_api(), CpuVerifier(), 5)
    theirs = sl.run_diverging_valuation(jax_api(sl.port_api()),
                                        JaxCpuVerifier(), 5)
    assert ours == theirs
    assert ours["outcome"][0] == "FlowException"
    assert "diverge" in ours["outcome"][1]
    assert ours["committed"] == 0
    assert ours["valuations"] == {"Dealer A": [None], "Dealer B": [None]}
    assert _m("corda_tpu_torch", "tools.portfolio").compute_valuation(
        (), RATE) == 0  # the honest model is back


@pytest.mark.parametrize("pkg", PKGS)
def test_unilateral_valuation_rejected_at_contract_level(pkg):
    p = _m(pkg, "tools.portfolio")
    keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
    a, b, o, n = (party.Party.of(name, keys.KeyPair.generate(
        bytes([k]) * 32).public) for name, k in (
        ("A", 0x95), ("B", 0x96), ("O", 0x97), ("N", 0x98)))
    portfolio = p.PortfolioState(
        party_a=a, party_b=b, oracle=o,
        rate_ref=_m(pkg, "flows.oracle").FixOf("R", 1, "1D"),
        trades=(_m(pkg, "tools.simm").IRSTrade(100_000, 250, 365),))
    l = _m(pkg, "testing.ledger_dsl").ledger(n)
    with l.transaction() as tx:
        tx.input(portfolio)
        tx.output(dataclasses.replace(portfolio, valuation=1))
        tx.command(p.ValueCommand(), a.owning_key)  # B never signs
        tx.fails_with("both parties sign")
    with l.transaction() as tx:
        tx.input(portfolio)
        tx.output(dataclasses.replace(portfolio, valuation=1))
        tx.command(p.ValueCommand(), a.owning_key, b.owning_key)
        tx.verifies()


# --- the wire types ----------------------------------------------------------


def _portfolio_values(pkg):
    api = _api(pkg)
    p = api.portfolio
    keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
    a, b, o = (party.Party.of(name, keys.KeyPair.generate(
        bytes([k]) * 32).public) for name, k in (
        ("A", 0x95), ("B", 0x96), ("O", 0x97)))
    state = p.PortfolioState(
        party_a=a, party_b=b, oracle=o, rate_ref=sl.im_rate_ref(api),
        trades=sl.random_portfolio(api, 100, 3),
        uid=_m(pkg, "contracts.structures").UniqueIdentifier(
            external_id="p", id=b"\x02" * 16))
    return {"IRSTrade": state.trades[0], "ValueCommand": p.ValueCommand(),
            "PortfolioState": state,
            "valued": dataclasses.replace(state, valuation=123_456)}


def test_portfolio_types_are_byte_equal_both_ways():
    made = {pkg: _portfolio_values(pkg) for pkg in PKGS}
    for name in made["corda_tpu"]:
        blobs = {pkg: _m(pkg, "serialization.codec").serialize(
            made[pkg][name]).bytes for pkg in PKGS}
        assert blobs["corda_tpu"] == blobs["corda_tpu_torch"], name
        for pkg, other in (PKGS, PKGS[::-1]):
            back = _m(pkg, "serialization.codec").deserialize(blobs[other])
            assert back == made[pkg][name], name
            assert type(back).__module__.startswith(pkg + "."), name


# --- the chip phase's workload at a small size ------------------------------

N_PORTFOLIOS, TRADES = 4, 100


def _valuations(api, verifier):
    net, *nodes = sl.make_simm_network(api, verifier)
    try:
        creations = sl.build_portfolios(api, *nodes, N_PORTFOLIOS, TRADES)
        return sl.run_valuations(api, net, nodes, creations)
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("kind", ["cpu", "torch-cpu"])
def test_valuations_at_batch_equal_the_jax_package(kind):
    """simm_load's agreement at batch: every portfolio valued at its
    initial_margin and ledgered, the notary committing each creation, and
    every outcome, valuation, committed input and both dealers' vaults
    equal to the JAX package's run."""
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier

    verifier = (CpuVerifier() if kind == "cpu"
                else TorchVerifier(device="cpu", device_min_sigs=0))
    ours = _valuations(sl.port_api(), verifier)
    theirs = _valuations(jax_api(sl.port_api()), JaxCpuVerifier())
    assert [o[0] for o in ours["outcomes"]] == ["ok"] * N_PORTFOLIOS
    assert [o[1][1] for o in ours["outcomes"]] == ours["expected"]
    assert all(v > 0 for v in ours["expected"])
    assert len(ours["committed"]) == N_PORTFOLIOS
    assert sl.portfolio_record(ours) == sl.portfolio_record(theirs)
    for name in sl.SIMM_NAMES:
        assert ours["nodes"][name]["verify_sigs"] == \
            theirs["nodes"][name]["verify_sigs"], name
