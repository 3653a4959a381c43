"""The port's fixable deal (corda_tpu_torch/finance/fixable_deal.py) against
the JAX package's: the mirror of tests/test_fixable_deal.py, the irs-demo
cycle (the scheduler launches FixingFlow on the fixing date, the flow
queries the rate oracle, gathers the oracle's tear-off signature and the
counterparty's, and finalises at the notary) over each package's own Nodes
on localhost TCP, the port's on its host tier; the contract's signer rules
on both packages; and the deal state byte-equal and decodable across the
packages.
"""

import dataclasses
import importlib
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_tcp_node import pump_until as jax_pump_until  # noqa: E402
from test_torch_tcp_node import pump_until  # noqa: E402

PKGS = ("corda_tpu", "corda_tpu_torch")
RATE = 4_2500
PUMPS = {"corda_tpu": jax_pump_until, "corda_tpu_torch": pump_until}
# The port's nodes verify on the host tier here ("torch", the card, is the
# port's default); the JAX package's take their own default.
VERIFIER = {"corda_tpu": {}, "corda_tpu_torch": {"verifier": "cpu"}}

_AGREE: dict = {}


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _agree_command(pkg):
    """The deal-creation command, registered once with ``pkg``'s codec."""
    if pkg not in _AGREE:
        @_m(pkg, "serialization.codec").register
        @dataclasses.dataclass(frozen=True)
        class _Agree(_m(pkg, "contracts.structures").TypeOnlyCommandData):
            pass

        _AGREE[pkg] = _Agree
    return _AGREE[pkg]


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduled_fixing_end_to_end(pkg, tmp_path):
    s = _m(pkg, "contracts.structures")
    fd = _m(pkg, "finance.fixable_deal")
    oracle_mod = _m(pkg, "flows.oracle")
    deal_mod = _m(pkg, "flows.deal")
    NodeConfig, Node = _m(pkg, "node.config").NodeConfig, _m(
        pkg, "node.node").Node
    pump = PUMPS[pkg]
    libor = oracle_mod.FixOf("LIBOR", 20_100, "3M")

    def boot(name, **kw):
        return Node(NodeConfig(name=name, base_dir=tmp_path / name,
                               network_map=tmp_path / "m.json",
                               **VERIFIER[pkg], **kw)).start()

    notary = boot("Notary", notary="simple")
    floater, fixed, oracle_node = boot("Floater"), boot("Fixed"), boot(
        "Oracle")
    nodes = [notary, floater, fixed, oracle_node]
    try:
        for n in nodes:
            n.refresh_netmap()
        oracle_mod.RateOracle(oracle_node.smm, oracle_node.key,
                              {libor: RATE})
        fd.install_fixing_acceptor(fixed.smm)
        fixed.smm.register_flow_initiator(
            "DealInstigatorFlow",
            lambda party: deal_mod.DealAcceptorFlow(party))
        deal = fd.FixableDealState(
            party_a=floater.identity, party_b=fixed.identity,
            oracle=oracle_node.identity, fix_of=libor,
            fix_at_micros=s.now_micros() + 700_000, notional=1_000_000)
        h = floater.start_flow(deal_mod.DealInstigatorFlow(
            fixed.identity, deal, _agree_command(pkg)(), notary.identity))
        pump(nodes, lambda: h.result.done)
        h.result.result()
        pump(nodes, lambda: floater.scheduler.next_scheduled is not None
             and fixed.scheduler.next_scheduled is not None)

        def deals(node):
            return [x.state.data for x in
                    node.services.vault_service.current_vault.states
                    if isinstance(x.state.data, fd.FixableDealState)]

        pump(nodes, lambda: all(
            len([d for d in deals(n) if d.fixed_value is not None]) == 1
            for n in (floater, fixed)), timeout=25.0)
        for node in (floater, fixed):
            got = deals(node)
            assert len(got) == 1 and got[0].fixed_value == RATE
            assert dataclasses.replace(got[0], fixed_value=None) == deal
        assert notary.uniqueness_provider.committed_count == 1
        assert floater.scheduler.next_scheduled is None
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_unilateral_fixing_rejected_at_contract_level(pkg):
    fd = _m(pkg, "finance.fixable_deal")
    oracle_mod = _m(pkg, "flows.oracle")
    keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
    a, b, o, n = (party.Party.of(name, keys.KeyPair.generate(
        bytes([k]) * 32).public) for name, k in (
        ("A", 0x91), ("B", 0x92), ("O", 0x93), ("N", 0x94)))
    libor = oracle_mod.FixOf("LIBOR", 20_100, "3M")
    deal = fd.FixableDealState(party_a=a, party_b=b, oracle=o, fix_of=libor,
                               fix_at_micros=1, notional=5)
    l = _m(pkg, "testing.ledger_dsl").ledger(n)
    for signers, error in (((a,), "both parties sign"),
                           ((a, b), "oracle attests")):
        with l.transaction() as tx:
            tx.input(deal)
            tx.output(dataclasses.replace(deal, fixed_value=999_999))
            tx.command(oracle_mod.Fix(libor, 999_999),
                       *[p.owning_key for p in signers])
            tx.fails_with(error)
    with l.transaction() as tx:
        tx.input(deal)
        tx.output(dataclasses.replace(deal, fixed_value=RATE))
        tx.command(oracle_mod.Fix(libor, RATE), a.owning_key, b.owning_key,
                   o.owning_key)
        tx.verifies()


def _deal_values(pkg):
    fd = _m(pkg, "finance.fixable_deal")
    keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
    a, b, o = (party.Party.of(name, keys.KeyPair.generate(
        bytes([k]) * 32).public) for name, k in (
        ("A", 0x91), ("B", 0x92), ("O", 0x93)))
    deal = fd.FixableDealState(
        party_a=a, party_b=b, oracle=o,
        fix_of=_m(pkg, "flows.oracle").FixOf("LIBOR", 20_100, "3M"),
        fix_at_micros=1_700_000_000_000_000, notional=1_000_000,
        uid=_m(pkg, "contracts.structures").UniqueIdentifier(
            external_id="deal", id=b"\x03" * 16))
    return [deal, dataclasses.replace(deal, fixed_value=RATE)]


def test_deal_state_is_byte_equal_both_ways():
    made = {pkg: _deal_values(pkg) for pkg in PKGS}
    for k in range(2):
        blobs = {pkg: _m(pkg, "serialization.codec").serialize(
            made[pkg][k]).bytes for pkg in PKGS}
        assert blobs["corda_tpu"] == blobs["corda_tpu_torch"]
        for pkg, other in (PKGS, PKGS[::-1]):
            back = _m(pkg, "serialization.codec").deserialize(blobs[other])
            assert back == made[pkg][k]
            assert type(back).__module__ == f"{pkg}.finance.fixable_deal"
    # The unfixed deal schedules its fixing; the fixed one nothing.
    for pkg in PKGS:
        ref = _m(pkg, "contracts.structures").StateRef(
            _m(pkg, "crypto.hashes").SecureHash.sha256(b"deal"), 0)
        unfixed, fixed = made[pkg]
        activity = unfixed.next_scheduled_activity(ref, None)
        assert type(activity).__module__ == f"{pkg}.node.services.scheduler"
        assert (activity.flow_name, activity.flow_args,
                activity.at_micros) == ("FixingFlow", (ref,),
                                        unfixed.fix_at_micros)
        assert fixed.next_scheduled_activity(ref, None) is None
