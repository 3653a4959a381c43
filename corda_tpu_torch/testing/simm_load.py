"""BASELINE config 5 (samples/simm-valuation-demo) as workloads over
MockNetwork, with their outcome records.

Three parts, each as the JAX package's tests and bench compose them:

* **Tear-off proofs** (``tear_off``): bench_partial_merkle's transaction
  (bench.py:525-554), a DummyContract issue carrying eight ``Fix``
  commands, and the FilteredTransaction that reveals only them.
* **Portfolio agreement** (``make_simm_network``, ``build_portfolios``,
  ``run_valuations``): a validating Notary, Dealer A, Dealer B and an
  Oracle holding a ``RateOracle``; each portfolio is ``random_portfolio``
  (tests/test_simm.py's generator) recorded on both dealers by a
  two-signer creation transaction; every ``SimmValuationFlow`` starts at
  once from Dealer A and the network runs once. ``run_diverging_valuation``
  is tests/test_simm.py's diverging case: the two dealers' margin runs
  disagree, and nothing may reach the ledger.
* **IRS fixing and settlement** (``make_irs_network``, ``build_swaps``,
  ``run_swaps``): tests/test_irs_network.py's swap (50,000,000 EUR, fixed
  0.5% against 3M LIBOR, the oracle holding 1.0%) between ACME and HighSt,
  swap ``i`` starting ``i`` days after the test's start; the swaps are
  issued, fixed through the oracle (``IrsFixFlow``: the oracle signs a
  tear-off showing only the ``Fix`` command) and settled
  (``IrsSettleFlow``), one network run a stage, against a validating
  notary.

Every runner is passed the package it drives (``api``), as notary_load's
are; ``port_api()`` gives this package's own. Given the same verifier
answers, every package builds byte-equal transactions: identities come
from MockNetwork's key counter, portfolio ids from their index, and no
transaction but a settlement reads the clock (its timestamp window).
"""

from __future__ import annotations

import datetime as _dt
import random
import time
from types import SimpleNamespace

from .notary_load import TimedVerifier, _committed_of, _node_record, \
    _stages_before, start_timed

SIMM_NAMES = ("Notary", "Dealer A", "Dealer B", "Oracle")
IRS_NAMES = ("Notary", "ACME", "HighSt", "Oracle")
# tests/test_simm.py's rate: 2.5% in units of 0.01 bp, fixed for day 20,200.
IM_RATE_NAME, IM_RATE_DAY, IM_RATE_TENOR = "IM-RATE", 20_200, "1D"
IM_RATE = 2_5000
# tests/test_irs_network.py:30-33's terms; SCALE is universal.SCALE.
SCALE = 10_000
IRS_START = (_dt.date(2016, 9, 1) - _dt.date(1970, 1, 1)).days
IRS_END = (_dt.date(2018, 9, 1) - _dt.date(1970, 1, 1)).days
IRS_NOTIONAL = 50_000_000 * SCALE
IRS_FIXED_RATE = SCALE // 2  # 0.5%
IRS_LIBOR = SCALE            # 1.0%
DIVERGING = (1_000_000, 1_000_001)  # the two dealers' doctored margins
TEAR_OFF_COMMANDS = 8  # bench_partial_merkle's n_cmds


def port_api() -> SimpleNamespace:
    """This package's classes, functions and modules that the runners use."""
    from ..contracts import universal
    from ..contracts.structures import Command, StateRef, UniqueIdentifier
    from ..crypto.hashes import SecureHash
    from ..crypto.keys import KeyPair
    from ..crypto.party import Party
    from ..finance import irs
    from ..finance.types import Tenor
    from ..flows.finality import FinalityFlow
    from ..flows.oracle import Fix, FixOf, RateOracle
    from ..serialization.codec import serialize
    from ..tools import portfolio, simm
    from ..transactions.builder import TransactionBuilder
    from ..transactions.filtered import FilteredTransaction, FilterFuns
    from .dummies import DummyContract
    from .mock_network import MockNetwork

    return SimpleNamespace(
        MockNetwork=MockNetwork, Command=Command, StateRef=StateRef,
        UniqueIdentifier=UniqueIdentifier, SecureHash=SecureHash,
        KeyPair=KeyPair, Party=Party,
        Tenor=Tenor, FinalityFlow=FinalityFlow,
        Fix=Fix, FixOf=FixOf, RateOracle=RateOracle, serialize=serialize,
        TransactionBuilder=TransactionBuilder,
        FilteredTransaction=FilteredTransaction, FilterFuns=FilterFuns,
        DummyContract=DummyContract, universal=universal, irs=irs,
        portfolio=portfolio, simm=simm)


def _timed_nodes(net, names) -> list:
    """The validating notary (``names[0]``) and the other nodes, created in
    that order (MockNetwork's keys come from a counter, so every network made
    here has the same identities), each state machine's verifier a
    TimedVerifier over the network's."""
    nodes = [net.create_notary_node(names[0], validating=True)]
    nodes += [net.create_node(name) for name in names[1:]]
    for node in nodes:
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return nodes


def _outcome(handle, value=lambda final: bytes(final.id.bytes)) -> tuple:
    try:
        final = handle.result.result()
    except Exception as e:  # noqa: BLE001 -- the outcome is the record
        return (type(e).__name__, str(e))
    return ("ok", value(final))


def _stage(net, node, flows) -> dict:
    """Start every flow on ``node`` at once, run the network; the handles,
    the run's wall and each flow's start-to-result time."""
    starts, ends = [0.0] * len(flows), [0.0] * len(flows)
    handles = [start_timed(node, flow, starts, ends, k)
               for k, flow in enumerate(flows)]
    t0 = time.perf_counter()
    net.run_network()
    wall_s = time.perf_counter() - t0
    return {"handles": handles, "wall_s": wall_s,
            "flow_s": [e - s for s, e in zip(starts, ends)]}


# --- (a) tear-off proofs ------------------------------------------------


def tear_off(api) -> tuple:
    """bench_partial_merkle's (wtx, ftx): a DummyContract issue by P with
    TEAR_OFF_COMMANDS Fix commands of LIBOR 3M on days 20,000 + i at 42,500 + i,
    and its FilteredTransaction revealing only the Fix commands."""
    notary = api.Party.of("N", api.KeyPair.generate(b"\x41" * 32).public)
    party = api.Party.of("P", api.KeyPair.generate(b"\x42" * 32).public)
    builder = api.DummyContract.generate_initial(party.ref(b"\x01"), 1,
                                                 notary)
    for i in range(TEAR_OFF_COMMANDS):
        builder.add_command(api.Command(
            api.Fix(api.FixOf("LIBOR", 20_000 + i, "3M"), 42_500 + i),
            (party.owning_key,)))
    wtx = builder.to_wire_transaction()
    ftx = api.FilteredTransaction.build_merkle_transaction(
        wtx, api.FilterFuns(
            filter_commands=lambda c: isinstance(c.value, api.Fix)))
    return wtx, ftx


# --- (b) portfolio agreement --------------------------------------------


def random_portfolio(api, n: int, seed: int) -> tuple:
    """tests/test_simm.py's ``_random_portfolio``: ``n`` IRSTrades from
    ``random.Random(seed)``."""
    rng = random.Random(seed)
    return tuple(
        api.simm.IRSTrade(
            notional=rng.choice([-1, 1]) * rng.randrange(100_000, 5_000_000),
            fixed_rate_bp=rng.randrange(50, 600),
            maturity_days=rng.randrange(180, 10_000),
        )
        for _ in range(n))


def im_rate_ref(api):
    return api.FixOf(IM_RATE_NAME, IM_RATE_DAY, IM_RATE_TENOR)


def make_simm_network(api, verifier) -> tuple:
    """(net, notary, dealer_a, dealer_b, oracle) of SIMM_NAMES; the notary
    validates, the Oracle holds IM_RATE and Dealer B answers
    SimmValuationFlow."""
    net = api.MockNetwork(verifier=verifier)
    notary, a, b, o = _timed_nodes(net, SIMM_NAMES)
    api.RateOracle(o.smm, o.key, {im_rate_ref(api): IM_RATE})
    api.portfolio.install_simm_responder(b.smm)
    return net, notary, a, b, o


def build_portfolios(api, notary, a, b, o, n: int, trades: int) -> list:
    """``n`` unvalued PortfolioStates of ``trades`` trades each (portfolio
    ``i`` from seed ``i``, its id from ``i``), each created by a
    transaction both dealers sign and recorded on both."""
    out = []
    for i in range(n):
        state = api.portfolio.PortfolioState(
            party_a=a.identity, party_b=b.identity, oracle=o.identity,
            rate_ref=im_rate_ref(api), trades=random_portfolio(api, trades, i),
            uid=api.UniqueIdentifier(external_id=f"portfolio-{i}",
                                     id=i.to_bytes(16, "big")))
        tx = api.TransactionBuilder(notary=notary.identity)
        tx.add_output_state(state)
        tx.add_command(api.Command(api.portfolio.ValueCommand(), (
            a.identity.owning_key, b.identity.owning_key)))
        tx.sign_with(a.key)
        tx.sign_with(b.key)
        stx = tx.to_signed_transaction()
        a.record_transaction(stx)
        b.record_transaction(stx)
        out.append(stx)
    return out


def _valued(api, final) -> tuple:
    state = [s.data for s in final.tx.outputs
             if isinstance(s.data, api.portfolio.PortfolioState)][0]
    return (bytes(final.id.bytes), state.valuation)


def _portfolio_vault(api, node) -> list:
    return sorted(
        (bytes(s.ref.txhash.bytes), s.ref.index,
         api.serialize(s.state).bytes)
        for s in node.services.vault_service.unconsumed_states(
            api.portfolio.PortfolioState))


def run_valuations(api, net, nodes, creations: list) -> dict:
    """Start a SimmValuationFlow on Dealer A for every creation at once and
    run the network. Returns each flow's outcome (``("ok", (valued tx id,
    valuation))`` or the exception's name and message) and start-to-result
    time, the expected margins (``initial_margin`` of each portfolio at
    IM_RATE), the notary's committed inputs, both dealers' unconsumed
    portfolios and each node's verify record."""
    notary, a, b, _o = nodes
    before = _stages_before(nodes)
    run = _stage(net, a, [api.portfolio.SimmValuationFlow(
        stx.tx.out_ref(0).ref) for stx in creations])
    return {
        "outcomes": [_outcome(h, lambda f: _valued(api, f))
                     for h in run["handles"]],
        "expected": [api.simm.initial_margin(
            stx.tx.outputs[0].data.trades, IM_RATE) for stx in creations],
        "flow_s": run["flow_s"],
        "wall_s": run["wall_s"],
        "committed": _committed_of(notary),
        "vaults": {n.identity.name: _portfolio_vault(api, n) for n in (a, b)},
        "nodes": {n.identity.name: _node_record(n, before) for n in nodes},
    }


def run_diverging_valuation(api, verifier, trades: int) -> dict:
    """tests/test_simm.py's diverging case on its own network: the two
    dealers' margin runs return DIVERGING's two numbers (the portfolio
    module's ``compute_valuation`` replaced for the run), so the agree step
    must refuse. Returns the flow's outcome, the notary's committed count
    and each dealer's unconsumed portfolios' valuations."""
    net, notary, a, b, o = make_simm_network(api, verifier)
    module = api.portfolio
    honest = module.compute_valuation
    answers = iter(DIVERGING)
    try:
        creation = build_portfolios(api, notary, a, b, o, 1, trades)[0]
        module.compute_valuation = lambda _trades, _rate: next(answers)
        handle = a.start_flow(module.SimmValuationFlow(
            creation.tx.out_ref(0).ref))
        net.run_network()
        return {
            "outcome": _outcome(handle),
            "committed": len(_committed_of(notary)),
            "valuations": {
                n.identity.name: [s.state.data.valuation for s in
                                  n.services.vault_service.unconsumed_states(
                                      module.PortfolioState)]
                for n in (a, b)},
        }
    finally:
        module.compute_valuation = honest
        net.stop_nodes()


# --- (c) IRS fixing and settlement ----------------------------------------


def swap_fix_of(api, i: int):
    return api.FixOf("LIBOR", IRS_START + i, "3M")


def make_irs_network(api, verifier, n: int) -> tuple:
    """(net, notary, acme, highst, oracle) of IRS_NAMES; the notary
    validates and the Oracle holds IRS_LIBOR for each swap's first
    fixing."""
    net = api.MockNetwork(verifier=verifier)
    notary, acme, highst, oracle = _timed_nodes(net, IRS_NAMES)
    api.RateOracle(oracle.smm, oracle.key,
                   {swap_fix_of(api, i): IRS_LIBOR for i in range(n)})
    return net, notary, acme, highst, oracle


def build_swaps(api, notary, acme, highst, oracle, n: int) -> list:
    """``n`` issue transactions of tests/test_irs_network.py's swap, swap
    ``i`` running from IRS_START + i to IRS_END + i: ACME pays fixed,
    HighSt floating; both sign the issue."""
    out = []
    for i in range(n):
        swap = api.irs.interest_rate_swap(
            notional=IRS_NOTIONAL, currency="EUR", fixed_rate=IRS_FIXED_RATE,
            floating_index="LIBOR", index_tenor="3M",
            oracle=oracle.identity, fixed_leg_payer=acme.identity,
            floating_leg_payer=highst.identity, start_day=IRS_START + i,
            end_day=IRS_END + i, frequency=api.Tenor("3M"))
        builder = api.universal.generate_issue(
            swap, highst.identity.ref(b"\x01"), notary.identity)
        builder.sign_with(highst.key)
        builder.sign_with(acme.key)
        out.append(builder.to_signed_transaction())
    return out


def _settled(api, final) -> tuple:
    """A settlement's outputs: its RollOut remainder's start day and each
    Transfer as (to party's name, evaluated amount), sorted."""
    u = api.universal
    outs = [o.data.details for o in final.tx.outputs]
    transfers = sorted((t.to_party.name, u.eval_amount(None, t.amount))
                       for t in outs if isinstance(t, u.Transfer))
    rolls = [d for d in outs if isinstance(d, u.RollOut)]
    return (tuple(transfers), tuple((r.start_day, r.end_day) for r in rolls),
            tuple(api.serialize(o.data).bytes for o in final.tx.outputs))


def run_swaps(api, net, nodes, issues: list) -> dict:
    """Issue (FinalityFlow on HighSt), then one IrsFixFlow against the
    wrong oracle (ACME, which the product does not pin: refused before any
    transaction exists), then fix every swap (IrsFixFlow on HighSt against
    the Oracle) and settle every fixed swap (IrsSettleFlow on ACME), one
    network run a stage. Returns each stage's outcomes, per-flow times and
    wall, whether each fixing carries the oracle's signature, each
    settlement's transfers and remainder (``_settled``), the notary's
    committed inputs and each node's verify record."""
    notary, acme, highst, oracle = nodes
    before = _stages_before(nodes)
    stages = {}
    stages["issue"] = _stage(net, highst, [
        api.FinalityFlow(stx, (highst.identity, acme.identity))
        for stx in issues])
    wrong = _stage(net, highst, [api.irs.IrsFixFlow(
        api.StateRef(issues[0].id, 0), acme.identity, acme.identity)])
    stages["fix"] = _stage(net, highst, [api.irs.IrsFixFlow(
        api.StateRef(stx.id, 0), oracle.identity, acme.identity)
        for stx in issues])
    fixed = [h.result.result() for h in stages["fix"]["handles"]]
    stages["settle"] = _stage(net, acme, [api.irs.IrsSettleFlow(
        api.StateRef(stx.id, 0), highst.identity) for stx in fixed])
    oracle_keys = oracle.identity.owning_key.keys
    out = {k: {"outcomes": [_outcome(h) for h in v["handles"]],
               "flow_s": v["flow_s"], "wall_s": v["wall_s"]}
           for k, v in stages.items()}
    out["wrong_oracle"] = _outcome(wrong["handles"][0])
    out["fix"]["oracle_signed"] = [
        any(sig.by in oracle_keys for sig in stx.sigs) for stx in fixed]
    out["settle"]["settled"] = [
        _settled(api, h.result.result()) for h in stages["settle"]["handles"]
        if _outcome(h)[0] == "ok"]
    out["committed"] = _committed_of(notary)
    out["nodes"] = {n.identity.name: _node_record(n, before) for n in nodes}
    return out


def expected_settlement(api, i: int, next_start: int) -> tuple:
    """tests/test_irs_network.py:96-97: HighSt pays ACME the floating 1.0%
    less the fixed 0.5% on the notional over the first period, ACME pays
    HighSt nothing."""
    days = next_start - (IRS_START + i)
    return (("ACME", (IRS_NOTIONAL * IRS_FIXED_RATE * days)
             // (100 * SCALE * 365)), ("HighSt", 0))


def check_swaps(api, res: dict, n: int) -> list[str]:
    """What is wrong with ``run_swaps``' record of ``n`` swaps (empty when
    nothing is): every stage's flows succeeded, the wrong oracle was
    refused, every fixing carries the oracle's signature, every settlement
    pays what expected_settlement says, and the notary committed two
    inputs a swap."""
    bad = []
    for stage in ("issue", "fix", "settle"):
        failed = [o for o in res[stage]["outcomes"] if o[0] != "ok"]
        if failed or len(res[stage]["outcomes"]) != n:
            bad.append(f"{stage}: {len(failed)} failed, e.g. {failed[:2]}")
    if not (res["wrong_oracle"][0] == "FlowException"
            and "different oracle" in res["wrong_oracle"][1]):
        bad.append(f"wrong oracle not refused: {res['wrong_oracle']}")
    if not all(res["fix"]["oracle_signed"]):
        bad.append("a fixing lacks the oracle's signature")
    for i, (transfers, rolls, _blobs) in enumerate(res["settle"]["settled"]):
        if len(rolls) != 1 or rolls[0][1] != IRS_END + i or \
                transfers != expected_settlement(api, i, rolls[0][0]):
            bad.append(f"settlement {i}: {transfers} {rolls}")
            break
    if len(res["committed"]) != 2 * n:
        bad.append(f"{len(res['committed'])} committed, not {2 * n}")
    return bad


def portfolio_record(res: dict) -> dict:
    """What of ``run_valuations``' record a card run must share with a
    host run: outcomes, expected margins, commits and vaults."""
    return {k: res[k] for k in ("outcomes", "expected", "committed",
                                "vaults")}


def swap_record(res: dict) -> dict:
    """What of ``run_swaps``' record a card run must share with a host
    run: every stage's outcomes (a settlement's only by kind: its id
    covers a timestamp window read from the clock), the wrong oracle's
    refusal, the fixings' oracle signatures, the settlements' outputs and
    the committed inputs."""
    return {"issue": res["issue"]["outcomes"], "fix": res["fix"]["outcomes"],
            "oracle_signed": res["fix"]["oracle_signed"],
            "settle": [o[0] for o in res["settle"]["outcomes"]],
            "settled": res["settle"]["settled"],
            "wrong_oracle": res["wrong_oracle"],
            "committed": sorted(res["committed"])}
