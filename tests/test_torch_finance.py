"""The port's trade flows (corda_tpu_torch/finance/trade.py) and Commodity
contract against the JAX package's: the mirror of tests/test_finance.py's
TestTwoPartyTrade and TestCommodity, each case run on both packages from
the same keys, then the trader demo (BASELINE config 2) as
corda_tpu_torch/testing/notary_load.py runs it, over each package's
MockNetwork and over each package's Nodes on localhost TCP.

The port runs under its host tier (``CpuVerifier()``) and under the device
path's plain PyTorch versions (``TorchVerifier(device="cpu",
device_min_sigs=0)``); the JAX package under its CpuVerifier. Over
MockNetwork, from the same seed and the same ``now_us``, the two packages
must settle byte-equal transactions and hold byte-equal vaults. Over TCP,
where which coin a buyer's overlapping trades select depends on timing,
the vault contents (refs aside) and balances must be equal.
"""

import importlib
from types import SimpleNamespace

import pytest

from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu_torch.contracts.structures import now_micros
from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier
from corda_tpu_torch.testing import notary_load as nl

PORT_VERIFIERS = {
    "cpu": CpuVerifier,
    "torch-cpu": lambda: TorchVerifier(device="cpu", device_min_sigs=0),
}
USD = "USD"


def jax_api() -> SimpleNamespace:
    """notary_load's ``port_api()`` with each name taken from the JAX
    package's module of the same path."""
    out = {}
    for name, obj in vars(nl.port_api()).items():
        module = importlib.import_module(
            obj.__module__.replace("corda_tpu_torch.", "corda_tpu.", 1))
        out[name] = getattr(module, obj.__name__)
    return SimpleNamespace(**out)


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


# ---------------------------------------------------------------------------
# TwoPartyTradeFlow DvP end to end (tests/test_finance.py:170-273)
# ---------------------------------------------------------------------------


def _setup(pkg, verifier):
    net = _m(pkg, "testing.mock_network").MockNetwork(verifier=verifier)
    notary = net.create_notary_node("Notary", validating=True)
    seller = net.create_node("Seller")
    buyer = net.create_node("Buyer")
    return net, notary, seller, buyer


def _dvp(pkg, verifier):
    Amount = _m(pkg, "finance.amount").Amount
    cash = _m(pkg, "finance.cash")
    trade = _m(pkg, "finance.trade")
    DummyContract = _m(pkg, "testing.dummies").DummyContract
    codec = _m(pkg, "serialization.codec")
    net, notary, seller, buyer = _setup(pkg, verifier)
    try:
        # Buyer self-issues cash (as a cash issuer) and records it.
        cash_issue = cash.Cash.generate_issue(
            Amount(1_000, USD), buyer.identity.ref(b"\x01"),
            buyer.identity.owning_key, notary.identity)
        cash_issue.sign_with(buyer.key)
        buyer.record_transaction(cash_issue.to_signed_transaction())

        # Seller owns a dummy asset.
        asset_issue = DummyContract.generate_initial(
            seller.identity.ref(b"\x02"), 42, notary.identity)
        asset_issue.sign_with(seller.key)
        asset_stx = asset_issue.to_signed_transaction()
        seller.record_transaction(asset_stx)
        asset = asset_stx.tx.out_ref(0)

        buyer.register_initiated_flow(
            "SellerFlow",
            lambda party: trade.BuyerFlow(party, Amount(800, USD),
                                          notary.identity))
        handle = seller.start_flow(
            trade.SellerFlow(buyer.identity, asset, Amount(750, USD)))
        net.run_network()
        final = handle.result.result()

        # Atomic settlement: the final tx moves BOTH legs.
        wtx = final.tx
        assert asset.ref in wtx.inputs
        asset_outs = [o.data for o in wtx.outputs
                      if not isinstance(o.data, cash.CashState)]
        assert [o.owner for o in asset_outs] == [buyer.identity.owning_key]
        paid = sum(o.data.amount.quantity for o in wtx.outputs
                   if isinstance(o.data, cash.CashState)
                   and o.data.owner == seller.identity.owning_key)
        assert paid == 750
        # Notary committed the inputs exactly once.
        assert notary.uniqueness_provider.committed_count == len(wtx.inputs)
        # Both sides recorded the final transaction (broadcast).
        for node in (seller, buyer):
            assert node.services.storage_service.validated_transactions \
                .get_transaction(final.id) is not None
        # Buyer's vault: asset in, spent cash out, change in.
        buyer_states = buyer.services.vault_service.current_vault.states
        cash_left = sum(s.state.data.amount.quantity for s in buyer_states
                        if isinstance(s.state.data, cash.CashState))
        assert cash_left == 250
        return codec.serialize(final).bytes
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("kind", sorted(PORT_VERIFIERS))
def test_dvp_trade_settles_atomically(kind):
    assert _dvp("corda_tpu_torch", PORT_VERIFIERS[kind]()) == \
        _dvp("corda_tpu", JaxCpuVerifier())


def _too_high(pkg, verifier):
    Amount = _m(pkg, "finance.amount").Amount
    trade = _m(pkg, "finance.trade")
    DummyContract = _m(pkg, "testing.dummies").DummyContract
    net, notary, seller, buyer = _setup(pkg, verifier)
    try:
        asset_issue = DummyContract.generate_initial(
            seller.identity.ref(b"\x02"), 43, notary.identity)
        asset_issue.sign_with(seller.key)
        asset_stx = asset_issue.to_signed_transaction()
        seller.record_transaction(asset_stx)

        buyer.register_initiated_flow(
            "SellerFlow",
            lambda party: trade.BuyerFlow(party, Amount(100, USD),
                                          notary.identity))
        handle = seller.start_flow(trade.SellerFlow(
            buyer.identity, asset_stx.tx.out_ref(0), Amount(750, USD)))
        net.run_network()
        with pytest.raises(Exception) as info:
            handle.result.result()
        assert notary.uniqueness_provider.committed_count == 0
        return type(info.value).__name__
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("kind", sorted(PORT_VERIFIERS))
def test_trade_rejected_when_price_too_high(kind):
    assert _too_high("corda_tpu_torch", PORT_VERIFIERS[kind]()) == \
        _too_high("corda_tpu", JaxCpuVerifier())


def test_buyer_without_cash_fails_the_trade():
    """A buyer whose vault cannot cover the price refuses in generate_spend
    (InsufficientBalanceException) and nothing is committed, as in the
    JAX package."""
    outcomes = []
    for pkg, verifier in (("corda_tpu", JaxCpuVerifier()),
                          ("corda_tpu_torch", CpuVerifier())):
        Amount = _m(pkg, "finance.amount").Amount
        trade = _m(pkg, "finance.trade")
        DummyContract = _m(pkg, "testing.dummies").DummyContract
        net, notary, seller, buyer = _setup(pkg, verifier)
        try:
            issue = DummyContract.generate_initial(
                seller.identity.ref(b"\x03"), 44, notary.identity)
            issue.sign_with(seller.key)
            stx = issue.to_signed_transaction()
            seller.record_transaction(stx)
            buyer.register_initiated_flow(
                "SellerFlow", lambda party: trade.BuyerFlow(
                    party, Amount(800, USD), notary.identity))
            handle = seller.start_flow(trade.SellerFlow(
                buyer.identity, stx.tx.out_ref(0), Amount(750, USD)))
            net.run_network()
            with pytest.raises(Exception) as info:
                handle.result.result()
            assert notary.uniqueness_provider.committed_count == 0
            assert len(buyer.services.vault_service.softlocks) == 0
            outcomes.append(type(info.value).__name__)
        finally:
            net.stop_nodes()
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# CommodityContract (tests/test_finance.py:276-348)
# ---------------------------------------------------------------------------


def _commodity_parties(pkg):
    keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
    return tuple(party.Party.of(name, keys.KeyPair.generate(
        bytes([b]) * 32).public) for name, b in (
        ("Warehouse", 0x71), ("Alice", 0x72), ("Bob", 0x73), ("N", 0x74)))


@pytest.mark.parametrize("pkg", ["corda_tpu", "corda_tpu_torch"])
def test_commodity_issue_move_exit_lifecycle(pkg):
    Issued = _m(pkg, "contracts.structures").Issued
    fin = _m(pkg, "finance")
    Amount, Commodity, CommodityState = (fin.Amount, fin.Commodity,
                                         fin.CommodityState)
    COMMODITY = _m(pkg, "finance.commodity").COMMODITY_PROGRAM_ID
    ledger = _m(pkg, "testing.ledger_dsl").ledger

    issuer, alice, bob, notary = _commodity_parties(pkg)
    gold = Commodity("XAU", "Gold", 3)
    token = Issued(issuer.ref(b"\x01"), gold)
    l = ledger(notary)

    # Issue 100oz to Alice: issuer signs.
    with l.transaction() as tx:
        tx.output(CommodityState(Amount(100, token), alice.owning_key))
        tx.command(COMMODITY.make_issue_command(1), issuer.owning_key)
        tx.verifies()

    # Move 100oz Alice -> Bob: conserved, Alice signs.
    with l.transaction() as tx:
        tx.input(CommodityState(Amount(100, token), alice.owning_key))
        tx.output(CommodityState(Amount(100, token), bob.owning_key))
        tx.command(COMMODITY.make_move_command(), alice.owning_key)
        tx.verifies()

    # A move that mints is rejected by conservation.
    with l.transaction() as tx:
        tx.input(CommodityState(Amount(100, token), alice.owning_key))
        tx.output(CommodityState(Amount(150, token), bob.owning_key))
        tx.command(COMMODITY.make_move_command(), alice.owning_key)
        tx.fails_with("amounts balance")

    # Exit burns with issuer + owner signatures.
    with l.transaction() as tx:
        tx.input(CommodityState(Amount(100, token), bob.owning_key))
        tx.output(CommodityState(Amount(40, token), bob.owning_key))
        tx.command(COMMODITY.make_exit_command(Amount(60, token)),
                   bob.owning_key, issuer.owning_key)
        tx.verifies()


def _spend(pkg):
    s = _m(pkg, "contracts.structures")
    fin = _m(pkg, "finance")
    SecureHash = _m(pkg, "crypto.hashes").SecureHash
    COMMODITY = _m(pkg, "finance.commodity").COMMODITY_PROGRAM_ID
    TransactionBuilder = _m(pkg, "transactions.builder").TransactionBuilder
    codec = _m(pkg, "serialization.codec")

    issuer, alice, bob, notary = _commodity_parties(pkg)
    oil = fin.Commodity("OIL")
    token = s.Issued(issuer.ref(b"\x02"), oil)

    def sar(i, qty):
        return s.StateAndRef(
            s.TransactionState(
                fin.CommodityState(fin.Amount(qty, token), alice.owning_key),
                notary),
            s.StateRef(SecureHash.sha256(bytes([i])), 0))

    tx = TransactionBuilder(notary=notary)
    owners = COMMODITY.generate_spend(
        tx, fin.Amount(130, oil), bob.owning_key, [sar(1, 100), sar(2, 100)])
    assert owners == [alice.owning_key]
    outs = [o.data for o in tx.outputs]
    quantities = sorted(
        (o.amount.quantity, o.owner == bob.owning_key) for o in outs)
    assert quantities == [(70, False), (130, True)]  # payment + change
    return [codec.serialize(o).bytes for o in tx.outputs]


def test_commodity_generate_spend_selects_and_returns_change():
    assert _spend("corda_tpu_torch") == _spend("corda_tpu")


# ---------------------------------------------------------------------------
# The trader demo (BASELINE config 2) as notary_load runs it
# ---------------------------------------------------------------------------

TRADES, SEED = 6, 20261018


def _mock_trades(api, verifier, now_us, in_flight):
    net, notary, buyer, seller = nl.make_trade_network(api, verifier)
    try:
        trades = nl.build_trades(api, notary, buyer, seller, TRADES, SEED,
                                 now_us)
        res = nl.run_mock_trades(api, net, notary, buyer, seller, trades,
                                 in_flight)
        res["issues"] = [api.serialize(s).bytes for s in trades.issues]
        res["cash"] = [api.serialize(s).bytes for s in trades.cash]
        return res
    finally:
        net.stop_nodes()


def _check_trades(res):
    assert [o[0] for o in res["outcomes"]] == ["ok"] * TRADES
    assert res["settled"] == TRADES
    assert res["committed"] == res["trade_inputs"]
    assert len(res["committed"]) == 2 * TRADES  # a paper and a coin each
    buyer, seller = res["vaults"]["BankA"], res["vaults"]["BankB"]
    assert buyer["papers"] == TRADES and seller["papers"] == 0
    assert seller["balances"] == {"USD": TRADES * nl.PRICE}
    assert buyer["balances"]["USD"] == TRADES * (nl.BUYER_CASH - nl.PRICE)


# The plain versions take ~2.5 s a verify batch here: their case runs every
# trade in one wave, the host tier's one at a time and four at a time.
@pytest.mark.parametrize("kind,in_flight", [
    ("cpu", 1), ("cpu", 4), ("torch-cpu", TRADES)])
def test_mock_trades_equal_the_jax_package(kind, in_flight):
    now_us = now_micros()
    theirs = _mock_trades(jax_api(), JaxCpuVerifier(), now_us, in_flight)
    ours = _mock_trades(nl.port_api(), PORT_VERIFIERS[kind](), now_us,
                        in_flight)
    _check_trades(ours)
    assert ours["issues"] == theirs["issues"]
    assert ours["cash"] == theirs["cash"]
    assert ours["paper_ids"] == theirs["paper_ids"]
    assert ours["outcomes"] == theirs["outcomes"]
    assert ours["committed"] == theirs["committed"]
    assert ours["vaults"] == theirs["vaults"]
    for name in nl.TRADE_NAMES:
        assert ours["nodes"][name]["verify_sigs"] == \
            theirs["nodes"][name]["verify_sigs"], name


def test_trade_vault_contents_ignore_the_instant():
    """vault_record's contents take each paper's maturity relative to the
    issue's instant: two runs stamped a second apart hold the same
    contents, but not the same refs."""
    a = _mock_trades(nl.port_api(), CpuVerifier(), now_micros(), 2)
    b = _mock_trades(nl.port_api(), CpuVerifier(), now_micros() + 1_000_000,
                     2)
    for name in ("BankA", "BankB"):
        assert a["vaults"][name]["contents"] == b["vaults"][name]["contents"]
        assert a["vaults"][name]["states"] != b["vaults"][name]["states"]


BALLAST = 300


def _tcp_trades(api, tmp_path, now_us):
    ballast = tmp_path / "ballast.db"
    nl.seed_ballast(api, ballast, BALLAST)
    nodes = nl.make_trade_nodes(api, tmp_path / "run", "cpu", ballast)
    try:
        trades = nl.build_trades(api, *nodes, TRADES, SEED, now_us)
        res = nl.run_tcp_trades(api, *nodes, trades, in_flight=4,
                                timeout_s=120.0)
        res["rows"] = len(nodes[1].services.vault_service)
        res["map_nodes"] = nodes[0].netmap_service.node_count
        res["indexed"] = [type(n.services.vault_service).__name__
                          for n in nodes]
        return res
    finally:
        for node in nodes:
            node.stop()


def test_tcp_trades_equal_the_jax_package(tmp_path):
    """The trader demo through three Nodes over localhost TCP, each on the
    indexed vault with a web API, the notary hosting the wire map, the
    buyer's vault seeded with ballast before it boots: in both packages
    every trade settles, the notary commits exactly the trades' inputs,
    and the two packages' vaults hold the same contents."""
    now_us = now_micros()
    theirs = _tcp_trades(jax_api(), tmp_path / "jax", now_us)
    ours = _tcp_trades(nl.port_api(), tmp_path / "port", now_us)
    _check_trades(ours)
    _check_trades(theirs)
    assert ours["paper_ids"] == theirs["paper_ids"]
    assert ours["rows"] == theirs["rows"] == BALLAST + 2 * TRADES
    assert ours["map_nodes"] == theirs["map_nodes"] == 2
    assert ours["indexed"] == ["IndexedVaultService"] * 3
    for name in ("BankA", "BankB"):
        assert ours["vaults"][name]["contents"] == \
            theirs["vaults"][name]["contents"]
        assert ours["vaults"][name]["balances"] == \
            theirs["vaults"][name]["balances"]
    # bench_vault_scaling's LCG amounts (bench.py:1187).
    assert ours["vaults"]["BankA"]["balances"][nl.BALLAST_CURRENCY] == sum(
        1 + (i * 6364136223846793005 + 1442695040888963407) % 9973
        for i in range(BALLAST))


def test_ballast_equals_the_jax_package(tmp_path):
    """seed_ballast writes the same identity and the same vault rows in
    both packages."""
    rows = []
    for name, api in (("jax", jax_api()), ("port", nl.port_api())):
        path = tmp_path / f"{name}.db"
        nl.seed_ballast(api, path, 50)
        db = api.NodeDatabase(path)
        try:
            rows.append((
                db.conn.execute("SELECT name, seed FROM node_identity")
                .fetchall(),
                db.conn.execute("SELECT * FROM vault_states ORDER BY "
                                "ref_txhash, ref_index").fetchall(),
                db.conn.execute("SELECT * FROM vault_balances").fetchall()))
        finally:
            db.close()
    assert rows[0] == rows[1]
    assert len(rows[0][1]) == 50


def test_ballast_has_the_bench_shape(tmp_path):
    """seed_ballast lays its rows out as bench_vault_scaling does
    (bench.py:1181-1189): each row a transaction of its own, output 0,
    its amount from the LCG over 9,973 values."""
    api = nl.port_api()
    path = tmp_path / "ballast.db"
    nl.seed_ballast(api, path, 200)
    db = api.NodeDatabase(path)
    try:
        rows = db.conn.execute(
            "SELECT ref_txhash, ref_index, currency, amount FROM "
            "vault_states ORDER BY ref_txhash, ref_index").fetchall()
    finally:
        db.close()
    assert [(bytes(h), i) for h, i, _, _ in rows] == [
        (k.to_bytes(16, "big") + b"vault-bench-pad!", 0) for k in range(200)]
    assert [(c, a) for _, _, c, a in rows] == [
        (nl.BALLAST_CURRENCY,
         1 + (k * 6364136223846793005 + 1442695040888963407) % 9973)
        for k in range(200)]
    assert len({a for _, _, _, a in rows}) > 150
