"""The port's universal contract (corda_tpu_torch/contracts/universal.py)
and its interest-rate swap product (finance/irs.py) against the JAX
package's: the mirror of tests/test_universal.py, every case run on both
packages from the same keys; then the products themselves (a zero-coupon
bond, an FX swap, a capped fixing, the IRS schedule, each step of its
lifecycle, the UniversalState and the commands) byte-equal between the
packages and decoded by the other package.
"""

import datetime as dt
import importlib
from types import SimpleNamespace

import pytest

PKGS = ("corda_tpu", "corda_tpu_torch")
_DAY_MICROS = 86_400 * 1_000_000


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


_NS: dict = {}


def ns(pkg) -> SimpleNamespace:
    """Every name of ``pkg``'s universal contract, finance.types and
    oracle fix types, its Timestamp, ledger DSL, codec and irs module, and
    tests/test_universal.py's parties and maturity."""
    if pkg not in _NS:
        keys, party = _m(pkg, "crypto.keys"), _m(pkg, "crypto.party")
        types = _m(pkg, "finance.types")
        oracle = _m(pkg, "flows.oracle")
        codec = _m(pkg, "serialization.codec")
        out = dict(vars(_m(pkg, "contracts.universal")))
        out.update(
            Tenor=types.Tenor, date_to_days=types.date_to_days,
            Fix=oracle.Fix, FixOf=oracle.FixOf,
            Timestamp=_m(pkg, "contracts.structures").Timestamp,
            ledger=_m(pkg, "testing.ledger_dsl").ledger,
            serialize=codec.serialize, deserialize=codec.deserialize,
            irs=_m(pkg, "finance.irs"), pkg=pkg)
        for name, b in (("ACME", 0x61), ("HighStreetBank", 0x62),
                        ("Momentum", 0x63), ("Notary", 0x64)):
            out[name.upper() if name != "HighStreetBank" else "HIGH_ST"] = \
                party.Party.of(name, keys.KeyPair.generate(
                    bytes([b]) * 32).public)
        out["MATURITY"] = types.date_to_days(dt.date(2017, 9, 1))
        _NS[pkg] = SimpleNamespace(**out)
    return _NS[pkg]


@pytest.fixture(params=PKGS)
def U(request):
    return ns(request.param)


def day_ts(U, day, slack_days=0):
    return U.Timestamp(day * _DAY_MICROS, (day + slack_days + 1) * _DAY_MICROS)


def ustate(U, arrangement):
    keys = sorted(U.involved_parties(arrangement),
                  key=lambda k: k.to_base58_string())
    return U.UniversalState(tuple(keys), arrangement)


def zcb(U, amount=None):
    amount = U.to_quanta(100_000) if amount is None else amount
    return U.actions(U.arrange("execute", U.after(U.MATURITY), U.ACME,
                               U.transfer(amount, "USD", U.HIGH_ST, U.ACME)))


def fx_swap(U):
    return U.actions(U.arrange(
        "execute", U.after(U.MATURITY), {U.ACME, U.HIGH_ST},
        U.all_of(U.transfer(U.to_quanta(1_200_000), "USD", U.ACME, U.HIGH_ST),
                 U.transfer(U.to_quanta(1_000_000), "EUR", U.HIGH_ST,
                            U.ACME))))


# --- TestStructure / TestEval (tests/test_universal.py:83-150) ---------------


def test_liable_and_involved_parties(U):
    assert U.liable_parties(zcb(U)) == frozenset({U.HIGH_ST.owning_key})
    assert U.involved_parties(zcb(U)) == frozenset(
        {U.HIGH_ST.owning_key, U.ACME.owning_key})
    give_away = U.actions(U.arrange(
        "donate", U.after(U.MATURITY), U.ACME,
        U.transfer(U.to_quanta(1), "USD", U.ACME, U.HIGH_ST)))
    assert U.liable_parties(give_away) == frozenset()
    moved = U.replace_party(zcb(U), U.ACME, U.MOMENTUM)
    assert U.liable_parties(moved) == frozenset({U.HIGH_ST.owning_key})
    assert U.involved_parties(moved) == frozenset(
        {U.HIGH_ST.owning_key, U.MOMENTUM.owning_key})


def test_arrangements_serialize_canonically(U):
    assert U.deserialize(U.serialize(zcb(U))) == zcb(U)
    both = U.all_of(zcb(U), U.transfer(1, "EUR", U.ACME, U.HIGH_ST))
    assert U.deserialize(U.serialize(both)) == both


def test_eval(U):
    p = (U.Const(U.to_quanta(3)) * U.Const(U.to_quanta(2))
         - U.Const(U.to_quanta(1))) // U.Const(U.to_quanta(5))
    assert U.eval_amount(None, p) == U.to_quanta(1)
    assert U.eval_amount(None, U.PosPart(U.Const(-5))) == 0
    assert U.eval_amount(None, U.PosPart(U.Const(7))) == 7
    p = U.interest(U.to_quanta(1_000_000), "ACT/360",
                   U.Const(5 * U.SCALE), U.Const(0), U.Const(360))
    assert U.eval_amount(None, p) == U.to_quanta(50_000)

    class Tx:
        timestamp = day_ts(U, U.MATURITY)

    assert U.eval_condition(Tx, U.after(U.MATURITY))
    assert not U.eval_condition(Tx, U.before(U.MATURITY - 1))
    assert U.eval_condition(Tx, U.before(U.MATURITY + 2))

    class NoTime:
        timestamp = None

    assert U.eval_condition(NoTime, U.Compare(U.Const(3), U.GT, U.Const(2)))


# --- TestZeroCouponBond (tests/test_universal.py:153-219) --------------------


def test_zcb_issue_requires_liable_signature(U):
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.output("zcb", ustate(U, zcb(U)))
        tx.command(U.UIssue(), U.ACME.owning_key)
        tx.fails_with("liable parties")
    with l.transaction() as tx:
        tx.output("zcb", ustate(U, zcb(U)))
        tx.command(U.UIssue(), U.HIGH_ST.owning_key)
        tx.verifies()


def test_zcb_execute_after_maturity(U):
    settlement = U.transfer(U.Const(U.to_quanta(100_000)), "USD", U.HIGH_ST,
                            U.ACME)
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.output("zcb", ustate(U, zcb(U)))
        tx.command(U.UIssue(), U.HIGH_ST.owning_key)
        tx.verifies()
    with l.transaction() as tx:
        tx.input("zcb")
        tx.output("settled", ustate(U, settlement))
        tx.command(U.UAction("execute"), U.ACME.owning_key)
        with tx.tweak() as tw:
            tw.fails_with("timestamped")
        tx.timestamp(day_ts(U, U.MATURITY - 10))
        with tx.tweak() as tw:
            tw.fails_with("condition must be met")
        tx.timestamp(day_ts(U, U.MATURITY))
        tx.verifies()


@pytest.mark.parametrize("case", ["no actor", "wrong output"])
def test_zcb_execute_refused(U, case):
    amount = U.to_quanta(100_000 if case == "no actor" else 50_000)
    signer = U.HIGH_ST if case == "no actor" else U.ACME
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, zcb(U)))
        tx.output(None, ustate(U, U.transfer(U.Const(amount), "USD",
                                             U.HIGH_ST, U.ACME)))
        tx.command(U.UAction("execute"), signer.owning_key)
        tx.timestamp(day_ts(U, U.MATURITY))
        tx.fails_with("authorized" if case == "no actor"
                      else "match action result")


def test_zcb_move_to_new_party(U):
    moved = ustate(U, U.replace_party(zcb(U), U.ACME, U.MOMENTUM))
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, zcb(U)))
        tx.output(None, moved)
        tx.command(U.UMove(U.ACME, U.MOMENTUM), U.HIGH_ST.owning_key)
        tx.verifies()
    with l.transaction() as tx:
        tx.input(ustate(U, zcb(U)))
        tx.output(None, moved)
        tx.command(U.UMove(U.ACME, U.MOMENTUM), U.MOMENTUM.owning_key)
        tx.fails_with("liable parties")


# --- TestFXSwap (tests/test_universal.py:222-281) ---------------------------


@pytest.mark.parametrize("legs,error", [
    (("usd", "eur"), None), (("usd",), "match action result"),
    (("usd", "eur", "eur"), "match action result")])
def test_fx_swap_execute(U, legs, error):
    assert U.liable_parties(fx_swap(U)) == frozenset(
        {U.ACME.owning_key, U.HIGH_ST.owning_key})
    made = {"usd": U.transfer(U.Const(U.to_quanta(1_200_000)), "USD",
                              U.ACME, U.HIGH_ST),
            "eur": U.transfer(U.Const(U.to_quanta(1_000_000)), "EUR",
                              U.HIGH_ST, U.ACME)}
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, fx_swap(U)))
        for leg in legs:
            tx.output(None, ustate(U, made[leg]))
        tx.command(U.UAction("execute"), U.ACME.owning_key)
        tx.timestamp(day_ts(U, U.MATURITY))
        if error is None:
            tx.verifies()
        else:
            tx.fails_with(error)


# --- TestFixings (tests/test_universal.py:284-375) --------------------------


def capped(U):
    fix_day = U.date_to_days(dt.date(2017, 3, 1))
    fix_of = U.FixOf("LIBOR", fix_day, "3M")
    rate = U.fixing("LIBOR", fix_day, "3M", U.MOMENTUM)
    product = U.actions(U.arrange(
        "exercise", U.after(U.MATURITY), U.ACME,
        U.transfer(U.PosPart(U.Interest(
            U.Const(U.to_quanta(10_000_000)), "ACT/360",
            rate - U.Const(4 * U.SCALE), U.Const(fix_day),
            U.Const(U.MATURITY))), "USD", U.HIGH_ST, U.ACME)))
    return product, fix_of


@pytest.mark.parametrize("case", [
    "attested", "unattested", "self-signed", "other value", "superfluous"])
def test_apply_fixes(U, case):
    product, fix_of = capped(U)
    value = 9 * U.SCALE if case == "other value" else 5 * U.SCALE
    bogus = U.FixOf("LIBOR", 1, "6M")
    fixes = (U.Fix(fix_of, value),) + (
        (U.Fix(bogus, 1),) if case == "superfluous" else ())
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, product))
        tx.output(None, ustate(U, U.replace_fixings(product,
                                                    {fix_of: value})))
        tx.command(U.UApplyFixes(fixes), U.ACME.owning_key)
        if case != "unattested":
            attester = U.ACME if case == "self-signed" else U.MOMENTUM
            tx.command(U.Fix(fix_of, 5 * U.SCALE), attester.owning_key)
        if case == "superfluous":
            tx.command(U.Fix(bogus, 1), U.MOMENTUM.owning_key)
        if case == "attested":
            tx.verifies()
        else:
            tx.fails_with("relevant fixing" if case == "superfluous"
                          else "attested")


def test_fixed_product_evaluates(U):
    product, fix_of = capped(U)
    fixed = U.replace_fixings(product, {fix_of: 5 * U.SCALE})
    action = next(iter(fixed.actions))
    days = U.MATURITY - fix_of.for_day
    assert U.eval_amount(None, action.arrangement.amount) == \
        (U.to_quanta(10_000_000) * (1 * U.SCALE) * days) \
        // (100 * U.SCALE * 360) > 0


# --- TestIRS (tests/test_universal.py:378-487) ------------------------------

IRS_START = dt.date(2016, 9, 1)
IRS_END = dt.date(2018, 9, 1)


def swap(U):
    return U.irs.interest_rate_swap(
        notional=U.to_quanta(50_000_000), currency="EUR",
        fixed_rate=U.SCALE // 2, floating_index="LIBOR", index_tenor="3M",
        oracle=U.MOMENTUM, fixed_leg_payer=U.ACME,
        floating_leg_payer=U.HIGH_ST, start_day=U.date_to_days(IRS_START),
        end_day=U.date_to_days(IRS_END), frequency=U.Tenor("3M"))


def irs_lifecycle(U) -> list:
    """tests/test_universal.py's two-period lifecycle on the ledger; returns
    each step's arrangement, for the byte-equality test."""
    start = U.date_to_days(IRS_START)
    fix1 = U.FixOf("LIBOR", start, "3M")
    fixed1 = U.replace_fixings(U.reduce_rollout(swap(U)), {fix1: U.SCALE})
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, swap(U)))
        tx.output("fixed-1", ustate(U, fixed1))
        tx.command(U.UApplyFixes((U.Fix(fix1, U.SCALE),)), U.ACME.owning_key)
        tx.command(U.Fix(fix1, U.SCALE), U.MOMENTUM.owning_key)
        tx.verifies()
    parts = set(U.actions_of(fixed1)["settle"].arrangement.arrangements)
    pays = [p for p in parts if isinstance(p, U.Transfer)]
    rest = next(p for p in parts if isinstance(p, U.RollOut))
    net = U.eval_amount(None, next(p for p in pays
                                   if p.to_party == U.ACME).amount)
    assert net == (U.to_quanta(50_000_000) * (U.SCALE // 2)
                   * (rest.start_day - start)) // (100 * U.SCALE * 365) > 0
    assert U.eval_amount(None, next(p for p in pays
                                    if p.to_party == U.HIGH_ST).amount) == 0
    settled = U.Transfer(U.Const(net), "EUR", U.HIGH_ST, U.ACME)
    zero_leg = U.Transfer(U.Const(0), "EUR", U.ACME, U.HIGH_ST)
    with l.transaction() as tx:
        tx.input("fixed-1")
        tx.output("settled-1", ustate(U, settled))
        tx.output(None, ustate(U, zero_leg))
        tx.output("rest", ustate(U, rest))
        tx.command(U.UAction("settle"), U.HIGH_ST.owning_key)
        tx.timestamp(day_ts(U, rest.start_day))
        with tx.tweak() as tw:
            tw.outputs = [o for o in tw.outputs if o[1].details != settled]
            tw.fails_with("match action result")
        tx.verifies()
    assert rest.template == swap(U).template
    fix2 = U.FixOf("LIBOR", rest.start_day, "3M")
    fixed2 = U.replace_fixings(U.reduce_rollout(rest), {fix2: U.SCALE // 4})
    with l.transaction() as tx:
        tx.input("rest")
        tx.output("fixed-2", ustate(U, fixed2))
        tx.command(U.UApplyFixes((U.Fix(fix2, U.SCALE // 4),)),
                   U.ACME.owning_key)
        tx.command(U.Fix(fix2, U.SCALE // 4), U.MOMENTUM.owning_key)
        tx.verifies()
    pays2 = [p for p in set(U.actions_of(fixed2)["settle"].arrangement
                            .arrangements) if isinstance(p, U.Transfer)]
    assert U.eval_amount(None, next(p for p in pays2
                                    if p.to_party == U.HIGH_ST).amount) > 0
    assert U.eval_amount(None, next(p for p in pays2
                                    if p.to_party == U.ACME).amount) == 0
    return [swap(U), fixed1, settled, zero_leg, rest, fixed2]


def test_irs_two_period_lifecycle_on_ledger(U):
    irs_lifecycle(U)


def test_irs_fixing_with_wrong_oracle_rejected(U):
    fix_of = U.FixOf("LIBOR", U.date_to_days(IRS_START), "3M")
    fixed = U.replace_fixings(U.reduce_rollout(swap(U)), {fix_of: U.SCALE})
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, swap(U)))
        tx.output(None, ustate(U, fixed))
        tx.command(U.UApplyFixes((U.Fix(fix_of, U.SCALE),)),
                   U.ACME.owning_key)
        tx.command(U.Fix(fix_of, U.SCALE), U.ACME.owning_key)
        tx.fails_with("attested")


# --- TestRollOut (tests/test_universal.py:490-551) ---------------------------


def roll(U):
    template = U.actions(U.arrange(
        "pay", U.after(U.EndDate()), U.ACME,
        U.all_of(U.transfer(U.Interest(U.Const(U.to_quanta(1_000_000)),
                                       "ACT/360", U.Const(5 * U.SCALE),
                                       U.StartDate(), U.EndDate()),
                            "USD", U.HIGH_ST, U.ACME),
                 U.Continuation())))
    return U.RollOut(U.date_to_days(dt.date(2017, 1, 2)),
                     U.date_to_days(dt.date(2017, 4, 3)), U.Tenor("1M"),
                     template)


def test_rollout_reduces_one_period(U):
    r = roll(U)
    reduced = U.reduce_rollout(r)
    assert isinstance(reduced, U.Actions)
    action = next(iter(reduced.actions))
    assert isinstance(action.arrangement, U.All)
    parts = set(action.arrangement.arrangements)
    rolls = [p for p in parts if isinstance(p, U.RollOut)]
    pays = [p for p in parts if isinstance(p, U.Transfer)]
    assert len(rolls) == 1 and len(pays) == 1
    assert r.start_day < rolls[0].start_day and rolls[0].end_day == r.end_day
    assert pays[0].amount.start == U.Const(r.start_day)
    short = U.RollOut(r.start_day, r.start_day + 20, U.Tenor("1M"),
                      r.template)
    last = next(iter(U.reduce_rollout(short).actions))
    assert isinstance(last.arrangement, U.Transfer)
    end_day = rolls[0].start_day
    amount = (U.to_quanta(1_000_000) * 5 * U.SCALE
              * (end_day - r.start_day)) // (100 * U.SCALE * 360)
    l = U.ledger(U.NOTARY)
    with l.transaction() as tx:
        tx.input(ustate(U, r))
        tx.output(None, ustate(U, U.all_of(
            U.Transfer(U.Const(amount), "USD", U.HIGH_ST, U.ACME),
            rolls[0])))
        tx.command(U.UAction("pay"), U.ACME.owning_key)
        tx.timestamp(day_ts(U, end_day))
        tx.verifies()


def test_multiset_equal_is_order_and_repr_independent(U):
    class OrderlessRepr:
        def __init__(self, key, salt):
            self.key, self.salt = key, salt

        def __eq__(self, other):
            return isinstance(other, OrderlessRepr) and self.key == other.key

        def __repr__(self):  # pragma: no cover - diagnostic only
            return f"OrderlessRepr({self.salt!r})"

    a1, a2 = OrderlessRepr("a", "x"), OrderlessRepr("a", "y")
    b = OrderlessRepr("b", "z")
    assert U._multiset_equal([a1, b], [b, a2])
    assert not U._multiset_equal([a1, a2, b], [a1, b])
    assert not U._multiset_equal([a1], [a1, b])
    assert U._multiset_equal([], [])


# --- the products on the wire, across the packages -------------------------


def products(U) -> dict:
    product, _fix_of = capped(U)
    out = {"zcb": zcb(U), "fx_swap": fx_swap(U), "capped": product,
           "rollout": roll(U), "reduced": U.reduce_rollout(roll(U)),
           "zcb_state": ustate(U, zcb(U)), "UIssue": U.UIssue(),
           "UMove": U.UMove(U.ACME, U.MOMENTUM),
           "UAction": U.UAction("settle"),
           "UApplyFixes": U.UApplyFixes((U.Fix(_fix_of, U.SCALE),)),
           "Tenor": U.Tenor("10Y")}
    for k, step in enumerate(irs_lifecycle(U)):
        out[f"irs_{k}"] = step
        out[f"irs_state_{k}"] = ustate(U, step)
    return out


def test_products_are_byte_equal_and_decode_across_packages():
    made = {pkg: products(ns(pkg)) for pkg in PKGS}
    assert list(made["corda_tpu"]) == list(made["corda_tpu_torch"])
    for name in made["corda_tpu"]:
        blobs = {pkg: ns(pkg).serialize(made[pkg][name]).bytes
                 for pkg in PKGS}
        assert blobs["corda_tpu"] == blobs["corda_tpu_torch"], name
        for pkg, other in (PKGS, PKGS[::-1]):
            back = ns(pkg).deserialize(blobs[other])
            assert back == made[pkg][name], name
            assert type(back).__module__.startswith(pkg + "."), name


def test_issue_transactions_are_byte_equal():
    """generate_issue of the IRS between the same parties gives the same
    transaction id in both packages."""
    ids = []
    for pkg in PKGS:
        U = ns(pkg)
        builder = U.generate_issue(swap(U), U.HIGH_ST.ref(b"\x01"), U.NOTARY)
        ids.append(bytes(builder.to_wire_transaction().id.bytes))
    assert ids[0] == ids[1]
