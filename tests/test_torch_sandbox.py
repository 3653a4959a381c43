"""The port's deterministic sandbox (corda_tpu_torch/contracts/sandbox.py)
against the JAX package's: the mirror of tests/test_sandbox.py. Every case
runs on both packages, and each must give the reference test's verdict,
with the same verdict and the same reason in both packages (a cost kill is
compared by its kind and budget; the bytes an allocation bomb reached vary
run to run). Then the platform prefix: an import of the JAX package's name
for a platform module vets as the port's module of that path."""

import importlib
import time
from types import SimpleNamespace

import pytest

PKGS = ("corda_tpu", "corda_tpu_torch")
_NS: dict = {}


def ns(pkg) -> SimpleNamespace:
    if pkg not in _NS:
        m = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa
        sandbox, structures = m("contracts.sandbox"), m("contracts.structures")
        keys, party = m("crypto.keys"), m("crypto.party")
        finance, cash = m("finance"), m("finance.cash")
        ALICE = party.Party.of("Alice", keys.KeyPair.generate(
            b"\x51" * 32).public)
        BANK = party.Party.of("Bank", keys.KeyPair.generate(
            b"\x52" * 32).public)
        NOTARY = party.Party.of("Notary", keys.KeyPair.generate(
            b"\x53" * 32).public)
        _NS[pkg] = SimpleNamespace(
            **{k: getattr(sandbox, k) for k in (
                "CostBudget", "DeterministicSandbox", "SandboxCostExceeded",
                "SandboxViolation", "sandboxed_verify")},
            Contract=structures.Contract,
            TransactionState=structures.TransactionState,
            Amount=finance.Amount, CashState=finance.CashState,
            Cash=cash.Cash, CashIssue=cash.CashIssue,
            ledger=m("testing.ledger_dsl").ledger,
            ALICE=ALICE, BANK=BANK, NOTARY=NOTARY,
            TOKEN=structures.Issued(BANK.ref(b"\x01"), "USD"))
    return _NS[pkg]


def issue_tx(p):
    """A valid Cash issuance as a TransactionForContract."""
    lg = p.ledger(p.NOTARY)
    with lg.transaction() as tx:
        tx.output("cash", p.CashState(p.Amount(1000, p.TOKEN),
                                      p.ALICE.owning_key))
        tx.command(p.CashIssue(1), p.BANK.owning_key)
        tx.verifies()
        return tx._tx_for_contract()


CASES: dict = {}


def case(want):
    """Register a case with the reference test's verdict: "ok" (no raise;
    a returned value is compared across the packages), or (exception
    name, text its message must contain)."""
    def deco(fn):
        CASES[fn.__name__] = (fn, want)
        return fn
    return deco


V = "SandboxViolation"
K = "SandboxCostExceeded"


# -- TestVetting -------------------------------------------------------------

@case("ok")
def platform_contracts_are_suitable(p):
    return p.DeterministicSandbox().is_suitable(p.Cash())


@case((V, "time"))
def clock_access_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            if time.time() > 0:
                raise ValueError("nope")

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "open"))
def io_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            open("/etc/passwd").read()

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "eval"))
def dynamic_code_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            eval("1 + 1")

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "socket"))
def nonwhitelisted_import_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            import socket
            socket.gethostname()

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "__globals__"))
def reflection_escape_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            (lambda: 0).__globals__["__builtins__"]

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "time"))
def transitive_helper_is_vetted(p):
    def helper():
        return time.time()

    class EvilContract(p.Contract):
        def verify(self, tx):
            helper()

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "open"))
def nested_code_objects_are_vetted(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            def inner():
                return open("x")
            return inner

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "getattr"))
def getattr_escape_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            g = getattr(self.verify, "__glo" + "bals__")
            return g

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, ""))
def attrgetter_escape_rejected(p):
    import operator

    class EvilContract(p.Contract):
        def verify(self, tx):
            getter = operator.attrgetter("__globals__")
            return getter(type(tx).verify)

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "string constant"))
def reflection_string_constant_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            return "x.__globals__"  # data smuggled to a lookup helper

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "format"))
def str_format_banned(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            tmpl = "".join(["{0.__glo", "bals__}"])
            return tmpl.format(type(tx).verify)

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "open"))
def failed_vet_is_not_cached(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            return open("/etc/passwd")

    sandbox = p.DeterministicSandbox()
    assert not sandbox.is_suitable(EvilContract())
    assert not sandbox.is_suitable(EvilContract())
    sandbox.run(EvilContract.verify, EvilContract(), None)


@case((V, ""))
def cached_property_is_vetted(p):
    import functools

    class Helper:
        @functools.cached_property
        def now(self):
            return time.time()

    class EvilContract(p.Contract):
        def verify(self, tx):
            return Helper().now

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "time"))
def property_accessor_is_vetted(p):
    class Helper:
        @property
        def now(self):
            return time.time()

    class EvilContract(p.Contract):
        def verify(self, tx):
            return Helper().now

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "open"))
def nested_class_is_vetted(p):
    class Outer:
        class Inner:
            def leak(self):
                return open("/etc/passwd")

    class EvilContract(p.Contract):
        def verify(self, tx):
            return Outer.Inner().leak()

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "time"))
def user_base_class_is_vetted(p):
    class EvilBase:
        def helper(self):
            return time.time()

    class Derived(EvilBase):
        pass

    class EvilContract(p.Contract):
        def verify(self, tx):
            return Derived().helper()

    p.DeterministicSandbox().vet_contract(EvilContract())


@case(("NameError", "eval"))
def runtime_builtins_are_restricted(p):
    class Contract2(p.Contract):
        def verify(self, tx):
            return eval("1+1")  # noqa: S307 -- the point of the test

    confined = p.DeterministicSandbox()._confine(Contract2.verify)
    confined(Contract2(), None)


@case((V, "global"))
def global_mutation_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            global _leak
            _leak = tx  # persists across verifications

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "mutation"))
def attribute_mutation_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            tx.inputs = ()  # monkey-patching the tx view

    p.DeterministicSandbox().vet_contract(EvilContract())


@case((V, "id"))
def nondeterministic_builtins_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            return id(tx)

    p.DeterministicSandbox().vet_contract(EvilContract())


# -- TestCostAccounting ------------------------------------------------------

@case((K, "jump"))
def infinite_loop_killed(p):
    def spin():
        n = 0
        while True:
            n += 1

    p.DeterministicSandbox(budget=p.CostBudget(jumps=10_000)).run(spin)


@case((K, "invoke"))
def call_bomb_killed(p):
    def fanout(depth=0):
        for _ in range(50):
            if depth < 50:
                fanout(depth + 1)

    p.DeterministicSandbox(budget=p.CostBudget(invokes=1_000)).run(fanout)


@case((K, "alloc"))
def allocation_bomb_killed(p):
    def hoard():
        return [bytes(1024) for _ in range(64 * 1024)]

    p.DeterministicSandbox(
        budget=p.CostBudget(alloc_bytes=1 << 20, jumps=10**9)).run(hoard)


@case((K, "throw"))
def throw_storm_killed(p):
    def storm():
        for _ in range(200):
            try:
                raise ValueError("x")
            except ValueError:
                pass

    p.DeterministicSandbox(budget=p.CostBudget(throws=50)).run(storm)


@case("ok")
def well_behaved_contract_passes(p):
    p.sandboxed_verify(issue_tx(p))  # Cash.verify under default budgets


@case(("ok"))
def rejection_propagates_unchanged(p):
    lg = p.ledger(p.NOTARY)
    with lg.transaction() as tx:
        tx.output(None, p.CashState(p.Amount(1000, p.TOKEN),
                                    p.ALICE.owning_key))
        tx.command(p.CashIssue(1), p.ALICE.owning_key)  # not the issuer
        bad = tx._tx_for_contract()
        tx.fails_with("issuer")
    with pytest.raises(Exception, match="issuer") as e:
        p.sandboxed_verify(bad)
    return type(e.value).__name__, str(e.value)


# -- TestHashVetting ---------------------------------------------------------

@case((V, "open"))
def user_defined_hash_is_vetted(p):
    class Sneaky:
        def __hash__(self):
            open("/etc/passwd")
            return 0

    class EvilContract(p.Contract):
        def verify(self, tx):
            return len({Sneaky()})

    p.DeterministicSandbox().vet_contract(EvilContract())


@case("ok")
def frozen_dataclass_state_passes(p):
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class Pt:
        x: int

    class GoodContract(p.Contract):
        def verify(self, tx):
            return len({Pt(1), Pt(2)})

    p.DeterministicSandbox().vet_contract(GoodContract())


@case("ok")
def docstring_mentioning_dunder_passes(p):
    class DocContract(p.Contract):
        def verify(self, tx):
            "a contract may not touch __dict__ here"
            return True

    p.DeterministicSandbox().vet_contract(DocContract())


@case((V, "string constant"))
def non_docstring_constant_still_rejected(p):
    class EvilContract(p.Contract):
        def verify(self, tx):
            "legit docstring"
            return "x.__globals__"

    p.DeterministicSandbox().vet_contract(EvilContract())


# -- TestTrustForgery --------------------------------------------------------

@case((V, "open"))
def forged_module_name_does_not_borrow_trust(p):
    space = {"__name__": "math"}
    exec("def verify(self, tx):\n    return open('/etc/passwd')", space)
    evil_verify = space["verify"]
    assert evil_verify.__module__ == "math"  # the forgery "took"
    p.DeterministicSandbox().vet(evil_verify)


@case((V, "identity name"))
def identity_name_assignment_rejected_in_module_body(p):
    code = compile('__name__ = "math"\nx = 1\n', "<attachment>", "exec")
    p.DeterministicSandbox()._vet_code(code, {})


@case((V, "identity name"))
def class_body_module_assignment_rejected(p):
    code = compile('class C:\n    __module__ = "math"\n', "<attachment>",
                   "exec")
    p.DeterministicSandbox()._vet_code(code, {})


@case((V, "open"))
def wraps_stamped_global_function_is_still_vetted(p):
    import functools
    import math

    @functools.wraps(math.floor)
    def evil(x):
        return open("/etc/passwd")

    assert evil.__module__ == "math"  # the forgery "took"

    def verify(self, tx):
        return evil(1)  # noqa: F821 -- planted in the globals below

    globals()["evil"] = evil
    try:
        p.DeterministicSandbox().vet(verify)
    finally:
        del globals()["evil"]


@case("ok")
def wraps_stamped_function_is_still_confined(p):
    import functools
    import math

    @functools.wraps(math.floor)
    def probe(x):
        return __builtins__  # noqa: F821 -- resolved at runtime

    confined = p.DeterministicSandbox()._confine(probe)
    assert confined is not probe  # not exempted as "platform"
    return "open" in confined(0)


@case((V, "open"))
def forged_class_module_is_still_vetted(p):
    Evil = type("Evil", (), {
        "__module__": "math",
        "attack": lambda self: open("/etc/passwd"),
    })
    assert Evil.__module__ == "math"  # the forgery "took"
    p.DeterministicSandbox()._vet_value("Evil", Evil, "<test>")


@case("ok")
def genuine_platform_builtin_is_trusted(p):
    import math

    sandbox = p.DeterministicSandbox()
    sandbox.vet(math.floor)
    sandbox._vet_value("floor", math.floor, "<test>")


@case("ok")
def genuine_platform_class_and_instance_trusted(p):
    import decimal

    sandbox = p.DeterministicSandbox()
    assert sandbox._trusted_class(decimal.Decimal)
    sandbox._vet_value("D", decimal.Decimal, "<test>")
    sandbox._vet_value("d", decimal.Decimal("1.5"), "<test>")


@case((V, "memoryview"))
def builtin_type_alias_still_forbidden(p):
    p.DeterministicSandbox()._vet_value("mv", memoryview, "<test>")


@case((V, ""))
def partial_over_builtin_rejected(p):
    import functools

    partial = functools.partial(open, "/etc/passwd")
    p.DeterministicSandbox()._vet_value("p", partial, "<test>")


@case("ok")
def mutable_container_global_rejected(p):
    verdicts = []
    for bad in ([], {}, set()):
        with pytest.raises(p.SandboxViolation) as e:
            p.DeterministicSandbox()._vet_value("cache", bad, "<test>")
        verdicts.append(str(e.value))
    return verdicts


@case("ok")
def frozen_dataclass_field_payload_is_vetted(p):
    smuggle = p.TransactionState(data=open, notary=None)
    with pytest.raises(p.SandboxViolation, match="X.data") as e:
        p.DeterministicSandbox()._vet_value("X", smuggle, "<test>")
    ok = p.TransactionState(data=123, notary=None)
    p.DeterministicSandbox()._vet_value("X", ok, "<test>")
    return str(e.value)


@case("ok")
def tuple_smuggling_builtin_rejected(p):
    with pytest.raises(p.SandboxViolation, match=r"T\[0\]") as e:
        p.DeterministicSandbox()._vet_value("T", (open,), "<test>")
    p.DeterministicSandbox()._vet_value("T", (1, "a", (2.0,)), "<test>")
    return str(e.value)


@case("ok")
def forged_builtins_module_instance_rejected(p):
    Evil = type("Evil", (), {
        "__module__": "builtins",
        "__call__": lambda self: open("/etc/passwd"),
    })
    helper = Evil()
    sandbox = p.DeterministicSandbox()
    with pytest.raises(p.SandboxViolation) as e:
        sandbox._vet_value("helper", helper, "<test>")
    sandbox._vet_value("length", len, "<test>")
    return str(e.value)


@case((V, ""))
def class_attribute_tuple_smuggle_rejected(p):
    class Carrier:
        T = (open,)

        def verify(self, tx):
            return Carrier.T[0]("/etc/passwd")

    p.DeterministicSandbox()._vet_class(Carrier, "<test>")


@case("ok")
def forged_c_callable_surface_rejected(p):
    import math

    Evil = type("Evil", (), {
        "__module__": "math",
        "__self__": math,
        "__call__": lambda self: open("/etc/passwd"),
    })
    x = Evil()
    sandbox = p.DeterministicSandbox()
    assert not sandbox._trusted_home(x)
    with pytest.raises(p.SandboxViolation) as e:
        sandbox._vet_value("x", x, "<test>")
    return str(e.value)


# -- TestDataclassHash -------------------------------------------------------

@case("ok")
def fieldless_frozen_dataclass_hash_excused(p):
    from dataclasses import dataclass as dc

    @dc(frozen=True)
    class Marker:
        pass

    def verify(self, tx):
        return Marker() in {Marker()}  # noqa: F821 -- planted below

    globals()["Marker"] = Marker
    try:
        p.DeterministicSandbox().vet(verify)
    finally:
        del globals()["Marker"]


def verdict(pkg, name):
    """("ok", returned) or (exception name, its reason)."""
    fn, _ = CASES[name]
    p = ns(pkg)
    try:
        return "ok", fn(p)
    except p.SandboxCostExceeded as e:
        reason = (e.kind, e.budget) if e.kind == "alloc" else str(e)
        return "SandboxCostExceeded", reason
    except (p.SandboxViolation, NameError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(CASES))
def test_sandbox_case_same_verdict_and_reason(name):
    want = CASES[name][1]
    port, jax = verdict("corda_tpu_torch", name), verdict("corda_tpu", name)
    assert port == jax
    if want == "ok":
        assert port[0] == "ok"
    else:
        assert port[0] == want[0], port
        kind_or_text = port[1][0] if want[0] == K and isinstance(
            port[1], tuple) else port[1]
        assert want[1] in kind_or_text, port


# -- the platform prefix -----------------------------------------------------

def _module_code(src: str):
    return compile(src, "<attachment>", "exec")


@pytest.mark.parametrize("src, allowed", [
    ("from corda_tpu.contracts.structures import Contract\n", True),
    ("import corda_tpu.finance.cash\n", True),
    ("from corda_tpu_torch.contracts.dsl import require_that\n", True),
    ("from corda_tpu.ops import sharded\n", False),
    ("import corda_tpu\n", False),
    ("import corda_tpu_torch.node.node\n", False),
], ids=["jax-structures", "jax-cash", "port-dsl", "jax-ops",
        "jax-top", "port-node"])
def test_platform_prefix_vets_as_the_ports_module(src, allowed):
    """Contract code names the platform as the JAX package does: a
    whitelisted ``corda_tpu.<x>`` vets as ``corda_tpu_torch.<x>``, and
    anything not whitelisted after the rewrite is refused under the name
    the code wrote."""
    from corda_tpu_torch.contracts.sandbox import (DeterministicSandbox,
                                                   SandboxViolation,
                                                   platform_module_name)

    sandbox = DeterministicSandbox()
    if allowed:
        sandbox._vet_code(_module_code(src), {})
        return
    with pytest.raises(SandboxViolation) as e:
        sandbox._vet_code(_module_code(src), {})
    written = src.split()[1]
    assert f"import of non-whitelisted module {written!r}" in str(e.value)
    assert platform_module_name("corda_tpu.ops") == "corda_tpu_torch.ops"
