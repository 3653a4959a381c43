"""The port's clause framework (corda_tpu_torch/contracts/clauses.py)
against the JAX package's: the mirror of tests/test_clauses_web.py's
TestClauses, every case run on both packages, with the clauses run, the
groups visited and the failure message equal between them."""

import importlib
from types import SimpleNamespace

import pytest

PKGS = ("corda_tpu", "corda_tpu_torch")


class _Cmd:
    pass


class _CmdA(_Cmd):
    pass


class _CmdB(_Cmd):
    pass


_NS: dict = {}


def ns(pkg) -> SimpleNamespace:
    """``pkg``'s clause names, require_that and RequirementFailed, and a
    RecordingClause over its Clause."""
    if pkg not in _NS:
        clauses = importlib.import_module(f"{pkg}.contracts.clauses")
        dsl = importlib.import_module(f"{pkg}.contracts.dsl")
        structures = importlib.import_module(f"{pkg}.contracts.structures")

        class RecordingClause(clauses.Clause):
            def __init__(self, name, required=(), fail=False):
                self.name = name
                self.required_commands = required
                self.fail = fail
                self.ran = 0

            def verify(self, tx, inputs, outputs, commands, key):
                self.ran += 1
                with dsl.require_that() as req:
                    req(f"clause {self.name}", not self.fail)
                return {c.value for c in self.get_matched_commands(commands)}

        _NS[pkg] = SimpleNamespace(
            **{k: getattr(clauses, k) for k in (
                "AllComposition", "AnyComposition", "Clause",
                "FirstComposition", "GroupClauseVerifier", "verify_clause")},
            RequirementFailed=dsl.RequirementFailed,
            auth=lambda cmd: structures.AuthenticatedObject((), (), cmd),
            RecordingClause=RecordingClause)
    return _NS[pkg]


def first_composition_dispatches_on_command(p):
    issue = p.RecordingClause("issue", (_CmdA,))
    move = p.RecordingClause("move", (_CmdB,))
    p.verify_clause(None, p.FirstComposition(issue, move), [p.auth(_CmdB())])
    return issue.ran, move.ran


def all_composition_runs_every_match(p):
    a = p.RecordingClause("a", (_CmdA,))
    b = p.RecordingClause("b", (_CmdA,))
    p.verify_clause(None, p.AllComposition(a, b), [p.auth(_CmdA())])
    return a.ran, b.ran


def any_composition_requires_a_match(p):
    a = p.RecordingClause("a", (_CmdA,))
    p.verify_clause(None, p.AnyComposition(a), [p.auth(_CmdB())])


def failing_clause_propagates(p):
    bad = p.RecordingClause("bad", (_CmdA,), fail=True)
    p.verify_clause(None, p.FirstComposition(bad), [p.auth(_CmdA())])


def unprocessed_declared_command_rejected(p):
    class Lazy(p.Clause):
        required_commands = (_CmdA,)

        def verify(self, tx, inputs, outputs, commands, key):
            return set()  # pretends to match but processes nothing

    p.verify_clause(None, Lazy(), [p.auth(_CmdA())])


def group_clause_verifier_fans_groups(p):
    class FakeGroup:
        def __init__(self, key):
            self.inputs, self.outputs, self.grouping_key = (), (), key

    seen = []

    class PerGroup(p.Clause):
        required_commands = (_CmdA,)

        def verify(self, tx, inputs, outputs, commands, key):
            seen.append(key)
            return {c.value for c in self.get_matched_commands(commands)}

    class Verifier(p.GroupClauseVerifier):
        def group_states(self, tx):
            return [FakeGroup("g1"), FakeGroup("g2")]

    p.verify_clause(None, Verifier(PerGroup()), [p.auth(_CmdA())])
    return seen


# case -> (what the reference test asserts: a return value, or the
# message the RequirementFailed must match)
CASES = {
    first_composition_dispatches_on_command: (0, 1),
    all_composition_runs_every_match: (1, 1),
    any_composition_requires_a_match: "no clause matched",
    failing_clause_propagates: "clause bad",
    unprocessed_declared_command_rejected: "not processed",
    group_clause_verifier_fans_groups: ["g1", "g2"],
}


def _run(pkg, case):
    p = ns(pkg)
    try:
        return "returned", case(p)
    except p.RequirementFailed as e:
        return "RequirementFailed", str(e)


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__)
@pytest.mark.parametrize("pkg", PKGS)
def test_clause_case(pkg, case):
    kind, value = _run(pkg, case)
    want = CASES[case]
    if isinstance(want, str):
        assert kind == "RequirementFailed" and want in value
    else:
        assert (kind, value) == ("returned", want)


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__)
def test_clause_case_equal_across_packages(case):
    assert _run("corda_tpu_torch", case) == _run("corda_tpu", case)
