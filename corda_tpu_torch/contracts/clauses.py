"""The clause framework: composable contract verification.

The port's own copy of ``corda_tpu/contracts/clauses.py``.

Capability match for the reference's clause machinery (reference:
core/src/main/kotlin/net/corda/core/contracts/clauses/Clause.kt,
GroupClauseVerifier.kt, AllComposition/AnyComposition/FirstComposition —
which Cash/CommercialPaper/Obligation are built from in finance/): a clause
declares the commands it needs and a verify step; compositions combine
clauses; a group verifier fans a transaction's state groups across them.

The built-in finance contracts in this framework express the same rules as
direct requireThat groups (equivalent semantics, flatter code); the framework
exists for apps that prefer the compositional style and for parity with the
reference's contract-authoring model.

    class Issue(Clause):
        required_commands = (CashIssue,)
        def verify(self, tx, inputs, outputs, commands, key):
            ...; return the commands this clause consumed

    verify_clause(tx, AllComposition(Issue(), Conserve()), commands)
"""

from __future__ import annotations

from typing import Any, Sequence

from .dsl import RequirementFailed
from .structures import AuthenticatedObject, ContractState


class Clause:
    """One verification rule (Clause.kt). Subclasses set required_commands
    (the clause only triggers when one is present; empty = always) and
    implement verify(), returning the set of command payloads it processed.
    """

    required_commands: tuple[type, ...] = ()

    def matches(self, commands: Sequence[AuthenticatedObject]) -> bool:
        if not self.required_commands:
            return True
        return any(isinstance(c.value, self.required_commands)
                   for c in commands)

    def get_matched_commands(self, commands):
        return [c for c in commands
                if isinstance(c.value, self.required_commands)]

    def verify(self, tx, inputs: Sequence[ContractState],
               outputs: Sequence[ContractState],
               commands: Sequence[AuthenticatedObject],
               grouping_key: Any) -> set:
        raise NotImplementedError


class AllComposition(Clause):
    """Every matching sub-clause must accept (AllComposition.kt)."""

    def __init__(self, *clauses: Clause):
        self.clauses = clauses

    def matches(self, commands) -> bool:
        return any(c.matches(commands) for c in self.clauses)

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        processed: set = set()
        for clause in self.clauses:
            if clause.matches(commands):
                processed |= clause.verify(
                    tx, inputs, outputs, commands, grouping_key)
        return processed


class AnyComposition(Clause):
    """At least one matching sub-clause must accept (AnyComposition.kt)."""

    def __init__(self, *clauses: Clause):
        self.clauses = clauses

    def matches(self, commands) -> bool:
        return any(c.matches(commands) for c in self.clauses)

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        matched = [c for c in self.clauses if c.matches(commands)]
        if not matched:
            raise RequirementFailed(
                "no clause matched the transaction's commands")
        processed: set = set()
        for clause in matched:
            processed |= clause.verify(
                tx, inputs, outputs, commands, grouping_key)
        return processed


class FirstComposition(Clause):
    """The FIRST matching sub-clause decides (FirstComposition.kt) — the
    usual way to dispatch issue/move/exit alternatives."""

    def __init__(self, *clauses: Clause):
        self.clauses = clauses

    def matches(self, commands) -> bool:
        return any(c.matches(commands) for c in self.clauses)

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        for clause in self.clauses:
            if clause.matches(commands):
                return clause.verify(
                    tx, inputs, outputs, commands, grouping_key)
        raise RequirementFailed(
            "no clause matched the transaction's commands")


class GroupClauseVerifier(Clause):
    """Fan a top-level clause across a transaction's state groups
    (GroupClauseVerifier.kt). Subclasses implement group_states(tx)."""

    def __init__(self, clause: Clause):
        self.clause = clause

    def group_states(self, tx):
        raise NotImplementedError

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        processed: set = set()
        for group in self.group_states(tx):
            processed |= self.clause.verify(
                tx, group.inputs, group.outputs, commands, group.grouping_key)
        return processed


def verify_clause(tx, clause: Clause,
                  commands: Sequence[AuthenticatedObject]) -> None:
    """Run a clause tree over the transaction and require every command to
    have been processed by some clause (ClauseVerifier.verifyClause —
    unprocessed commands mean the contract didn't understand the tx)."""
    inputs = getattr(tx, "inputs", ())
    outputs = getattr(tx, "outputs", ())
    processed = clause.verify(tx, inputs, outputs, commands, None)
    unprocessed = [c.value for c in commands
                   if c.value not in processed
                   and not _is_foreign(c, clause)]
    if unprocessed:
        raise RequirementFailed(
            f"commands not processed by any clause: {unprocessed}")


def _is_foreign(command: AuthenticatedObject, clause: Clause) -> bool:
    """Commands no clause in the tree declares are someone else's business
    (multi-contract transactions share one command list)."""
    for sub in _walk(clause):
        if sub.required_commands and isinstance(
                command.value, sub.required_commands):
            return False
    return True


def _walk(clause: Clause):
    yield clause
    for child in getattr(clause, "clauses", ()) or ():
        yield from _walk(child)
    inner = getattr(clause, "clause", None)
    if inner is not None:
        yield from _walk(inner)
