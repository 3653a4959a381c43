"""The `requireThat` verification DSL.

Capability match for the reference's ContractsDSL (reference:
core/src/main/kotlin/net/corda/core/contracts/ContractsDSL.kt): contracts
state their rules as named boolean requirements; the first failing requirement
aborts verification with its message.

Python form:

    with require_that() as req:
        req("the amounts balance", inputs_sum == outputs_sum)
        req("owner has signed", owner in signers)

plus helpers to select commands by type (select_command / select_commands).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from ..crypto.composite import CompositeKey
from .structures import AuthenticatedObject


class RequirementFailed(Exception):
    """A contract requirement evaluated false (reference: requireThat)."""


class _Requirements:
    def __call__(self, description: str, condition: bool) -> None:
        if not condition:
            raise RequirementFailed(f"Failed requirement: {description}")

    def using(self, description: str, condition: bool) -> None:
        self(description, condition)


class require_that:
    def __enter__(self) -> _Requirements:
        return _Requirements()

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


def select_commands(
    commands: Sequence[AuthenticatedObject],
    of_type: type,
    signers: Iterable[CompositeKey] | None = None,
    parties=None,
) -> list[AuthenticatedObject]:
    """Filter commands by payload type (ContractsDSL.kt select<T>)."""
    out = []
    for cmd in commands:
        if not isinstance(cmd.value, of_type):
            continue
        if signers is not None and not set(signers) <= set(cmd.signers):
            continue
        if parties is not None and not set(parties) <= set(cmd.signing_parties):
            continue
        out.append(cmd)
    return out


def select_command(
    commands: Sequence[AuthenticatedObject], of_type: type, **kw
) -> AuthenticatedObject:
    """Expect exactly one matching command (ContractsDSL.kt requireSingleCommand)."""
    found = select_commands(commands, of_type, **kw)
    if len(found) != 1:
        raise RequirementFailed(
            f"Required single {of_type.__name__} command, found {len(found)}"
        )
    return found[0]
