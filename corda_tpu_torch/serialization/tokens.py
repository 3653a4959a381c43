"""Service-reference tokenization for checkpoints.

The port's own copy of ``corda_tpu/serialization/tokens.py``.

Capability match for the reference's SerializeAsToken machinery (reference:
core/src/main/kotlin/net/corda/core/serialization/SerializationToken.kt:25-133,
used by the state machine manager at node/.../statemachine/
StateMachineManager.kt:288-305): long-lived node services referenced from flow
state must not be serialized into checkpoints — they serialize as named
tokens, and deserialization resolves the token against the current node's
service registry.

A node builds a TokenContext of its singleton services; the state machine
manager activates it (context manager) around checkpoint serialize/restore.
"""

from __future__ import annotations

import contextvars
from typing import Any

_current_context: contextvars.ContextVar["TokenContext | None"] = contextvars.ContextVar(
    "corda_tpu_torch_token_context", default=None
)


class SerializeAsToken:
    """Mixin: instances serialize as their `token_name` inside checkpoints."""

    @property
    def token_name(self) -> str:
        return type(self).__qualname__


class TokenContext:
    """A node's registry of tokenizable singleton services."""

    def __init__(self):
        self._by_name: dict[str, Any] = {}

    def register(self, service: SerializeAsToken) -> SerializeAsToken:
        name = service.token_name
        existing = self._by_name.get(name)
        if existing is not None and existing is not service:
            raise ValueError(f"token {name!r} already registered to a different service")
        self._by_name[name] = service
        return service

    def resolve(self, name: str) -> Any:
        if name not in self._by_name:
            raise KeyError(f"no service registered for token {name!r}")
        return self._by_name[name]

    def __enter__(self) -> "TokenContext":
        self._reset = _current_context.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        _current_context.reset(self._reset)
        return False


def current_token_context() -> TokenContext | None:
    return _current_context.get()
