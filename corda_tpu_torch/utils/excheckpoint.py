"""Typed-exception registry for checkpoint replay.

The port's own copy of ``corda_tpu/utils/excheckpoint.py``.

The reference Kryo-serializes live exception objects inside fiber checkpoints,
so a flow that catches a specific exception subtype behaves identically before
and after a crash (reference: node/src/main/kotlin/net/corda/node/services/
statemachine/FlowStateMachineImpl.kt:238-261).  This framework's replay
checkpoints record suspension *results* instead — including raised errors —
so exception types must survive the round trip explicitly: a whitelist of
registered classes, mirroring the serialization codec's class whitelist.

Default round trip is ``cls(message)``.  Classes whose constructors need
structure implement two hooks:

    def __checkpoint_payload__(self):             # -> codec-serializable
    @classmethod
    def __from_checkpoint__(cls, message, payload):  # -> instance
"""

from __future__ import annotations

_registry: dict[str, type] = {}


def register_flow_exception(cls: type) -> type:
    """Decorator: whitelist an exception class for typed checkpoint replay."""
    existing = _registry.get(cls.__name__)
    if existing is not None and existing is not cls:
        raise ValueError(f"exception name {cls.__name__!r} already registered")
    _registry[cls.__name__] = cls
    return cls


def record_exception(err: BaseException) -> tuple:
    """Checkpoint entry for a raised suspension result:
    ('e', type_name, message[, payload])."""
    name = type(err).__name__
    if name in _registry:
        payload_fn = getattr(err, "__checkpoint_payload__", None)
        if payload_fn is not None:
            return ("e", name, str(err), payload_fn())
    return ("e", name, str(err))


def rebuild_exception(entry: tuple) -> BaseException | None:
    """Rebuild the recorded exception, or None if the type is unregistered
    (caller falls back to a generic flow error)."""
    _, name, message, *rest = entry
    cls = _registry.get(name)
    if cls is None:
        return None
    from_cp = getattr(cls, "__from_checkpoint__", None)
    try:
        if from_cp is not None:
            return from_cp(message, rest[0] if rest else None)
        return cls(message)
    except Exception:
        return None
