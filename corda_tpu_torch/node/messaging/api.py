"""Transport-neutral messaging API.

The port's own copy of ``corda_tpu/node/messaging/api.py``.

Capability match for the reference's messaging abstraction (reference:
core/src/main/kotlin/net/corda/core/messaging/Messaging.kt): topic+session
addressed messages between opaque recipients, handler registration, and
at-least-once delivery with app-level dedupe provided by implementations
(reference: node/.../messaging/NodeMessagingClient.kt:102-113).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Callable

DEFAULT_SESSION_ID = 0

_uuid_counter = itertools.count(1)


def fresh_message_id() -> bytes:
    """A unique message id for dedupe (UUID-equivalent)."""
    return os.urandom(12) + next(_uuid_counter).to_bytes(4, "big")


@dataclass(frozen=True, order=True)
class TopicSession:
    """A (topic, session) address for dispatch (reference: Messaging.kt
    TopicSession)."""

    topic: str
    session_id: int = DEFAULT_SESSION_ID

    def is_blank(self) -> bool:
        return not self.topic and self.session_id == DEFAULT_SESSION_ID

    def __str__(self) -> str:
        return f"{self.topic}.{self.session_id}"


@dataclass(frozen=True)
class Message:
    """A sealed envelope: opaque payload plus routing metadata."""

    topic_session: TopicSession
    data: bytes
    unique_id: bytes
    sender: Any = None  # transport address of the origin
    # Tracing context (obs/trace.py): (trace_id, span_id) of the sending
    # flow, or None when tracing is disarmed / the sender had no context.
    # Transports stamp it on send only when obs.ACTIVE is armed — the
    # disabled path never grows the envelope.
    trace: Any = None
    # QoS context (qos/context.py): the sending flow's QosContext, or None
    # when the QoS plane is disarmed / the sender carried none. Same
    # arming discipline as trace: disarmed, the envelope never grows.
    qos: Any = None


class MessageHandlerRegistration:
    pass


class MessagingService:
    """The API nodes and services program against (Messaging.kt:23-90)."""

    @property
    def my_address(self) -> Any:
        raise NotImplementedError

    def send(self, topic_session: TopicSession, data: bytes, to: Any) -> None:
        raise NotImplementedError

    def add_message_handler(
        self, topic: str, session_id: int, callback: Callable[[Message], None]
    ) -> MessageHandlerRegistration:
        raise NotImplementedError

    def remove_message_handler(self, registration: MessageHandlerRegistration) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass
