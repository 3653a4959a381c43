"""L5a messaging: transport-neutral API and the deterministic in-memory fake.

The port's own copies of ``corda_tpu/node/messaging``; the TCP transport
is not ported yet (ROADMAP.md).
"""

from .api import Message, MessagingService, TopicSession, DEFAULT_SESSION_ID  # noqa: F401
from .inmem import InMemoryMessagingNetwork  # noqa: F401
