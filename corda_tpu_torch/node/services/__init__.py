"""Service interfaces (L4) and in-memory/persistent implementations (L5).

The port's own copies of ``corda_tpu/node/services``: the service API,
the in-memory services, the notary services, sqlite persistence with its
integrity frames, the schema and vault observers and the scheduler, with
the raft and sharding modules cut to what the notary flow and the node
import; the indexed vault, the network map service and the rest are not
ported yet (ROADMAP.md).
"""

from .api import (  # noqa: F401
    IdentityService,
    KeyManagementService,
    NetworkMapCache,
    NodeInfo,
    ServiceHub,
    ServiceInfo,
    ServiceType,
    StorageService,
    UniquenessConflict,
    UniquenessException,
    UniquenessProvider,
    VaultService,
)
