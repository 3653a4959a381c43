"""Service interfaces (L4) and in-memory/persistent implementations (L5).

The port's own copies of ``corda_tpu/node/services``: the service API,
the in-memory services, the notary services, sqlite persistence with its
integrity frames, the schema and vault observers, the scheduler, the raft
and sharding notaries, the indexed vault and the network map service.
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
