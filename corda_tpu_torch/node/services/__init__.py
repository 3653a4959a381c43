"""Service interfaces (L4) and in-memory/persistent implementations (L5).

The port's own copies of ``corda_tpu/node/services``: the service API,
the in-memory services and the notary services, with the raft and sharding
modules cut to what the notary flow imports; the vault, persistence and
the rest are not ported yet (ROADMAP.md).
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
