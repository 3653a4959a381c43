"""Shared service identities for notary clusters.

Capability match for the reference's ServiceIdentityGenerator (reference:
node/src/main/kotlin/net/corda/node/utilities/ServiceIdentityGenerator.kt —
pre-generates the CompositeKey identity a Raft notary cluster advertises, so
a signature from ANY member validates against the one service party clients
address).

The port's own copy of ``corda_tpu/utils/service_identity.py``.
"""

from __future__ import annotations

from ..crypto.composite import CompositeKey
from ..crypto.keys import PublicKey
from ..crypto.party import Party


def generate_service_identity(service_name: str,
                              member_keys: list[PublicKey],
                              threshold: int = 1) -> Party:
    """The cluster's shared party: a threshold-of-n composite over member
    keys (1-of-n for a Raft cluster — consensus already guarantees the
    member that signs speaks for the quorum)."""
    if not member_keys:
        raise ValueError("a service identity needs at least one member key")
    builder = CompositeKey.Builder()
    for key in member_keys:
        builder.add_key(key)
    return Party(service_name, builder.build(threshold=threshold))
