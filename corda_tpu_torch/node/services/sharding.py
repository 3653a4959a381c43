"""Shard routing of the sharded notary: the pure functions a client needs.

The port's own copy of the parts of ``corda_tpu/node/services/sharding.py``
that the notary client reads from the network map (flows/notary.py
``_shard_directory`` and ``_route_group``): the shard service prefix,
``shard_of`` and ``parse_shard_service_full``. The sharded uniqueness
provider, the reshard coordinator and the rest wait for the raft/sharding
slice (ROADMAP.md).
"""

from __future__ import annotations

SHARD_SERVICE_PREFIX = "corda.notary.shard."


def shard_of(ref, count: int) -> int:
    """Owning group of a StateRef — a pure function every party computes
    identically from the ref alone (txhash is a SHA-256 Merkle root, so the
    leading 8 bytes are already uniform; XOR the index so the outputs of
    one transaction spread instead of clustering on one group)."""
    if count <= 1:
        return 0
    return (int.from_bytes(ref.txhash.bytes[:8], "big") ^ ref.index) % count


def parse_shard_service_full(service: str) -> tuple[int, int, int] | None:
    """(group, count, epoch) from an advertised service string, else None.
    A bare (pre-reshard) string parses as epoch 0."""
    if not service.startswith(SHARD_SERVICE_PREFIX):
        return None
    tail = service[len(SHARD_SERVICE_PREFIX):]
    tail, _, epoch_s = tail.partition("@")
    group_s, _, count_s = tail.partition("of")
    try:
        group, count = int(group_s), int(count_s)
        epoch = int(epoch_s) if epoch_s else 0
    except ValueError:
        return None
    if count <= 0 or epoch < 0 or not 0 <= group < count:
        return None
    return group, count, epoch
