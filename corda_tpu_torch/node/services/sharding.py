"""Shard routing of the sharded notary: the pure functions a client needs.

The port's own copy of the parts of ``corda_tpu/node/services/sharding.py``
that the notary client reads from the network map (flows/notary.py
``_shard_directory`` and ``_route_group``): the shard service prefix,
``shard_of`` and ``parse_shard_service_full``; and the two the node reads
(node.py): ``shard_service_string`` and ``parse_reshard_plan``. The
sharded uniqueness provider, the reshard coordinator and the rest wait for
the raft/sharding slice (ROADMAP.md).
"""

from __future__ import annotations

SHARD_SERVICE_PREFIX = "corda.notary.shard."

# Reshard plans ride the SAME network map, as one service string on a
# control pseudo-entry (name RESHARD_PLAN_ENTRY). Node.refresh_netmap
# skips "_"-prefixed entries when building the party directory and parses
# the plan out of them instead — no new channel, no new watcher.
RESHARD_PLAN_PREFIX = "corda.notary.reshard."
RESHARD_PLAN_ENTRY = "_reshard"


def shard_of(ref, count: int) -> int:
    """Owning group of a StateRef — a pure function every party computes
    identically from the ref alone (txhash is a SHA-256 Merkle root, so the
    leading 8 bytes are already uniform; XOR the index so the outputs of
    one transaction spread instead of clustering on one group)."""
    if count <= 1:
        return 0
    return (int.from_bytes(ref.txhash.bytes[:8], "big") ^ ref.index) % count


def shard_service_string(group: int, count: int, epoch: int = 0) -> str:
    """Advertised service string for a group. Epoch 0 (the boot map) keeps
    the original bare format so pre-reshard directories stay byte-stable;
    later epochs append ``@<epoch>``."""
    base = f"{SHARD_SERVICE_PREFIX}{group}of{count}"
    return base if epoch <= 0 else f"{base}@{epoch}"


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


def parse_reshard_plan(service: str) -> tuple[int, int, int] | None:
    """(epoch, from_count, to_count) from a plan service string, else None.
    Only shape-valid plans parse: a doubling split or a halving merge with
    a positive epoch (epoch 0 is the boot map and can never be a target)."""
    if not service.startswith(RESHARD_PLAN_PREFIX):
        return None
    tail = service[len(RESHARD_PLAN_PREFIX):]
    epoch_s, _, counts = tail.partition(":")
    from_s, _, to_s = counts.partition("to")
    try:
        epoch, from_count, to_count = int(epoch_s), int(from_s), int(to_s)
    except ValueError:
        return None
    if epoch <= 0 or from_count <= 0 or to_count <= 0:
        return None
    if to_count != 2 * from_count and from_count != 2 * to_count:
        return None  # only doubling splits / halving merges are consistent
    return epoch, from_count, to_count
