"""Node configuration + the file-based network map.

Capability match for the reference's HOCON config system (reference:
node/src/main/kotlin/net/corda/node/services/config/NodeConfiguration.kt:17-79,
reference.conf defaults, per-node dev configs) re-based on TOML (stdlib
tomllib), and for the network-map directory the reference serves over the wire
(node/.../network/NetworkMapService.kt:37-60) re-based — first stage — on a
shared JSON file nodes register into (SURVEY.md §7 stage 5: "static
file/directory service first, dynamic later").

The port's own copy of ``corda_tpu/node/config.py``. One change: the
``verifier`` key takes the port's provider kinds (``VERIFIER_KINDS``, the
names ``crypto.provider.make_verifier`` builds) and defaults to
``"torch"``, the card; a JAX kind raises at load.
"""

from __future__ import annotations

import json
import os
import tempfile

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the API-identical backport
    import tomli as tomllib
from dataclasses import dataclass, field
from pathlib import Path

from ..crypto.composite import CompositeKey
from ..crypto.party import Party
from .messaging.tcp import TcpAddress
from .services.api import NodeInfo, ServiceInfo, ServiceType


@dataclass(frozen=True)
class BatchConfig:
    """The max-wait micro-batch policy protecting notarisation p99
    (SURVEY.md §7 stage 6: flush at N sigs or T ms, whichever first)."""

    max_sigs: int = 4096
    max_wait_ms: float = 2.0
    # Round coalescing: after the first inbound message wakes a round, keep
    # draining for this long before processing. Each round costs a sqlite
    # commit (fsync), an ACK frame per connection, and (on a raft leader)
    # an AppendEntries broadcast — a small accumulation window amortises
    # all three across the burst. 0 = wake-per-message (lowest latency).
    coalesce_ms: float = 0.0
    # Async verify pipeline (crypto/async_verify.py): the run loop submits
    # accumulated batches to a feeder thread and keeps serving Raft/
    # messages/checkpoints while the verifier runs; False restores the
    # in-round synchronous flush.
    async_verify: bool = True
    # Bounded in-flight submitted batches (2 = double buffering: one batch
    # verifying, one filling).
    async_depth: int = 2
    # Verification sidecar (crypto/sidecar.py): address of a host-local
    # device-owning verify server — unix socket path or host:port. All node
    # processes on the host feed the same server so batches coalesce ACROSS
    # processes. "" disables it: verification routes exactly as before.
    sidecar: str = ""
    # Client-side round-trip deadline for one sidecar batch; a miss
    # degrades the node to its local host tier (cooldown re-probe re-opens).
    sidecar_deadline_ms: float = 2000.0
    # Mesh width of the host's sidecar (informational on the client side:
    # stamped into node_metrics so harnesses can attribute which mesh
    # served a run; the server's --devices flag is authoritative). 0 =
    # unknown/single-device.
    sidecar_devices: int = 0
    # Federated verify plane (crypto/federation.py): comma-separated
    # addresses of PER-HOST sidecar servers. When set, the node routes
    # verify batches across every listed host by queue depth + QoS lane
    # (hedged re-dispatch, per-host degrade/re-admit) instead of feeding
    # one host-local server; takes precedence over `sidecar`. "" disables
    # federation: verification routes exactly as before.
    federation_hosts: str = ""


@dataclass(frozen=True)
class RaftConfig:
    """Consensus hot-path policy (services/raft.py commit pipeline)."""

    # Group commit: the leader merges every PutAllCommand submitted in a
    # scheduling round into ONE batched log entry (PutAllBatch) — one log
    # append/fsync, one AppendEntries slot, one apply pass for the whole
    # burst, with per-request conflict isolation inside the batch. False
    # restores the one-command-per-entry path.
    group_commit: bool = True
    # Pipelined replication: how many log entries may be streamed to a
    # follower beyond its acked match position before the leader pauses
    # and probes with heartbeats (per-peer in-flight window).
    pipeline_window: int = 1024
    # Entries per AppendEntries frame when streaming a tail.
    append_chunk: int = 256
    # Pipelined commit plane (round 18): overlap consecutive rounds. The
    # leader seals round N+1 while round N is still replicating (mid-round
    # seals ride the pipeline_window), and committed-entry apply + client
    # reply construction detach onto a dedicated executor thread fed by a
    # bounded queue. False restores the serial seal→replicate→apply→reply
    # loop, bit-identical to the pre-pipeline ledger.
    pipeline: bool = True
    # Bound of the commit queue feeding the apply executor, in log
    # entries. When the queue is full the leader sheds NEW submissions
    # with a retryable OverloadedError("commit") instead of growing an
    # unbounded backlog (committed-but-unapplied entries are durable in
    # the log and drain as the executor catches up). 0 disables the
    # executor even when pipeline=true (inline apply, pipelined seals).
    apply_queue_depth: int = 4096
    # Columnar fast path: apply a run of PutAll commands from one batch
    # with set-wide conflict/reservation SELECTs and executemany inserts
    # (plus the native _ccommit CRC32C batch helper when built) instead
    # of per-ref statements. Byte-identical rows; False falls back to the
    # per-command apply.
    commit_many: bool = True
    # Partition hardening (round 20): pre-vote canvass before any real
    # election (a candidate probes at term+1 WITHOUT incrementing its
    # persisted term, so a partitioned rejoiner cannot depose a healthy
    # leader) plus check-quorum leader step-down (a leader that hears no
    # quorum for a full election window stops answering as leader).
    # False (the default) leaves election behaviour bit-identical to the
    # pre-partition-plane tree.
    prevote: bool = False


@dataclass(frozen=True)
class QosConfig:
    """QoS plane policy (corda_tpu_torch/qos): priority lanes, deadlines, and
    admission control. ``enabled = false`` (the default) leaves the plane
    disarmed — every touch point short-circuits on one attribute check and
    behaviour is bit-identical to the pre-QoS tree."""

    enabled: bool = False
    # Default interactive SLO: flows started without an explicit deadline
    # get admitted_at + slo_ms. The sweep bench judges p99 against this.
    slo_ms: float = 50.0
    # How long before an interactive deadline the queueing points stop
    # coalescing and flush (SMM verify micro-batch, sidecar scheduler,
    # Raft group-commit round).
    deadline_guard_ms: float = 5.0
    # Anti-starvation: with both lanes runnable, every Nth pump pick takes
    # the oldest bulk step.
    bulk_every: int = 4
    # Admission token buckets, per lane (requests/s + burst; rate 0 =
    # unlimited). Bulk additionally sheds above the queue watermark.
    interactive_rate: float = 0.0
    interactive_burst: float = 32.0
    bulk_rate: float = 0.0
    bulk_burst: float = 32.0
    # Runnable-backlog ceiling above which bulk is shed; 0 disables.
    queue_watermark: int = 0


@dataclass(frozen=True)
class DurabilityConfig:
    """Durability plane policy (node/services/integrity.py).

    ``scrub_enabled = false`` (the default) leaves the online scrubber off —
    write-path CRC framing is always on (one crc32c per insert), but
    disarmed nodes spend nothing on background verification and behaviour
    is otherwise bit-identical to the pre-durability tree. Boot fsck is a
    separate tool (``python -m corda_tpu_torch.tools.fsck``), not a config knob.
    """

    scrub_enabled: bool = False
    # Scrubber row-rate ceiling: the pass sleeps so it never verifies more
    # than this many rows per second (low-priority by construction).
    scrub_rows_per_s: float = 500.0
    # Idle wait between full-table scrub passes.
    scrub_interval_s: float = 5.0


@dataclass(frozen=True)
class VaultConfig:
    """Vault engine selection (node/services/vault.py).

    ``indexed = false`` (the default) keeps the in-memory
    NodeVaultService — bit-identical to the pre-vault-plane tree.
    ``indexed = true`` (or CORDA_TPU_VAULT_INDEXED=1) arms the sqlite
    IndexedVaultService: durable vault_states rows with covering
    indexes, watermark incremental boot, O(1) balance aggregates."""

    indexed: bool = False
    # Soft-lock reservation TTL for select_coins: how long a selected
    # coin stays shadowed from other flows before a crashed/abandoned
    # selection re-admits it.
    softlock_ttl_s: float = 5.0
    # Transactions per notify batch during watermark rebuild (bounds
    # boot memory, never the full ledger at once).
    rebuild_batch: int = 512


@dataclass(frozen=True)
class ShardConfig:
    """Sharded-notary topology (services/sharding.py).

    The input-state space is partitioned by StateRef hash across `count`
    independent Raft groups; `groups[g]` lists the member names of group g
    (a member's own raft_cluster is exactly its group). Reservations taken
    by the cross-shard two-phase coordinator expire `reserve_ttl_s` seconds
    after the coordinator's issued_at stamp — judged stamp-vs-stamp in the
    replicated state machine, never against a replica's local clock.
    """

    count: int = 1
    groups: tuple[tuple[str, ...], ...] = ()
    reserve_ttl_s: float = 15.0


# One env var carries any number of per-knob config overrides to spawned
# node processes (autotune sweep candidates, driver env_extra): a JSON
# object deep-merged over the parsed TOML in NodeConfig.load. Keys may
# be nested ({"raft": {"pipeline_window": 2048}}) or dotted
# ("raft.pipeline_window": 2048 — the autotune knob-name spelling);
# unknown keys still fail from_dict's known-keys validation, so a typo'd
# overlay crashes the node at boot instead of silently tuning nothing.
OVERLAY_ENV = "CORDA_TPU_CONFIG_OVERLAY"


def _deep_merge(base: dict, overlay: dict) -> dict:
    """A new dict: ``overlay`` wins, nested dicts merge key-wise."""
    out = dict(base)
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def config_overlay_from_env(env=None) -> dict:
    """The parsed, nested overlay from ``OVERLAY_ENV`` (empty dict when
    unset). Malformed JSON raises — the overlay is machine-written, and
    a candidate that silently ran defaults would corrupt a sweep."""
    raw = (env if env is not None else os.environ).get(OVERLAY_ENV, "")
    if not raw:
        return {}
    overlay = json.loads(raw)
    if not isinstance(overlay, dict):
        raise ValueError(
            f"{OVERLAY_ENV} must be a JSON object, got "
            f"{type(overlay).__name__}")
    nested: dict = {}
    for key, value in overlay.items():
        if "." in key:
            section, sub = key.split(".", 1)
            entry = nested.setdefault(section, {})
            if not isinstance(entry, dict):
                raise ValueError(
                    f"{OVERLAY_ENV}: {key!r} conflicts with scalar "
                    f"{section!r}")
            entry[sub] = value
        elif isinstance(value, dict) and isinstance(nested.get(key), dict):
            nested[key] = _deep_merge(nested[key], value)
        else:
            nested[key] = value
    return nested


# The verification providers a node can name: crypto.provider.make_verifier's
# kinds. "torch" runs the CUDA kernels on the card (and raises without one).
VERIFIER_KINDS = ("torch", "torch-shadow", "cpu", "oracle")


@dataclass(frozen=True)
class NodeConfig:
    name: str
    base_dir: Path
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral (the netmap records the real port)
    # none | simple | validating | raft-simple | raft-validating
    notary: str = "none"
    # For raft-* notaries: the names of ALL cluster members (incl. this node).
    raft_cluster: tuple[str, ...] = ()
    network_map: Path | None = None  # shared netmap file (bootstrap)
    map_service: bool = False  # host the wire directory service on this node
    map_node: str | None = None  # use the named node's directory service
    tls: bool = False  # mutual TLS on the transport (dev CA auto-generated)
    web_port: int | None = None  # HTTP API (status/metrics/attachments)
    verifier: str = "torch"  # one of VERIFIER_KINDS
    batch: BatchConfig = field(default_factory=BatchConfig)
    raft: RaftConfig = field(default_factory=RaftConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    durability: DurabilityConfig = field(default_factory=DurabilityConfig)
    vault: VaultConfig = field(default_factory=VaultConfig)
    # Sharded notary: when set (count > 1 or groups non-empty), this raft-*
    # notary member is one shard of a partitioned uniqueness service and
    # uses the ShardedUniquenessProvider two-phase coordinator.
    notary_shards: ShardConfig | None = None
    # RPC users: ({"username","password","permissions": [flow names]|["ALL"]},)
    rpc_users: tuple = ()
    # CorDapp modules: imported at node start so their @register_flow /
    # @register decorators run; a module-level install(node) hook, if
    # present, wires responders/services (the reference's CordaPluginRegistry
    # ServiceLoader capability, AbstractNode.kt:170-173,340-352).
    cordapps: tuple[str, ...] = ()

    @staticmethod
    def load(path: str | os.PathLike) -> "NodeConfig":
        """Parse a TOML config file; relative paths resolve against its
        dir. The ``CORDA_TPU_CONFIG_OVERLAY`` env (a JSON object, set by
        the autotune controller / testing driver for spawned processes)
        deep-merges over the parsed TOML before validation, so one env
        var carries any number of per-knob overrides to every child
        process. Precedence, lowest to highest: TOML file < overlay <
        the explicit per-subsystem CORDA_TPU_* env vars read at their
        use sites (e.g. CORDA_TPU_FEDERATION still outranks an
        overlay-set [batch] sidecar in _select_batch_verifier)."""
        path = Path(path)
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        overlay = config_overlay_from_env()
        if overlay:
            raw = _deep_merge(raw, overlay)
        return NodeConfig.from_dict(raw, default_dir=path.parent)

    @staticmethod
    def from_dict(raw: dict, default_dir: Path | None = None) -> "NodeConfig":
        base = Path(raw.get("base_dir", default_dir or "."))
        known = {"name", "base_dir", "host", "port", "notary", "raft_cluster",
                 "network_map", "map_service", "map_node", "tls", "web_port",
                 "verifier", "batch", "raft", "qos", "durability", "vault",
                 "rpc_users", "cordapps", "notary_shards"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        notary = raw.get("notary", "none")
        valid_notary = ("none", "simple", "validating", "raft-simple",
                        "raft-validating")
        if notary not in valid_notary:
            raise ValueError(
                f"notary must be one of {'|'.join(valid_notary)}, got {notary!r}")
        if notary.startswith("raft") and not raw.get("raft_cluster"):
            raise ValueError("raft-* notaries need a raft_cluster name list")
        verifier = raw.get("verifier", "torch")
        if verifier not in VERIFIER_KINDS:
            raise ValueError(
                f"verifier must be one of {'|'.join(VERIFIER_KINDS)}, got "
                f"{verifier!r}")
        nm = raw.get("network_map")
        batch = raw.get("batch", {})
        raft = raw.get("raft", {})
        qos = raw.get("qos", {})
        durability = raw.get("durability", {})
        vault = raw.get("vault", {})
        shards_raw = raw.get("notary_shards")
        shards = None
        if shards_raw is not None:
            groups = tuple(tuple(g) for g in shards_raw.get("groups", ()))
            count = int(shards_raw.get("count", len(groups) or 1))
            # The groups list may be LONGER than count: groups beyond count
            # are pending split targets, booted ahead of a live reshard
            # (they own no keys until an epoch activates them). Shorter is
            # still a misconfiguration — some keyspace would have no group.
            if groups and len(groups) < count:
                raise ValueError(
                    f"notary_shards: count={count} but "
                    f"{len(groups)} groups")
            if not notary.startswith("raft"):
                raise ValueError("notary_shards requires a raft-* notary")
            shards = ShardConfig(
                count=count,
                groups=groups,
                reserve_ttl_s=float(shards_raw.get("reserve_ttl_s", 15.0)),
            )
        return NodeConfig(
            name=raw["name"],
            base_dir=base,
            host=raw.get("host", "127.0.0.1"),
            port=int(raw.get("port", 0)),
            notary=notary,
            raft_cluster=tuple(raw.get("raft_cluster", ())),
            network_map=(base / nm if nm and not os.path.isabs(nm) else
                         Path(nm) if nm else None),
            map_service=bool(raw.get("map_service", False)),
            map_node=raw.get("map_node"),
            tls=bool(raw.get("tls", False)),
            web_port=(int(raw["web_port"])
                      if raw.get("web_port") is not None else None),
            verifier=verifier,
            batch=BatchConfig(
                max_sigs=int(batch.get("max_sigs", 4096)),
                max_wait_ms=float(batch.get("max_wait_ms", 2.0)),
                coalesce_ms=float(batch.get("coalesce_ms", 0.0)),
                async_verify=bool(batch.get("async_verify", True)),
                async_depth=int(batch.get("async_depth", 2)),
                sidecar=str(batch.get("sidecar", "")),
                sidecar_deadline_ms=float(
                    batch.get("sidecar_deadline_ms", 2000.0)),
                sidecar_devices=int(batch.get("sidecar_devices", 0)),
                # Accept a TOML list or the comma-joined string the env
                # var uses; normalise to the string form.
                federation_hosts=(
                    ",".join(str(h) for h in batch["federation_hosts"])
                    if isinstance(batch.get("federation_hosts"),
                                  (list, tuple))
                    else str(batch.get("federation_hosts", ""))),
            ),
            raft=RaftConfig(
                group_commit=bool(raft.get("group_commit", True)),
                pipeline_window=int(raft.get("pipeline_window", 1024)),
                append_chunk=int(raft.get("append_chunk", 256)),
                pipeline=bool(raft.get("pipeline", True)),
                apply_queue_depth=int(raft.get("apply_queue_depth", 4096)),
                commit_many=bool(raft.get("commit_many", True)),
                prevote=bool(raft.get("prevote", False)),
            ),
            qos=QosConfig(
                enabled=bool(qos.get("enabled", False)),
                slo_ms=float(qos.get("slo_ms", 50.0)),
                deadline_guard_ms=float(qos.get("deadline_guard_ms", 5.0)),
                bulk_every=int(qos.get("bulk_every", 4)),
                interactive_rate=float(qos.get("interactive_rate", 0.0)),
                interactive_burst=float(qos.get("interactive_burst", 32.0)),
                bulk_rate=float(qos.get("bulk_rate", 0.0)),
                bulk_burst=float(qos.get("bulk_burst", 32.0)),
                queue_watermark=int(qos.get("queue_watermark", 0)),
            ),
            durability=DurabilityConfig(
                scrub_enabled=bool(durability.get("scrub_enabled", False)),
                scrub_rows_per_s=float(
                    durability.get("scrub_rows_per_s", 500.0)),
                scrub_interval_s=float(
                    durability.get("scrub_interval_s", 5.0)),
            ),
            vault=VaultConfig(
                indexed=bool(vault.get("indexed", False)),
                softlock_ttl_s=float(vault.get("softlock_ttl_s", 5.0)),
                rebuild_batch=int(vault.get("rebuild_batch", 512)),
            ),
            notary_shards=shards,
            rpc_users=tuple(
                dict(u) for u in raw.get("rpc_users", ())),
            cordapps=tuple(raw.get("cordapps", ())),
        )


# ---------------------------------------------------------------------------
# File-based network map
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NetMapEntry:
    name: str
    host: str
    port: int
    owning_key_b58: str  # CompositeKey.to_base58_string() (whole tree)
    services: tuple[str, ...] = ()

    def party(self) -> Party:
        return Party(self.name, CompositeKey.parse_from_base58(self.owning_key_b58))

    def node_info(self) -> NodeInfo:
        return NodeInfo(
            address=TcpAddress(self.host, self.port),
            legal_identity=self.party(),
            advertised_services=tuple(
                ServiceInfo(ServiceType(s)) for s in self.services),
        )


def _encode_owning_key(key: CompositeKey) -> str:
    return key.to_base58_string()


def netmap_register(path: str | os.PathLike, name: str, host: str, port: int,
                    owning_key: CompositeKey,
                    services: tuple[str, ...] = ()) -> None:
    """Add/replace this node's entry (atomic file replace, same-name entries
    collapse). The load-modify-replace runs under an flock on a sidecar
    lock file: nodes in a cluster boot concurrently, and without the lock
    two simultaneous registrations each read the map missing the other and
    the second replace silently drops the first node's entry — that node
    stays unreachable for its whole life (registration is boot-only; the
    periodic refresh only reads)."""
    lock = open(os.path.abspath(os.fspath(path)) + ".lock", "a")
    try:
        try:
            import fcntl
            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: keep the old last-writer-wins
            pass
        entries = netmap_load(path)
        entries = [e for e in entries if e.name != name]
        entries.append(NetMapEntry(name, host, port,
                                   _encode_owning_key(owning_key),
                                   tuple(services)))
        payload = json.dumps([e.__dict__ | {"services": list(e.services)}
                              for e in sorted(entries, key=lambda e: e.name)],
                             indent=1)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)))
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    finally:
        lock.close()  # closing the fd releases the flock


def netmap_load(path: str | os.PathLike) -> list[NetMapEntry]:
    try:
        with open(path) as f:
            raw = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return []
    return [NetMapEntry(e["name"], e["host"], e["port"], e["owning_key_b58"],
                        tuple(e.get("services", ()))) for e in raw]
