"""The production node: config-driven assembly over durable storage + TCP.

Capability match for the reference's node assembly (reference:
node/src/main/kotlin/net/corda/node/internal/AbstractNode.kt:179-258 —
storage -> messaging -> vault/identity/keys -> SMM -> notary, one start()
sequence) and the CLI entry point (node/.../Main.kt:34-114).  Differences are
accelerator-first by design: the verifier provider is part of the config,
and the run loop enforces the max-wait verify micro-batch policy (flush at N
sigs or T ms, whichever first) that keeps notarisation p99 bounded while
batches stay wide (SURVEY.md §7 stage 6).

Crash contract: every durable store commits before the call returns
(NodeDatabase), so `kill -9` at any point leaves a database a fresh Node over
the same base_dir resumes from — including mid-flow checkpoints
(restoreFibersFromCheckpoints capability, StateMachineManager.kt:190-226).

Run it:  python -m corda_tpu_torch.node.node <config.toml>

The port's own copy of ``corda_tpu/node/node.py``. What differs:

* ``verifier`` names the port's providers (config.VERIFIER_KINDS), default
  ``"torch"``: every verify micro-batch at or above the size crossover
  runs the SHA-512 challenge kernel and the verify kernel on the card.
* The warm keys on the port's ``TorchVerifier`` on a CUDA device: start()
  builds and launches its kernels once (``warm()``), in line, before
  ``smm.start()`` replays any checkpoint, and a warm that raises fails
  ``start()`` (``main`` exits 1) instead of leaving the node on the host
  tier for good, which would hide the card.
* SIGTERM stops the node cleanly (exit 0), as Ctrl-C does.
* stop() drains a raft member's apply executor (``quiesce_apply``) and
  ends its thread before the store closes.
* ``verifier = "torch-sharded"`` verifies each batch over every local
  card (``crypto.provider.TorchMeshVerifier``); a mesh wider than the host's
  cards raises at start, where the reference degrades to its host tier.
* Every other branch is the reference's: mutual TLS (``tls``), the
  verifier federation (``[batch] federation_hosts`` or
  ``CORDA_TPU_FEDERATION``), the sidecar client and its device stamp
  (``[batch] sidecar`` / ``sidecar_devices``), raft notaries
  (``raft-simple`` / ``raft-validating``), the sharded notary
  (``[notary_shards]``), the indexed vault (``[vault] indexed``), the
  wire network map (``map_service`` / ``map_node``) and the web API
  (``web_port``).
"""

from __future__ import annotations

import logging
import os
import queue
import sys
import time
from collections import deque

from ..flows.data_vending import install_data_vending
from ..obs import telemetry as _tm
from ..obs import trace as _obs
from ..qos import context as _qos
from ..testing import faults as _faults
from ..utils.clock import Clock
from .config import NetMapEntry, NodeConfig, netmap_load, netmap_register
from .messaging.tcp import TcpMessaging
from .services.api import (
    NodeInfo,
    ServiceHub,
    ServiceInfo,
    ServiceType,
    SIMPLE_NOTARY,
    StorageService,
    VALIDATING_NOTARY,
)
from .services.inmemory import (
    InMemoryIdentityService,
    InMemoryNetworkMapCache,
    NodeVaultService,
    SimpleKeyManagementService,
)
from .services.notary import SimpleNotaryService, ValidatingNotaryService
from .services.persistence import (
    DBAttachmentStorage,
    DBTransactionMappingStorage,
    DBCheckpointStorage,
    DBTransactionStorage,
    NodeDatabase,
    PersistentUniquenessProvider,
)
from .statemachine import FlowHandle, StateMachineManager


def _make_verifier(kind: str):
    from ..crypto.provider import make_verifier

    return make_verifier(kind)


def _select_batch_verifier(config: NodeConfig):
    """Pick the node's verification provider from config + env.

    Precedence: federation_hosts (or CORDA_TPU_FEDERATION) -- the multi-
    host router over per-host sidecars (crypto/federation.py) -- then a
    single sidecar address (or CORDA_TPU_SIDECAR), then the local
    provider. With neither knob set this returns exactly the local
    provider.
    """
    federation = config.batch.federation_hosts or os.environ.get(
        "CORDA_TPU_FEDERATION", "")
    if federation:
        from ..crypto.federation import FederatedVerifier

        hosts = [h.strip() for h in federation.split(",") if h.strip()]
        return FederatedVerifier(
            hosts,
            deadline_ms=config.batch.sidecar_deadline_ms,
            devices=config.batch.sidecar_devices or None)
    sidecar_addr = config.batch.sidecar or os.environ.get(
        "CORDA_TPU_SIDECAR", "")
    if sidecar_addr:
        from .verify_client import SidecarVerifier

        return SidecarVerifier(
            sidecar_addr,
            deadline_ms=config.batch.sidecar_deadline_ms,
            devices=config.batch.sidecar_devices or None)
    return _make_verifier(config.verifier)


class Node:
    """One process-owning node instance over a base_dir."""

    def __init__(self, config: NodeConfig):
        self.config = config
        # Verification provider, chosen before anything is opened (a
        # "torch" verifier raises here on a host without a card): a sidecar
        # address feeds the host's shared device-owning server
        # (crypto/sidecar.py); else the local provider.
        verifier = _select_batch_verifier(config)
        if config.qos.enabled:
            # Arm the QoS plane BEFORE any subsystem that reads
            # _qos.ACTIVE at send/schedule time (messaging, SMM, raft).
            # Process-wide like the obs/faults arming; qos.enabled=False
            # leaves ACTIVE None and every instrumentation point is a
            # single attribute check — bit-identical to the pre-QoS tree.
            from ..qos import context as _qos_ctx

            _qos_ctx.arm(config.name, slo_ms=config.qos.slo_ms,
                         deadline_guard_ms=config.qos.deadline_guard_ms,
                         bulk_every=config.qos.bulk_every)
        config.base_dir.mkdir(parents=True, exist_ok=True)
        self.db = NodeDatabase(config.base_dir / "node.db")
        # Durability plane: the online scrubber is built here but only
        # started in start() (a constructed-but-unstarted node must not
        # carry a background thread). None when disarmed — every metrics
        # touch point short-circuits on that one attribute check.
        self.scrubber = None
        if config.durability.scrub_enabled:
            from .services.integrity import Scrubber

            self.scrubber = Scrubber(
                self.db.path,
                rows_per_s=config.durability.scrub_rows_per_s,
                interval_s=config.durability.scrub_interval_s,
                node_name=config.name)
        self.key = self.db.load_or_create_identity(config.name)
        from ..crypto.party import Party

        self.identity = Party.of(config.name, self.key.public)

        # -- messaging (starts listening immediately; handlers attach below) --
        # A restarted node must come back on its previous port so peers'
        # queued outbox bridges (keyed by host:port) reconnect — the stable-
        # address property Artemis queues give the reference. An ephemeral
        # first start records the allocated port.
        port = config.port
        if port == 0:
            stored = self.db.get_setting("listen_port")
            if stored is not None:
                port = int(stored)
        tls_paths = None
        if config.tls:
            # Dev-mode TLS: certs chain to a shared dev CA living beside the
            # network map file (configureWithDevSSLCertificate capability).
            from ..crypto.x509 import generate_dev_tls_material

            shared = (config.network_map.parent if config.network_map
                      else config.base_dir)
            tls_paths = generate_dev_tls_material(
                config.base_dir, shared, config.name, config.host)
        try:
            self.messaging = TcpMessaging(config.host, port, db=self.db,
                                          tls=tls_paths)
            self.messaging.start()
        except OSError:
            # Stored port taken (another process got it) — fall back to
            # ephemeral; netmap re-registration updates peers going forward.
            self.messaging = TcpMessaging(config.host, 0, db=self.db,
                                          tls=tls_paths)
            self.messaging.start()
        self.db.set_setting("listen_port", str(self.messaging.my_address.port))

        # -- advertised services ------------------------------------------
        services = ()
        if config.notary in ("simple", "raft-simple"):
            services = (ServiceInfo(SIMPLE_NOTARY),)
        elif config.notary in ("validating", "raft-validating"):
            services = (ServiceInfo(VALIDATING_NOTARY),)
        self._shard_epoch_advertised = 0
        if config.notary_shards is not None:
            # Shard members also advertise their group + the total shard
            # count ("corda.notary.shard.<g>of<n>[@epoch]"): the netmap
            # every party already syncs doubles as the shard directory, so
            # clients recover the full shard map with zero extra round
            # trips. Members of PENDING groups (index >= count — boot-ahead
            # split targets) advertise nothing until a reshard epoch
            # activates them, and a restart replays the group's durable
            # fence so the advertisement matches what the state machine
            # enforces (a retired member drops its shard string entirely).
            import json as _json

            from .services.sharding import shard_service_string

            my_group = next(
                (g for g, members in enumerate(config.notary_shards.groups)
                 if config.name in members), None)
            count, epoch = config.notary_shards.count, 0
            raw = self.db.get_setting("shard_fence")
            fence = _json.loads(raw) if raw else None
            if fence is not None and fence.get("mode") == "retired":
                my_group = None
                self._shard_epoch_advertised = int(fence["epoch"])
            elif fence is not None and fence.get("mode") == "active":
                my_group = int(fence["group"])
                count = int(fence["count"])
                epoch = int(fence["epoch"])
            if my_group is not None and my_group < count:
                services += (ServiceInfo(ServiceType(shard_service_string(
                    my_group, count, epoch))),)
                self._shard_epoch_advertised = epoch
        self.info = NodeInfo(
            address=self.messaging.my_address,
            legal_identity=self.identity,
            advertised_services=services,
        )

        # -- service hub ---------------------------------------------------
        self.identity_service = InMemoryIdentityService()
        self.network_map_cache = InMemoryNetworkMapCache()
        key_service = SimpleKeyManagementService([self.key])
        # Vault engine selection: [vault] indexed=true or the env var arms
        # the sqlite-backed IndexedVaultService (durable rows, O(log n)
        # queries, watermark incremental boot). Unset = the in-memory
        # engine, bit-identical to before the vault plane existed.
        self._vault_indexed = bool(config.vault.indexed) or os.environ.get(
            "CORDA_TPU_VAULT_INDEXED", "") not in ("", "0")
        if self._vault_indexed:
            from .services.vault import IndexedVaultService

            vault_service = IndexedVaultService(
                self.db, lambda: set(key_service.keys.keys()),
                softlock_ttl_s=config.vault.softlock_ttl_s)
        else:
            vault_service = NodeVaultService(
                lambda: set(key_service.keys.keys()))
        self.services = ServiceHub(
            identity_service=self.identity_service,
            key_management_service=key_service,
            storage_service=StorageService(
                validated_transactions=DBTransactionStorage(self.db),
                attachments=DBAttachmentStorage(self.db),
                state_machine_recorded_transaction_mapping=(
                    DBTransactionMappingStorage(self.db)),
            ),
            vault_service=vault_service,
            network_map_cache=self.network_map_cache,
            clock=Clock(),
            my_info=self.info,
        )

        # Bounded by construction (see _sample_metrics_maybe): a week-long
        # soak keeps exactly one hour of samples, never an unbounded list.
        self.metrics_history: deque[dict] = deque(
            maxlen=self.METRICS_HISTORY_KEEP)

        # This process's kernel launches (ops/kernels.py) as start()'s warm
        # left them, exported by node_metrics so that a node alone in its
        # process reports the launches its traffic made; None until a card
        # verifier has warmed.
        self.boot_launches: dict | None = None

        # -- state machine manager ----------------------------------------
        self.smm = StateMachineManager(
            service_hub=self.services,
            messaging=self.messaging,
            checkpoint_storage=DBCheckpointStorage(self.db),
            verifier=verifier,
            our_identity=self.identity,
            defer_verify=True,  # the run loop owns the flush policy
            defer_checkpoints=True,  # run_once flushes once per round
        )
        if config.batch.async_verify:
            # Pipelined verification: the run loop submits accumulated
            # batches to a feeder thread and keeps serving Raft/messages/
            # checkpoints while the verifier runs (crypto/async_verify.py).
            from ..crypto.async_verify import AsyncVerifyService

            self.smm.async_verify = AsyncVerifyService(
                self.smm.verifier, depth=config.batch.async_depth)
        # Unknown send targets trigger an on-demand refresh (a client that
        # registered after our last periodic refresh must be reachable the
        # moment its first SessionInit arrives). Throttled: a send to a
        # GENUINELY unknown party retries through redelivery backoff, and
        # each retry must not re-read the netmap file.
        self.smm.netmap_refresh = (
            lambda: self.refresh_netmap_maybe(every=0.25))

        # -- notary --------------------------------------------------------
        # Name -> TcpAddress for every netmap entry (superset of raft
        # peers); mutated in place by refresh_netmap so bound .get methods
        # stay live.
        self._netmap_addrs: dict = {}
        self.uniqueness_provider = None
        self.notary_service = None
        self.raft_member = None
        if config.notary != "none":
            if config.notary.startswith("raft"):
                from .services.raft import (
                    RaftMember,
                    RaftUniquenessProvider,
                    make_apply_command,
                )

                self.raft_member = RaftMember(
                    name=config.name,
                    peers={},  # populated from the netmap on refresh
                    messaging=self.messaging,
                    db=self.db,
                    apply_command=make_apply_command(self.db),
                    config=config.raft,  # commit-pipeline policy ([raft])
                )
                # Cross-group reply routing (sharded notary): resolve ANY
                # netmap member by name, not just this member's own peers,
                # so a coordinator in another group gets its ClientReply
                # back even though it is outside our raft_cluster.
                self.raft_member.resolve_addr = self._netmap_addrs.get
                if config.notary_shards is not None:
                    from .services.sharding import ShardedUniquenessProvider

                    self.uniqueness_provider = ShardedUniquenessProvider(
                        self.raft_member, pump=self._raft_pump,
                        shards=config.notary_shards)
                else:
                    self.uniqueness_provider = RaftUniquenessProvider(
                        self.raft_member, pump=self._raft_pump)
            else:
                self.uniqueness_provider = PersistentUniquenessProvider(self.db)
            cls = (ValidatingNotaryService
                   if config.notary.endswith("validating")
                   else SimpleNotaryService)
            self.notary_service = cls(
                self.smm, self.services, self.identity, self.key,
                self.uniqueness_provider)
            if config.qos.enabled:
                # Admission control at the notarise entry point: the
                # controller rides the service token NotaryServiceFlow
                # already carries (read via getattr — absent means no
                # admission work at all on the disabled path).
                from ..qos import AdmissionController

                self.notary_service.admission = AdmissionController(
                    interactive_rate=config.qos.interactive_rate,
                    interactive_burst=config.qos.interactive_burst,
                    bulk_rate=config.qos.bulk_rate,
                    bulk_burst=config.qos.bulk_burst,
                    queue_watermark=config.qos.queue_watermark)

        # -- vault rebuild + scheduler ------------------------------------
        # The vault is a projection of durable transaction storage: rebuild
        # it so a restarted node sees its unconsumed states (the
        # reference's vault is DB-backed; same post-restart capability).
        # Indexed engine: replay only the delta above its persisted
        # watermark. Legacy engine: stream the whole history through
        # notify_all in bounded batches — never the full ledger in memory.
        tx_storage = self.services.storage_service.validated_transactions
        if self._vault_indexed:
            self.services.vault_service.rebuild_from(
                tx_storage, batch=config.vault.rebuild_batch)
        else:
            chunk: list = []
            for _rowid, stx in tx_storage.stream_since(
                    0, batch=config.vault.rebuild_batch):
                chunk.append(stx)
                if len(chunk) >= config.vault.rebuild_batch:
                    self.services.vault_service.notify_all(chunk)
                    chunk = []
            if chunk:
                self.services.vault_service.notify_all(chunk)
        # Vault updates join the change feed so RPC push subscribers
        # (explorer) stream ledger activity live, alongside flow events
        # (the reference pushes vaultAndUpdates the same way,
        # CordaRPCOps.kt:71-76). Subscribed AFTER the rebuild replay above:
        # a restart must not re-emit the whole stored ledger as fresh
        # events to reconnecting push clients.
        self.services.vault_service.subscribe(
            lambda update: self.smm.changes.append(
                ("vault", len(update.consumed), len(update.produced))))
        # Provenance mappings join the feed too (observers fire only on
        # FRESH rows, so a restart replaying checkpointed flows does not
        # re-announce mappings already durable in tx_mappings): push
        # subscribers see which flow produced each transaction live
        # (reference: CordaRPCOps.kt:86 stateMachineRecordedTransaction
        # MappingStorage's observable half).
        self.services.storage_service.state_machine_recorded_transaction_mapping \
            .subscribe(lambda m: self.smm.changes.append(
                ("tx_recorded", m.run_id, m.tx_id.bytes)))
        from .services.scheduler import NodeSchedulerService
        from .services.vault_observers import (
            CashBalanceMetricsObserver,
            IndexedBalanceMetricsObserver,
        )

        self.scheduler = NodeSchedulerService(
            self.smm, self.services.vault_service)
        if self._vault_indexed:
            # The indexed engine already aggregates balances durably;
            # publish from its table instead of a second scanning tally.
            IndexedBalanceMetricsObserver(self.services.vault_service,
                                          self.smm.metrics)
        else:
            CashBalanceMetricsObserver(self.services.vault_service,
                                       self.smm.metrics)
        from .services.schema import SchemaObserver

        self.schema = SchemaObserver(self.services.vault_service, self.db)

        # -- network map directory service (wire tier) ---------------------
        self.netmap_service = None
        self.netmap_client = None
        if config.map_service:
            from .services.netmap_service import NetworkMapService

            self.netmap_service = NetworkMapService(self.messaging)

        install_data_vending(self.smm)

        # -- CorDapps (reference: plugin ServiceLoader, AbstractNode.kt:
        # 170-173,340-352): importing runs the registration decorators;
        # install(node) wires responders.
        import importlib

        for module_name in config.cordapps:
            module = importlib.import_module(module_name)
            installer = getattr(module, "install", None)
            if installer is not None:
                installer(self)

        # -- RPC (reference: RPCDispatcher.kt, RPCUserService.kt) ----------
        self.rpc = None
        if config.rpc_users:
            from .rpc import RpcDispatcher, RpcUser

            users = tuple(
                RpcUser(u["username"], u["password"],
                        tuple(u.get("permissions", ())))
                for u in config.rpc_users)
            self.rpc = RpcDispatcher(self, users)

        self.webserver = None
        self._started = False
        # Elastic resharding: the latest plan seen on the netmap (set by
        # refresh_netmap), and a throttle on the fence-observation poll.
        self._reshard_plan: tuple[int, int, int] | None = None
        self._fence_checked_at = 0.0

    # -- network map -------------------------------------------------------

    def register_and_refresh_netmap(self) -> None:
        """Write our entry to the shared netmap file, then (re)load peers
        into the cache and identity service."""
        path = self.config.network_map
        if path is None:
            return
        netmap_register(
            path, self.config.name, self.messaging.my_address.host,
            self.messaging.my_address.port, self.identity.owning_key,
            tuple(str(s.type) for s in self.info.advertised_services))
        self.refresh_netmap()

    def refresh_netmap(self) -> None:
        path = self.config.network_map
        if path is None:
            return
        if _faults.ACTIVE is not None:
            # Stale-directory injection: drop skips this refresh round (the
            # node keeps routing on its old map until the next cadence),
            # stall delays it, crash kills the process inside fire().
            act = _faults.ACTIVE.fire("netmap.refresh")
            if act is not None:
                action, delay_s = act
                if action == "drop":
                    return
                if delay_s > 0:
                    time.sleep(delay_s)
        entries = netmap_load(path)
        # Self-heal: if our own row vanished (a concurrent boot clobbered
        # the file before registration was flock-serialised, or an operator
        # replaced the map), write it back — registration is otherwise
        # boot-only, so a lost entry means no peer can ever reach us.
        if self._started and all(e.name != self.config.name for e in entries):
            netmap_register(
                path, self.config.name, self.messaging.my_address.host,
                self.messaging.my_address.port, self.identity.owning_key,
                tuple(str(s.type) for s in self.info.advertised_services))
            entries = netmap_load(path)
        plan = None
        for entry in entries:
            if entry.name.startswith("_"):
                # Control pseudo-entry (no node behind it, no parseable
                # key): the reshard plan rides the map as a service string.
                from .services.sharding import parse_reshard_plan

                for svc in entry.services:
                    parsed = parse_reshard_plan(svc)
                    if parsed is not None and (plan is None
                                               or parsed[0] > plan[0]):
                        plan = parsed
                continue
            info = entry.node_info()
            self.identity_service.register_identity(info.legal_identity)
            self.network_map_cache.add_node(info)
            self._netmap_addrs[entry.name] = info.address
            if (self.raft_member is not None
                    and entry.name in self.config.raft_cluster
                    and entry.name != self.config.name):
                self.raft_member.peers[entry.name] = info.address
        self._reshard_plan = plan

    def _raft_pump(self) -> None:
        """Drive consensus while a flow blocks in commit(): deliver raft
        messages (SMM session dispatch is re-entrancy-guarded and just
        queues) and advance election/heartbeat timers."""
        self.messaging.pump(timeout=0.001)
        if self.raft_member is not None:
            self.raft_member.tick()
            self.raft_member.flush_appends()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Node":
        """Register in the map, warm the device, restore checkpoints, resume
        flows. Raises if the device's warm-up fails."""
        # Web API binds here, not in __init__: a constructed-but-unstarted
        # (or failed) node must not hold a listener or serve half-built
        # state (reference: Node.kt starts Jetty inside start()).
        if self.config.web_port is not None and self.webserver is None:
            from .webserver import NodeWebServer

            self.webserver = NodeWebServer(
                self, self.config.host, self.config.web_port)
        self.register_and_refresh_netmap()
        if self.config.map_node and self.config.map_node != self.config.name:
            # Dynamic directory: the bootstrap file told us where the map
            # node lives; from here on registration + updates ride the wire
            # (reference: AbstractNode.registerWithNetworkMap,
            # AbstractNode.kt:377-411).
            from .services.netmap_service import NetworkMapClient

            map_info = next(
                (n for n in self.network_map_cache.party_nodes
                 if n.legal_identity.name == self.config.map_node), None)
            if map_info is None:
                raise RuntimeError(
                    f"map node {self.config.map_node!r} not in bootstrap map")
            self.netmap_client = NetworkMapClient(
                self.messaging, map_info.address, self.network_map_cache,
                self.identity_service, self.key)
            self.netmap_client.register(self.info)
            self.netmap_client.fetch_and_subscribe()
        # The warm must finish BEFORE checkpoint restore runs: smm.start()
        # replays checkpointed flows, and a restored backlog can flush a
        # >= device_min_sigs batch immediately — on a cold device that
        # batch would pay the kernels' build inside the run loop.
        self._warm_verifier_maybe()
        self.smm.start()
        if self.scrubber is not None:
            self.scrubber.start()
        self._started = True
        return self

    def _warm_verifier_maybe(self) -> None:
        """Build and launch the kernels of a verifier whose device tier is
        this package's CUDA kernels (a ``TorchVerifier`` on a CUDA device)
        before any flow runs: the first kernel build and launch would
        otherwise stall the run loop at the first >= device_min_sigs batch.
        A warm that raises fails start(): a node left on the host tier for
        good would hide the card. A CPU verifier has nothing to warm."""
        verifier = self.smm.verifier
        if not getattr(verifier, "name", "").startswith("torch"):
            return
        if getattr(getattr(verifier, "device", None), "type", None) != "cuda":
            return
        verifier.warm()
        from ..ops import kernels

        self.boot_launches = dict(kernels.LAUNCHES)

    def start_flow(self, logic) -> FlowHandle:
        return self.smm.add(logic)

    def run_once(self, timeout: float = 0.05) -> int:
        """One scheduling round: dispatch inbound messages, then apply the
        max-wait micro-batch policy. Returns messages dispatched.

        The whole round runs inside ONE db transaction (db.batch): every
        checkpoint, outbox frame, dedupe record and commit-log write the
        round produces becomes durable in a single commit, and only then
        does the transport ACK the round's inbound messages + wake outbound
        bridges (messaging.flush_round) — one fsync per round instead of
        one per mutation, with the same at-least-once redelivery contract."""
        batch = self.config.batch
        svc = self.smm.async_verify
        wait = timeout
        if self.smm.verify_pending_sigs:
            # Shrink the wait so the flush deadline is honoured.
            deadline = (self.smm.verify_waiting_since
                        + batch.max_wait_ms / 1e3)
            wait = max(0.0, min(timeout, deadline - time.monotonic()))
        if svc is not None and svc.in_flight:
            # A batch is on the feeder thread: come back quickly so its
            # completion (and the flows it resumes) isn't left sitting a
            # full idle timeout behind the device.
            wait = min(wait, 0.002)
        stages = self.smm.metrics.setdefault(
            "round_stage_s", {"lock": 0.0, "pump": 0.0, "pump_wait": 0.0,
                              "raft": 0.0, "services": 0.0, "verify": 0.0,
                              "verify_drain": 0.0, "verify_submit": 0.0,
                              "checkpoint": 0.0, "commit": 0.0, "rounds": 0})
        # Round profiler (obs/telemetry.py ROUND_PHASES): the always-on
        # breakdown that attributes round wall time to named sub-phases —
        # round_stage_s answers "which code block", this answers "which
        # pipeline phase" (and the raft segment is split seal/replicate/
        # apply from the leader's own phase accumulators).
        rp = self.smm.metrics.setdefault(
            "round_phase_s", {"poll": 0.0, "verify_wait": 0.0, "seal": 0.0,
                              "replicate": 0.0, "apply": 0.0, "reply": 0.0,
                              "wall": 0.0, "rounds": 0})
        rm = self.raft_member
        raft_pre = ((rm.phase_s["seal"], rm.phase_s["replicate"],
                     rm.phase_s["apply"]) if rm is not None else None)
        # Pipelined commit plane: executor wall time overlapped under this
        # round (accumulated by the executor thread, read as a delta here).
        # Tracked BESIDE the six phases — see format_breakdown's overlap
        # block — so phase coverage stays a partition of loop wall time.
        overlap_pre = (rm.overlap_s["apply"] if rm is not None else 0.0)
        t = time.perf_counter
        t_pre = t()
        try:
            with self.db.batch():
                t0 = t()
                stages["lock"] += t0 - t_pre
                # The transport's blocked seconds (TcpMessaging), read
                # around the pump: the part of its stage spent waiting.
                wait0 = getattr(self.messaging, "pump_wait_s", 0.0)
                n = self.messaging.pump(timeout=wait, max_messages=512,
                                        coalesce=batch.coalesce_ms / 1e3)
                t1 = t()
                pump_wait = (getattr(self.messaging, "pump_wait_s", 0.0)
                             - wait0)
                if self.raft_member is not None:
                    self.raft_member.tick()
                t2 = t()
                self.smm.poll_services()
                t3 = t()
                # Drain completed async verifies BEFORE flush_appends so a
                # raft commit submitted by a verify-resumed notary flow
                # replicates in THIS round's AppendEntries.
                self.smm.drain_async_verifies()
                t3d = t()
                if self.raft_member is not None:
                    # poll_services may have submitted commits; replicate
                    # them in THIS round (one coalesced AppendEntries per
                    # peer).
                    self.raft_member.flush_appends()
                t4 = t()
                self.scheduler.tick()
                pending = self.smm.verify_pending_sigs
                aged = pending and (
                    time.monotonic() - self.smm.verify_waiting_since
                    >= batch.max_wait_ms / 1e3)
                # Deadline-aware coalescing (QoS queueing point 1): an
                # interactive request's SLO deadline entering the guard
                # window flushes the micro-batch NOW instead of waiting
                # out max_wait_ms. False whenever the plane is disarmed.
                rushed = pending and self.smm.verify_deadline_pressure()
                if rushed and not aged and (svc is None
                                            or svc.can_submit()):
                    _qos.ACTIVE.counters["verify_early_flushes"] += 1
                    if _obs.ACTIVE is not None:
                        mark = _obs.now()
                        _obs.record("qos_flush", mark, mark,
                                    attrs={"point": "verify_batch"})
                if svc is not None:
                    # Pipelined: submit and continue. The gate targets the
                    # device crossover (accumulating ACROSS rounds) once
                    # the kernel is warm; a full pipeline keeps
                    # accumulating — bounded by depth, drained above.
                    if pending and svc.can_submit() and (
                            pending >= svc.target_sigs(batch.max_sigs)
                            or aged or rushed):
                        self.smm.submit_pending_verifies()
                elif pending and (pending >= batch.max_sigs or aged
                                  or rushed):
                    self.smm.flush_pending_verifies()
                t5 = t()
                self.smm.flush_checkpoints()
                if self.rpc is not None:
                    # Server-push: stream new change-feed events to RPC
                    # subscribers inside the round (the frames ride the
                    # durable outbox committed with it).
                    self.rpc.push_pending()
                t6 = t()
                # Stage accounting (cheap: 8 clock reads per round) is the
                # attribution artifact for the process-boundary throughput
                # work — exported via node_metrics like every counter.
                stages["pump"] += t1 - t0
                stages["pump_wait"] += pump_wait
                stages["raft"] += (t2 - t1) + (t4 - t3d)
                stages["services"] += t3 - t2
                stages["verify"] += (t3d - t3) + (t5 - t4)
                stages["verify_drain"] += t3d - t3
                stages["verify_submit"] += t5 - t4
                stages["checkpoint"] += t6 - t5
                stages["rounds"] += 1
        except BaseException as exc:
            # The round rolled back: its deferred ACKs must not be sent
            # (senders redeliver) and in-memory flow state is now AHEAD of
            # durable state — the process should be restarted; recovery
            # replays from the last committed round.
            abort = getattr(self.messaging, "abort_round", None)
            if abort is not None:
                abort()
            if isinstance(exc, Exception):
                # Crash dump (flight recorder, latched + never-raising):
                # the last window of metric deltas and spans, captured at
                # the failure, not at the post-restart repro attempt.
                # Shutdown paths (KeyboardInterrupt/SystemExit) are not
                # crashes and dump nothing.
                _tm.flight_trigger("crash", extra={
                    "error": f"{type(exc).__name__}: {exc}",
                    "node": self.config.name})
            raise
        stages["commit"] += t() - t6  # db.batch() exit = the round fsync
        t_end = t()
        rp["rounds"] += 1
        rp["wall"] += t_end - t_pre
        poll = t1 - t_pre
        verify_wait = (t3d - t3) + (t5 - t4)
        apply_s = t3 - t2  # service polling applies committed work
        reply = (t6 - t5) + (t_end - t6)  # checkpoint/push + round fsync
        seal_d = repl_d = 0.0
        if raft_pre is not None:
            seal_d = rm.phase_s["seal"] - raft_pre[0]
            repl_d = rm.phase_s["replicate"] - raft_pre[1]
            raft_apply_d = rm.phase_s["apply"] - raft_pre[2]
            apply_s += raft_apply_d
            # Whatever of the round's raft segment the leader phases did
            # not claim (tick bookkeeping, follower forwarding, election
            # checks) moves replication state — attribute it there rather
            # than inventing an "other" phase.
            repl_d += max(0.0, ((t2 - t1) + (t4 - t3d))
                          - seal_d - repl_d - raft_apply_d)
        rp["poll"] += poll
        rp["verify_wait"] += verify_wait
        rp["seal"] += seal_d
        rp["replicate"] += repl_d
        rp["apply"] += apply_s
        rp["reply"] += reply
        if rm is not None:
            overlap_d = rm.overlap_s["apply"] - overlap_pre
            if overlap_d > 0.0:
                rp["overlap_apply"] = (
                    rp.get("overlap_apply", 0.0) + overlap_d)
                if _tm.ACTIVE is not None:
                    _tm.inc("round_overlap_apply_seconds_total", overlap_d)
        if _tm.ACTIVE is not None:
            _tm.observe_round(t_end - t_pre, {
                "poll": poll, "verify_wait": verify_wait, "seal": seal_d,
                "replicate": repl_d, "apply": apply_s, "reply": reply})
        flush = getattr(self.messaging, "flush_round", None)
        if flush is not None:
            flush()
        self._sample_metrics_maybe()
        self._reshard_tick()
        return n

    # Counters HISTORY (the time-series half of the reference's JMX/Jolokia
    # export, reference: Node.kt:313,163): the run loop snapshots the metric
    # registry on a fixed cadence into a bounded ring served at
    # /api/metrics/history — a scrape-less monitoring bridge.
    METRICS_SAMPLE_S = 5.0
    METRICS_HISTORY_KEEP = 720  # one hour at the 5 s cadence

    _metrics_sampled_at = 0.0

    def _sample_metrics_maybe(self) -> None:
        now = time.monotonic()
        if now - self._metrics_sampled_at < self.METRICS_SAMPLE_S:
            return
        self._metrics_sampled_at = now
        snap = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.smm.metrics.items()}
        snap["ts"] = round(time.time(), 3)
        snap["flows_in_flight"] = self.smm.in_flight_count
        # The formatted round profile travels with every history sample so
        # the time-series shows phase SHARES drifting, not just raw sums.
        snap["round_breakdown"] = _tm.format_breakdown(
            self.smm.metrics.get("round_phase_s"))
        self.metrics_history.append(snap)  # deque(maxlen=KEEP) self-trims
        if _tm.ACTIVE is not None and _tm.ACTIVE.flight is not None:
            _tm.ACTIVE.flight.tick(_tm.ACTIVE.snapshot()["counters"])

    def run_forever(self) -> None:
        while True:
            self.run_once(timeout=0.05)
            self.refresh_netmap_maybe()

    _netmap_refreshed_at = 0.0

    def refresh_netmap_maybe(self, every: float = 1.0) -> None:
        now = time.monotonic()
        if now - self._netmap_refreshed_at >= every:
            self._netmap_refreshed_at = now
            self.refresh_netmap()

    # -- elastic resharding ------------------------------------------------

    RESHARD_FENCE_POLL_S = 0.2

    def _reshard_tick(self) -> None:
        """Advance the elastic-reshard machinery, once per run-loop round.
        Two halves, both no-ops outside a transition: (a) observe the local
        group's APPLIED fence (every RESHARD_FENCE_POLL_S — the fence only
        moves while a plan is live) and re-advertise the epoch'd service
        string once it activates, so clients re-deriving the directory see
        the new map; (b) drive the provider's handoff coordinator (active
        only on the source group's current leader)."""
        prov = self.uniqueness_provider
        if prov is None or not hasattr(prov, "reshard_tick"):
            return
        now = time.monotonic()
        if (self._reshard_plan is not None
                and now - self._fence_checked_at >= self.RESHARD_FENCE_POLL_S):
            self._fence_checked_at = now
            self._observe_fence()
        prov.reshard_tick(self._reshard_plan, now)

    def _observe_fence(self) -> None:
        """Align the advertisement + routing with the group's applied fence
        state. Every member does this from its OWN replicated state (not
        from the plan): a follower that applied the activation re-registers
        even if the coordinator died right after committing it."""
        import json as _json

        raw = self.db.get_setting("shard_fence")
        if not raw:
            return
        fence = _json.loads(raw)
        mode = fence.get("mode")
        if mode not in ("active", "retired"):
            return  # sealed/importing: keep the old advertisement
        epoch = int(fence["epoch"])
        if epoch <= self._shard_epoch_advertised:
            return
        from .services.sharding import (
            SHARD_SERVICE_PREFIX,
            shard_service_string,
        )

        base = tuple(s for s in self.info.advertised_services
                     if not str(s.type).startswith(SHARD_SERVICE_PREFIX))
        if mode == "active":
            base += (ServiceInfo(ServiceType(shard_service_string(
                int(fence["group"]), int(fence["count"]), epoch))),)
        # mode == "retired": the shard string is dropped — the member keeps
        # serving its raft group (so lagging replicas can catch up and
        # in-flight replies drain) but no client routes new work at it.
        self.info = NodeInfo(
            address=self.info.address,
            legal_identity=self.info.legal_identity,
            advertised_services=base,
        )
        path = self.config.network_map
        if path is not None:
            netmap_register(
                path, self.config.name, self.messaging.my_address.host,
                self.messaging.my_address.port, self.identity.owning_key,
                tuple(str(s.type) for s in self.info.advertised_services))
        self._shard_epoch_advertised = epoch
        self.uniqueness_provider.reconfigure(int(fence["count"]), epoch)

    def stop(self) -> None:
        if self.webserver is not None:
            self.webserver.stop()
        svc = self.smm.async_verify
        if svc is not None and not svc.close(timeout=30.0):
            # A feeder blocked inside a wedged device call cannot be
            # joined: report and prefer process death over finalization.
            logging.getLogger("corda_tpu_torch.node").warning(
                "async verify feeder still running after stop(); "
                "interpreter exit may abort — exit this process via "
                "process death, not finalization")
        self.messaging.stop()
        rm = self.raft_member
        if rm is not None:
            # The raft apply executor writes committed_states under
            # db.lock: drain what it holds, then end its thread, before the
            # store closes, so no thread writes to a closed sqlite.
            try:
                rm.quiesce_apply()
            except Exception:
                logging.getLogger("corda_tpu_torch.node").exception(
                    "raft apply executor did not drain at stop()")
            thread, q = rm._apply_thread, rm._apply_queue
            if thread is not None and thread.is_alive():
                try:
                    q.put(None, timeout=1.0)  # the executor's shutdown mark
                except queue.Full:
                    logging.getLogger("corda_tpu_torch.node").warning(
                        "raft apply queue still full at stop(): the "
                        "executor's shutdown mark was not queued")
                thread.join(timeout=5.0)
        if self.scrubber is not None:
            # Before db.close(): the scrubber holds its own connection, but
            # a pass racing teardown must wind down while the store is
            # still guaranteed to exist.
            self.scrubber.stop()
        self.db.close()


def main(argv: list[str] | None = None) -> int:
    import faulthandler
    import signal

    # Operator diagnostics: `kill -USR1 <pid>` dumps every thread's stack to
    # stderr (the node.log) — the moral equivalent of a JVM thread dump.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # SIGTERM (the driver's and a service manager's stop) ends the process
    # like Ctrl-C: once the run loop runs, the node stops (pump joined,
    # listener and store closed) and the process exits 0.
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(0))
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m corda_tpu_torch.node.node <config.toml>",
              file=sys.stderr)
        return 2
    config = NodeConfig.load(argv[0])
    # Chaos harness: CORDA_TPU_FAULT_PLAN=<plan.toml> arms a deterministic
    # fault plan for this process (per-node rules filter on config.name).
    from ..testing import faults as _faults

    _faults.arm_from_env(config.name)
    # Tracing: CORDA_TPU_TRACE=1 (or a span capacity) arms the per-process
    # SpanRecorder; spans export via /api/trace + the trace_snapshot RPC.
    from ..obs import trace as _obs

    _obs.arm_from_env(config.name)
    # QoS plane: normally armed from [qos] in the config (Node.__init__);
    # CORDA_TPU_QOS arms it env-wise for ad-hoc runs. A no-op when unset.
    _qos.arm_from_env(config.name)
    # Flight recorder (obs/telemetry.py): CORDA_TPU_FLIGHT_DIR=<dir> arms
    # auto-dumps for this process (fsck failure, crash, overload spike).
    # Attached BEFORE the fsck gate so a corrupt boot is itself captured.
    _tm.ensure_flight(node=config.name)
    # Boot fsck: verify the store's integrity frames before serving.
    # Log-only here — corruption found at boot is reported loudly and then
    # handled by the online planes (raft heal / checkpoint quarantine);
    # operators wanting a hard gate run `python -m corda_tpu_torch.tools.fsck
    # <base-dir> --repair` before start.
    try:
        from ..tools.fsck import fsck_paths

        report = fsck_paths(config.base_dir)
        if not report["clean"]:
            logging.getLogger("corda_tpu_torch.node").error(
                "boot fsck: %d corrupt row(s) across %d store(s) — "
                "self-healing will repair what consensus can; run "
                "corda_tpu_torch.tools.fsck --repair for the rest",
                report["corrupt"], report["stores"])
            # Capture the corrupt-boot evidence at the moment it was
            # found (latched; a crash-restart loop dumps once).
            _tm.flight_trigger("fsck_failure", extra={
                k: report[k] for k in ("path", "stores", "clean",
                                       "corrupt", "scanned")})
    except Exception:
        # Never block boot on the checker itself (e.g. a locked store
        # during a crash-restart race) — the online scrubber covers it.
        logging.getLogger("corda_tpu_torch.node").exception("boot fsck failed")
    node = Node(config)
    try:
        node.start()
    except Exception:
        # A failed device warm-up (or netmap registration) must not leave a
        # node serving on the host tier: report, release, exit non-zero.
        logging.getLogger("corda_tpu_torch.node").exception(
            "node %s failed to start", config.name)
        node.stop()
        return 1
    print(f"node {config.name} up at {node.messaging.my_address}", flush=True)
    # Attribution hook: CORDA_TPU_NODE_PROFILE=<dir> dumps a cProfile of
    # the whole run loop to <dir>/<name>.pstats on shutdown (SIGTERM
    # included) — how the process-boundary throughput gap was measured.
    profile_dir = os.environ.get("CORDA_TPU_NODE_PROFILE")
    profiler = None
    if profile_dir:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()

        def _dump(signum=None, frame=None):
            profiler.disable()
            path = os.path.join(profile_dir, f"{config.name}.pstats")
            try:
                profiler.dump_stats(path)
            finally:
                if signum is not None:
                    raise SystemExit(0)

        signal.signal(signal.SIGTERM, _dump)
    try:
        node.run_forever()
    except (KeyboardInterrupt, SystemExit):
        node.stop()
    finally:
        if profiler is not None:
            _dump()
    return 0


if __name__ == "__main__":
    sys.exit(main())
