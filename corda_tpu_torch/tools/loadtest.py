"""Loadtest + notary-demo driver: firehose a notary (cluster) and disrupt it.

Capability match for the reference's load/chaos tooling and demo driver
(reference: tools/loadtest/src/main/kotlin/net/corda/loadtest/LoadTest.kt:
39-144 — generate/execute/gather loop with convergence checking;
Disruption.kt:18-60 — node kill/restart fault injection; and
samples/raft-notary-demo/src/main/kotlin/net/corda/notarydemo/NotaryDemo.kt:
14-29 — the issue+move firehose through NotaryFlow.Client).

Everything runs in one process over real TCP sockets + sqlite nodes (the
reference drives remote JVMs over SSH; the in-process form keeps the same
measurement semantics — real transport, real persistence, real consensus —
without a cluster). Disruptions kill a node mid-run and rebuild it purely
from its base_dir.

The port's own copy of ``corda_tpu/tools/loadtest.py``: every harness, its
result fields and its CLI. What differs: the verifier kinds are the port's
(``cpu``, ``torch``, ``torch-shadow``; a ``jax*`` kind is refused at argument
parsing) and every entry point runs on the card unless the caller asks for
the CPU -- ``verifier`` defaults to ``"torch"`` and ``notary_device`` /
``--notary-device`` to ``"accelerator"``. A harness asked for ``torch`` on a
host without a card raises (the node or sidecar refuses to start); it never
carries on with ``cpu``. Spawned nodes load the port's cordapps
(``corda_tpu_torch.testing.dummies``, ``corda_tpu_torch.tools.loadgen``). A
card process warms its kernels in line before it listens, so
``device_warm_wait_s`` is the time from the members' banners to traffic
(no warm gate is left open to poll).

CLI:
  python -m corda_tpu_torch.tools.loadtest --tx 200 --notary simple
  python -m corda_tpu_torch.tools.loadtest --tx 200 --notary raft --disrupt kill-follower
  python -m corda_tpu_torch.tools.loadtest --tx 200 --notary raft --processes \
      --trace /tmp/notary.trace.json   # open in ui.perfetto.dev
  python -m corda_tpu_torch.tools.loadtest --tx 20 --verifier cpu \
      --notary-device cpu   # on a host without a card
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..flows.api import FlowLogic, register_flow
from ..flows.notary import NotaryClientFlow
from ..node.config import BatchConfig, NodeConfig
from ..node.node import Node
from ..obs import doctor as _doctor
from ..obs import telemetry as _tm
from ..testing.dummies import DummyContract
# Codec registration for the coordinator process: FirehoseResult rides the
# flow_result RPC reply and must be decodable HERE, not just in the client
# node processes that run the flow.
from . import loadgen as _loadgen  # noqa: F401


@dataclass
class LoadTestResult:
    tx_requested: int
    tx_committed: int
    tx_rejected: int
    duration_s: float
    tx_per_sec: float
    p50_ms: float
    p99_ms: float
    sigs_verified: int
    verify_batches: int
    disruptions: list = field(default_factory=list)
    trace_file: str | None = None  # merged Chrome/Perfetto JSON (--trace)

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def _make_node(base: Path, name: str, **kw) -> Node:
    return Node(NodeConfig(
        name=name, base_dir=base / name, network_map=base / "netmap.json",
        **kw)).start()


def _rebuild(config: NodeConfig) -> Node:
    return Node(NodeConfig(
        name=config.name, base_dir=config.base_dir, notary=config.notary,
        raft_cluster=config.raft_cluster, network_map=config.network_map,
        batch=config.batch, verifier=config.verifier,
        notary_shards=config.notary_shards,
        # A rebuilt member must rejoin with the SAME commit-plane policy
        # (pipeline/apply_queue_depth/...) — silently reverting to defaults
        # would let a chaos run flip a serial A/B leg pipelined mid-kill.
        raft=config.raft)).start()


def _collect_trace_snapshots(rpcs) -> list[dict]:
    """Gather every node process's span buffer over RPC (trace_snapshot is
    the RPC twin of GET /api/trace). A dead node costs its spans, not the
    run — the merged trace is honestly partial."""
    snapshots: list[dict] = []
    for rpc in rpcs:
        try:
            snap = rpc.call("trace_snapshot")
        except Exception:
            continue
        if snap and snap.get("spans"):
            snapshots.append(snap)
    return snapshots


def _write_trace(path: str, snapshots: list[dict]) -> str | None:
    if not snapshots:
        return None
    from ..obs.collect import write_chrome_trace

    write_chrome_trace(path, snapshots)
    return path


def _inproc_trace_snapshot() -> list[dict]:
    """Snapshot the process-global recorder for in-process harnesses, where
    every node shares one ring (spans self-attribute via their node field)."""
    from ..obs import trace as _obs

    rec = _obs.ACTIVE
    if rec is None:
        return []
    return [{"node": rec.node_name or "inproc", "armed": True,
             "spans": rec.snapshot(), "stats": rec.stats()}]


def run_loadtest(
    n_tx: int = 100,
    notary: str = "simple",  # simple | validating | raft
    cluster_size: int = 3,
    disrupt: str | None = None,  # kill-notary | kill-follower | None
    verifier: str = "torch",
    batch: BatchConfig | None = None,
    base_dir: str | None = None,
    max_seconds: float = 120.0,
    trace: str | None = None,  # write a merged Chrome/Perfetto trace here
) -> LoadTestResult:
    from ..obs import trace as _obs

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-load-"))
    batch = batch or BatchConfig()
    notaries: list[Node] = []
    disruptions: list[str] = []
    armed_here = None
    if trace and _obs.ACTIVE is None:
        # In-process run: every node shares the process-global recorder.
        armed_here = _obs.arm("inproc")

    if notary == "raft":
        cluster = tuple(f"Raft{i}" for i in range(cluster_size))
        for name in cluster:
            notaries.append(_make_node(
                base, name, notary="raft-simple", raft_cluster=cluster,
                verifier=verifier, batch=batch))
    else:
        notaries.append(_make_node(base, "Notary", notary=notary,
                                   verifier=verifier, batch=batch))
    client = _make_node(base, "LoadClient", verifier=verifier, batch=batch)
    nodes = notaries + [client]
    for n in nodes:
        n.refresh_netmap()

    if notary == "raft":  # wait for a leader before the firehose
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            for n in nodes:
                n.run_once(timeout=0.005)
            if any(n.raft_member.role == "leader" for n in notaries):
                break
        else:
            raise RuntimeError("raft cluster failed to elect")

    target = notaries[0].identity
    # The firehose workload: issue (local) + move (notarised) per tx —
    # the raft-notary-demo shape (NotaryDemoApi issue+move).
    stxs = []
    for i in range(n_tx):
        builder = DummyContract.generate_initial(
            client.identity.ref(i.to_bytes(4, "big")), i, target)
        builder.sign_with(client.key)
        issue_stx = builder.to_signed_transaction()
        client.services.record_transactions([issue_stx])
        move = DummyContract.move(issue_stx.tx.out_ref(0),
                                  client.identity.owning_key)
        move.sign_with(client.key)
        stxs.append(move.to_signed_transaction(
            check_sufficient_signatures=False))

    t0 = time.perf_counter()
    done_at: list[float] = []
    handles = []
    for stx in stxs:
        h = client.start_flow(NotaryClientFlow(stx))
        h.result.add_done_callback(
            lambda _f: done_at.append(time.perf_counter() - t0))
        handles.append(h)

    disrupted = False
    deadline = time.monotonic() + max_seconds
    while time.monotonic() < deadline:
        for n in nodes:
            n.run_once(timeout=0.002)
        completed = sum(1 for h in handles if h.result.done)
        if not disrupted and disrupt and completed >= n_tx // 3:
            disrupted = True
            if disrupt == "kill-notary" or notary != "raft":
                victim = notaries[0]
            else:  # kill-follower: keep quorum; don't kill the leader
                victim = next(
                    (n for n in notaries if n.raft_member.role != "leader"),
                    notaries[-1])
            cfg = victim.config
            victim.stop()
            nodes.remove(victim)
            notaries.remove(victim)
            disruptions.append(f"killed {cfg.name} after {completed} tx")
            reborn = _rebuild(cfg)
            notaries.append(reborn)
            nodes.append(reborn)
            for n in nodes:
                n.refresh_netmap()
            disruptions.append(f"rebuilt {cfg.name} from disk")
        if completed == n_tx:
            break
    duration = time.perf_counter() - t0

    committed = rejected = 0
    for h in handles:
        if not h.result.done:
            continue
        if h.result.exception() is None:
            committed += 1
        else:
            rejected += 1
    lat = sorted(done_at) or [0.0]
    metrics = client.smm.metrics
    notary_metrics = [n.smm.metrics for n in notaries]
    result = LoadTestResult(
        tx_requested=n_tx,
        tx_committed=committed,
        tx_rejected=rejected,
        duration_s=round(duration, 3),
        tx_per_sec=round(len(done_at) / duration, 1) if done_at else 0.0,
        p50_ms=round(1e3 * lat[len(lat) // 2], 2),
        p99_ms=round(1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))], 2),
        sigs_verified=metrics["verify_sigs"]
        + sum(m["verify_sigs"] for m in notary_metrics),
        verify_batches=metrics["verify_batches"]
        + sum(m["verify_batches"] for m in notary_metrics),
        disruptions=disruptions,
    )
    if trace:
        result.trace_file = _write_trace(trace, _inproc_trace_snapshot())
        if armed_here is not None:
            _obs.disarm()
    for n in nodes:
        n.stop()
    return result


@register_flow
class RetryingNotariseFlow(FlowLogic):
    """Chaos-harness client flow: notarise with the PRODUCT retry policy
    (deadline-bounded, exponential backoff, leader-hint redirects) so an
    availability window — a killed leader, an election — is ridden out
    instead of reported as a failure. The plain loadtest keeps calling
    NotaryClientFlow raw; this flow exists to measure recovery, not to
    mask unavailability."""

    def __init__(self, stx, deadline_s: float = 60.0):
        self.stx = stx
        self.deadline_s = deadline_s

    def call(self):
        from ..flows.notary import notarise_with_retry

        sig = yield from notarise_with_retry(
            self, self.stx, deadline_s=self.deadline_s)
        return sig


@dataclass
class ChaosResult:
    """One chaos loadtest run: outcome audit + measured recovery."""

    plan: str | None
    tx_requested: int
    tx_committed: int
    tx_rejected: int
    tx_unresolved: int  # flows that never completed (MUST be 0)
    exactly_once: bool  # committed==requested, none rejected/lost/doubled
    cluster_committed: int  # committed_states rows on the leader
    duration_s: float
    tx_per_sec: float
    p50_ms: float
    p99_ms: float
    faults_injected: dict = field(default_factory=dict)
    leader_kill_recovery_s: float | None = None
    disruptions: list = field(default_factory=list)
    trace_file: str | None = None  # merged Chrome/Perfetto JSON (--trace)
    # Sharded-notary runs: shard count, how many of the requested txs
    # consumed inputs on two shards, per-group committed rows, and live
    # reservation rows left after the drain (MUST be 0 — a leak means a
    # 2PC wedged inputs past its TTL backstop).
    shards: int = 0
    cross_requested: int = 0
    per_group_committed: list = field(default_factory=list)
    reserved_leaked: int | None = None
    # Durability plane: corruption detections summed over every member's
    # raft stamp (> 0 proves a disk.corrupt plan actually fired AND was
    # caught), and the post-run fsck gate verdict over every surviving
    # node's store (None = gate skipped, e.g. a node died un-stopped).
    integrity_errors: int = 0
    fsck_clean: bool | None = None

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def run_chaos_loadtest(
    plan=None,  # FaultPlan | builtin name | path to a plan TOML | None
    n_tx: int = 60,
    cluster_size: int = 3,
    kill_leader: bool = False,
    verifier: str = "torch",
    batch: BatchConfig | None = None,
    base_dir: str | None = None,
    max_seconds: float = 180.0,
    rate_tx_s: float = 0.0,  # >0: open-loop pacing, latency from schedule
    retry_deadline_s: float = 60.0,
    trace: str | None = None,  # write a merged Chrome/Perfetto trace here
    shards: int = 0,  # >0: that many Raft GROUPS of cluster_size members
    # each (sharded notary, services/sharding.py); kill_leader then kills
    # group 0's leader mid-burst
    cross_frac: float = 0.0,  # fraction of txs spending inputs on TWO
    # shards (the 2PC path); only meaningful with shards >= 2
    reserve_ttl_s: float = 15.0,
) -> ChaosResult:
    """Chaos mode: an in-process raft cluster + client over REAL TCP and
    sqlite, with a deterministic FaultPlan armed process-wide and/or the
    LEADER killed mid-burst and rebuilt from disk. Clients notarise through
    RetryingNotariseFlow (the product retry policy), so the run audits the
    end-to-end exactly-once contract: every tx committed exactly once, none
    lost, none rejected, no input double-spent — and measures recovery
    (first completion after the kill) plus tail latency under faults.

    In-process runs share ONE plan across client and members; `crash`
    actions would kill the whole harness — use process-level kill_leader
    (or the driver's env_extra arming) for crash faults."""
    from ..testing import faults

    plan_obj = None
    if plan is not None:
        if isinstance(plan, faults.FaultPlan):
            plan_obj = plan
        elif isinstance(plan, (str, Path)):
            text = None
            p = Path(plan)
            if p.suffix == ".toml" or p.exists():
                text = p.read_text(encoding="utf-8")
            if text is not None:
                plan_obj = faults.plan_from_toml(text)
            else:
                plan_obj = faults.builtin_plan(str(plan))
        else:
            raise TypeError(f"plan: expected FaultPlan/str/Path, got {plan!r}")

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-chaos-"))
    batch = batch or BatchConfig()
    disruptions: list[str] = []
    notaries: list[Node] = []
    group_nodes: list[list[Node]] = []
    shard_cfg = None
    if shards > 0:
        from ..node.config import ShardConfig

        groups = tuple(
            tuple(f"Shard{g}{chr(ord('A') + m)}" for m in range(cluster_size))
            for g in range(shards))
        shard_cfg = ShardConfig(count=shards, groups=groups,
                                reserve_ttl_s=reserve_ttl_s)
    cluster = tuple(f"Raft{i}" for i in range(cluster_size))
    from ..obs import trace as _obs

    armed_here = None
    if trace and _obs.ACTIVE is None:
        armed_here = _obs.arm("inproc")
    if plan_obj is not None:
        faults.arm(plan_obj)
    try:
        if shard_cfg is not None:
            for names in shard_cfg.groups:
                row = [_make_node(
                    base, name, notary="raft-simple", raft_cluster=names,
                    notary_shards=shard_cfg, verifier=verifier, batch=batch)
                    for name in names]
                group_nodes.append(row)
                notaries.extend(row)
        else:
            for name in cluster:
                notaries.append(_make_node(
                    base, name, notary="raft-simple", raft_cluster=cluster,
                    verifier=verifier, batch=batch))
            group_nodes = [list(notaries)]
        client = _make_node(base, "ChaosClient", verifier=verifier,
                            batch=batch)
        nodes = notaries + [client]
        for n in nodes:
            n.refresh_netmap()
        deadline = time.monotonic() + 20.0 + 10.0 * len(group_nodes)
        while time.monotonic() < deadline:
            for n in nodes:
                n.run_once(timeout=0.005)
            if all(any(n.raft_member.role == "leader" for n in row)
                   for row in group_nodes):
                break
        else:
            raise RuntimeError("raft cluster(s) failed to elect")

        if plan_obj is not None and plan_obj.partitions:
            # Auto-sided partition specs bind over the live cluster,
            # LEADER first: the builtins put the first n//2 identities on
            # side a, so the acting leader of group 0 lands in the
            # minority and the cut proves leader deposition, not just
            # follower lag. The client stays outside every cut.
            ordered = sorted(
                group_nodes[0],
                key=lambda n: n.raft_member.role != "leader")
            ordered += [n for row in group_nodes[1:] for n in row]
            plan_obj.bind_partition_nodes(
                [n.messaging.my_address for n in ordered])
            disruptions.append("partition sides bound (leader first)")

        target = notaries[0].identity
        # Mixed workload: every round(1/cross_frac)-th move consumes TWO
        # issued states owned by DIFFERENT shards (the 2PC path); the rest
        # are the plain single-input moves.
        from ..node.services.sharding import shard_of

        cross_every = round(1.0 / cross_frac) if cross_frac > 0.0 else 0
        cross_requested = 0
        stxs = []

        def _issue(i: int) -> object:
            builder = DummyContract.generate_initial(
                client.identity.ref((i % (1 << 30)).to_bytes(4, "big")),
                i, target)
            builder.sign_with(client.key)
            issue_stx = builder.to_signed_transaction()
            client.services.record_transactions([issue_stx])
            return issue_stx.tx.out_ref(0)

        for i in range(n_tx):
            priors = [_issue(i)]
            if cross_every and shards > 1 and i % cross_every == 0:
                cross_requested += 1
                for attempt in range(1, 17):
                    p2 = _issue(i + n_tx * attempt)
                    if (shard_of(p2.ref, shards)
                            != shard_of(priors[0].ref, shards)):
                        break
                priors.append(p2)
            move = DummyContract.move(priors, client.identity.owning_key)
            move.sign_with(client.key)
            stxs.append(move.to_signed_transaction(
                check_sufficient_signatures=False))

        t0 = time.perf_counter()
        completions: list[float] = []  # completion times since t0
        lat: list[float] = []  # per-tx latency (from schedule when paced)
        handles = []
        submitted = 0
        killed_at: float | None = None
        run_deadline = time.monotonic() + max_seconds
        while time.monotonic() < run_deadline:
            now = time.perf_counter() - t0
            while submitted < n_tx and (
                    rate_tx_s <= 0 or now >= submitted / rate_tx_s):
                sched = submitted / rate_tx_s if rate_tx_s > 0 else 0.0
                h = client.start_flow(RetryingNotariseFlow(
                    stxs[submitted], retry_deadline_s))

                def _done(_f, sched=sched):
                    t = time.perf_counter() - t0
                    completions.append(t)
                    lat.append(t - sched)

                h.result.add_done_callback(_done)
                handles.append(h)
                submitted += 1
                if rate_tx_s > 0:
                    now = time.perf_counter() - t0
            for n in nodes:
                n.run_once(timeout=0.002)
            completed = sum(1 for h in handles if h.result.done)
            if (kill_leader and killed_at is None
                    and completed >= max(1, n_tx // 3)):
                # Sharded: kill GROUP 0's leader (one shard degraded, the
                # others keep committing — the blast-radius story).
                victim = next(
                    (n for n in group_nodes[0]
                     if n.raft_member.role == "leader"), None)
                if victim is not None:
                    cfg = victim.config
                    victim.stop()
                    nodes.remove(victim)
                    notaries.remove(victim)
                    group_nodes[0].remove(victim)
                    killed_at = time.perf_counter() - t0
                    disruptions.append(
                        f"killed leader {cfg.name} after {completed} tx")
                    reborn = _rebuild(cfg)
                    notaries.append(reborn)
                    nodes.append(reborn)
                    group_nodes[0].append(reborn)
                    for n in nodes:
                        n.refresh_netmap()
                    disruptions.append(f"rebuilt {cfg.name} from disk")
            if submitted == n_tx and completed == n_tx:
                break
        duration = time.perf_counter() - t0

        committed = rejected = unresolved = 0
        for h in handles:
            if not h.result.done:
                unresolved += 1
            elif h.result.exception() is None:
                committed += 1
            else:
                rejected += 1
        unresolved += n_tx - submitted
        # Cluster-side audit, per Raft group: committed_states rows count
        # consumed REFS — single-input moves contribute 1, cross-shard
        # moves 2 (one on each owning group) — so across groups the rows
        # must total exactly n_tx + cross_requested. Fewer means lost
        # commits, more means a double-spend got through. Per group the
        # most-caught-up member is authoritative (followers may trail).
        per_group_committed = [
            max((n.uniqueness_provider.committed_count for n in row
                 if getattr(n, "uniqueness_provider", None) is not None),
                default=0)
            for row in group_nodes]
        cluster_committed = sum(per_group_committed)
        expected_rows = n_tx + cross_requested
        reserved_leaked = None
        if shards > 0:
            # Live holds after the drain: every member of every group must
            # show zero (a leaked reservation = a wedged input the TTL
            # failed to release).
            reserved_leaked = sum(
                min((n.raft_member.stamp()["reserved_states"]
                     for n in row), default=0)
                for row in group_nodes)
        recovery = None
        if killed_at is not None:
            after = [t for t in completions if t > killed_at]
            recovery = round(min(after) - killed_at, 3) if after else None
        # Durability audit: detections counted by the replicas themselves
        # (read BEFORE stop() — stamps need live members).
        integrity_errors = sum(
            n.raft_member.stamp()["integrity_errors"]
            for row in group_nodes for n in row
            if getattr(n, "raft_member", None) is not None)
        srt = sorted(lat) or [0.0]
        result = ChaosResult(
            plan=(getattr(plan, "name", None) or str(plan)
                  if not isinstance(plan, faults.FaultPlan) else "custom")
                 if plan is not None else None,
            tx_requested=n_tx,
            tx_committed=committed,
            tx_rejected=rejected,
            tx_unresolved=unresolved,
            exactly_once=(committed == n_tx and rejected == 0
                          and unresolved == 0
                          and cluster_committed == expected_rows
                          and not reserved_leaked),
            cluster_committed=cluster_committed,
            duration_s=round(duration, 3),
            tx_per_sec=round(committed / duration, 1) if duration else 0.0,
            p50_ms=round(1e3 * srt[len(srt) // 2], 2),
            p99_ms=round(1e3 * srt[min(len(srt) - 1,
                                       int(len(srt) * 0.99))], 2),
            faults_injected=(plan_obj.injected() if plan_obj is not None
                             else faults.injected()),
            leader_kill_recovery_s=recovery,
            disruptions=disruptions,
            shards=shards,
            cross_requested=cross_requested,
            per_group_committed=per_group_committed,
            reserved_leaked=reserved_leaked,
            integrity_errors=integrity_errors,
        )
        if trace:
            result.trace_file = _write_trace(trace, _inproc_trace_snapshot())
        for n in nodes:
            n.stop()
        # Post-run fsck gate: every surviving node's STORED bytes must
        # verify clean after the soak. Runs with faults disarmed (below the
        # finally would be too late for the report), so an injected
        # read-path bit-flip — which never touches disk — does not fail the
        # gate, while real on-disk damage (or a torn write) does.
        was_armed, faults.ACTIVE = faults.ACTIVE, None
        try:
            from .fsck import fsck_paths

            result.fsck_clean = fsck_paths(base)["clean"]
        finally:
            faults.ACTIVE = was_armed
        return result
    finally:
        if plan_obj is not None:
            faults.disarm()
        if armed_here is not None:
            _obs.disarm()


@dataclass
class PartitionResult:
    """One partition soak: cut -> hold -> heal, with the client history
    audited against the ledger (testing/history.py)."""

    plan: str
    prevote: bool
    isolate: str            # leader | follower (who the cut puts alone)
    cluster_size: int
    tx_requested: int
    tx_committed: int
    tx_rejected: int
    tx_unresolved: int
    duration_s: float
    cut_at_s: float
    healed_at_s: float | None
    # Heal -> first post-heal commit completion (the recovery observable
    # the bench gates on; None = nothing completed after the heal).
    recovery_s: float | None
    # Max member term delta across the soak: bounded with prevote on,
    # grows with every futile minority timeout with it off.
    term_before: int = 0
    term_after: int = 0
    max_term_inflation: int = 0
    # Ledger advance observed on the minority side WHILE the cut held
    # (MUST be 0 — a lone leader applying state is the split-brain bug).
    minority_commits_during_cut: int = 0
    # Summed member stamps (raft.py round-20 counters).
    elections_won: int = 0
    prevotes: int = 0
    prevote_rejections: int = 0
    checkquorum_stepdowns: int = 0
    leader_stepdowns: int = 0
    # Fault-engine counters: cut transitions + frames eaten by cuts.
    partition_cuts: int = 0
    partition_drops: int = 0
    # Auditor verdict (check_history) — the flat gate bit plus evidence.
    history_linearizable: bool = False
    history_events: int = 0
    lost_acks: int = 0
    double_spends: int = 0
    fail_conflicts: int = 0
    unresolved_ops: int = 0
    history: dict = field(default_factory=dict)
    disruptions: list = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def run_partition_loadtest(
    plan=None,  # FaultPlan | builtin name | plan TOML path | None = held split
    n_tx: int = 60,
    cluster_size: int = 3,
    prevote: bool = True,
    isolate: str = "leader",  # who the auto-bound minority side holds
    precut_frac: float = 0.25,  # txs committed BEFORE the cut arms
    cut_hold_s: float = 6.0,  # wall-clock hold before the timed heal
    verifier: str = "torch",
    batch: BatchConfig | None = None,
    base_dir: str | None = None,
    max_seconds: float = 150.0,
    retry_deadline_s: float = 45.0,
) -> PartitionResult:
    """Partition soak: an in-process raft cluster over real TCP commits a
    pre-cut tranche, then a deterministic network partition isolates the
    leader (or a follower), holds for ``cut_hold_s``, and heals. Every
    client invocation and outcome lands in a :class:`testing.history`
    History; after the drain the checker replays it against the union of
    every member's committed rows — acked-then-lost commits, cross-side
    double spends, lying rejections and ledger advance on the minority
    side all fail the run's ``history_linearizable`` bit.

    ``isolate="leader"`` proves the check-quorum story (a quorumless
    leader must stop answering); ``isolate="follower"`` proves the
    pre-vote story (a cut-off follower must not inflate the term and
    depose the healthy leader at heal) — run it with ``prevote`` on and
    off for the A/B the bench reports."""
    from ..node.config import RaftConfig
    from ..serialization.codec import deserialize
    from ..testing import faults
    from ..testing.history import History, check_history
    from ..flows.notary import (NotaryException, NotaryUnavailable,
                                OverloadedError, WrongShardEpoch)

    if isolate not in ("leader", "follower"):
        raise ValueError(f"isolate: expected leader|follower, got {isolate!r}")
    if plan is None:
        # Held symmetric split: active from the first post-arm frame,
        # lifted only by the timed heal below — the cut window is the
        # harness's wall clock, the cut itself stays event-deterministic.
        plan_obj = faults.FaultPlan(29, [], partitions=[
            faults.PartitionSpec("split")])
        plan_name = "split-hold"
    elif isinstance(plan, faults.FaultPlan):
        plan_obj, plan_name = plan, "custom"
    else:
        p = Path(str(plan))
        if p.suffix == ".toml" or p.exists():
            plan_obj = faults.plan_from_toml(p.read_text(encoding="utf-8"))
        else:
            plan_obj = faults.builtin_plan(str(plan))
        plan_name = str(plan)
    if not plan_obj.partitions:
        raise ValueError("partition soak needs a plan with [[partition]] "
                         "specs (see faults.builtin_plan('split-brain'))")

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-part-"))
    batch = batch or BatchConfig()
    raft_cfg = RaftConfig(prevote=prevote)
    disruptions: list[str] = []
    history = History()
    cluster = tuple(f"Raft{i}" for i in range(cluster_size))
    notaries = [_make_node(base, name, notary="raft-simple",
                           raft_cluster=cluster, verifier=verifier,
                           batch=batch, raft=raft_cfg)
                for name in cluster]
    client = _make_node(base, "PartitionClient", verifier=verifier,
                        batch=batch)
    nodes = notaries + [client]
    try:
        for n in nodes:
            n.refresh_netmap()
        deadline = time.monotonic() + 30.0
        leader = None
        while time.monotonic() < deadline:
            for n in nodes:
                n.run_once(timeout=0.005)
            leader = next((n for n in notaries
                           if n.raft_member.role == "leader"), None)
            if leader is not None:
                break
        if leader is None:
            raise RuntimeError("raft cluster failed to elect")

        target = notaries[0].identity
        stxs = []
        for i in range(n_tx):
            builder = DummyContract.generate_initial(
                client.identity.ref((i % (1 << 30)).to_bytes(4, "big")),
                i, target)
            builder.sign_with(client.key)
            issue_stx = builder.to_signed_transaction()
            client.services.record_transactions([issue_stx])
            prior = issue_stx.tx.out_ref(0)
            move = DummyContract.move(prior, client.identity.owning_key)
            move.sign_with(client.key)
            stxs.append((move.to_signed_transaction(
                check_sufficient_signatures=False), prior))

        t0 = time.perf_counter()
        completions: list[float] = []
        handles: list = []
        cut_at: float | None = None
        healed_at: float | None = None

        def _submit(i: int) -> None:
            stx, prior = stxs[i]
            history.record_invoke(
                "PartitionClient", f"tx{i}", str(stx.id),
                refs=(str(prior.ref),), t=time.perf_counter() - t0,
                during_cut=cut_at is not None and healed_at is None)
            h = client.start_flow(RetryingNotariseFlow(
                stx, retry_deadline_s))
            h.result.add_done_callback(
                lambda _f: completions.append(time.perf_counter() - t0))
            handles.append(h)

        # Phase A: the pre-cut tranche commits against the healthy
        # cluster (proves the baseline, seeds the ledger).
        precut = max(1, min(n_tx, int(round(n_tx * precut_frac))))
        for i in range(precut):
            _submit(i)
        phase_deadline = time.monotonic() + max_seconds / 3
        while time.monotonic() < phase_deadline:
            for n in nodes:
                n.run_once(timeout=0.002)
            if all(h.result.done for h in handles):
                break

        # Arm the cut with the ISOLATED node bound first (auto-sided
        # specs put the first n//2 identities on side a — the minority).
        isolated = leader if isolate == "leader" else next(
            n for n in notaries if n.raft_member.role != "leader")
        ordered = [isolated] + [n for n in notaries if n is not isolated]
        minority = ordered[:max(1, len(ordered) // 2)]
        plan_obj.bind_partition_nodes(
            [n.messaging.my_address for n in ordered])
        faults.arm(plan_obj)
        cut_at = time.perf_counter() - t0
        term_before = max(n.raft_member.term for n in notaries)
        minority_base = sum(
            n.uniqueness_provider.committed_count for n in minority)
        minority_commits = 0
        disruptions.append(
            f"cut armed at {cut_at:.2f}s isolating "
            f"{[n.config.name for n in minority]} ({isolate})")

        # Phase B: the rest of the workload rides through cut + heal.
        for i in range(precut, n_tx):
            _submit(i)
        run_deadline = time.monotonic() + max_seconds
        while time.monotonic() < run_deadline:
            for n in nodes:
                n.run_once(timeout=0.002)
            now = time.perf_counter() - t0
            if healed_at is None:
                # While the cut holds: the minority's ledger must not
                # advance (sampled every pump pass — one COUNT(*) per
                # minority member against a page-cached sqlite).
                minority_commits = max(minority_commits, sum(
                    n.uniqueness_provider.committed_count
                    for n in minority) - minority_base)
                if now >= cut_at + cut_hold_s:
                    faults.heal_partitions()
                    healed_at = now
                    disruptions.append(f"healed at {healed_at:.2f}s")
            elif all(h.result.done for h in handles):
                break
        duration = time.perf_counter() - t0

        committed = rejected = unresolved = 0
        for i, h in enumerate(handles):
            if not h.result.done:
                unresolved += 1
                kind = "timeout"
            elif h.result.exception() is None:
                committed += 1
                kind = "ok"
            else:
                exc = h.result.exception()
                # A retry-deadline exhaustion re-raises the last RETRYABLE
                # error (unavailable/shed/fence) — that decided NOTHING
                # about the tx, so the history records an ambiguous
                # timeout the checker resolves against the ledger. Only a
                # FINAL notary error (conflict, invalid) is a "fail".
                final = (isinstance(exc, NotaryException)
                         and not isinstance(exc.error, (
                             NotaryUnavailable, OverloadedError,
                             WrongShardEpoch)))
                rejected += 1
                kind = "fail" if final else "timeout"
            history.record_outcome("PartitionClient", f"tx{i}", kind,
                                   t=duration)

        recovery = None
        if healed_at is not None:
            after = [t for t in completions if t > healed_at]
            recovery = round(min(after) - healed_at, 3) if after else None

        # Ledger side of the audit: the union of every member's
        # committed rows (ref -> consuming tx), read while members live.
        consumed = []
        committed_tx_ids = set()
        for n in notaries:
            with n.db.lock:
                rows = n.db.conn.execute(
                    "SELECT state_ref, consuming FROM committed_states"
                ).fetchall()
            for ref_blob, consuming in rows:
                tx = deserialize(consuming)
                consumed.append((bytes(ref_blob).hex(), str(tx.id)))
                committed_tx_ids.add(str(tx.id))
        # History refs are str(StateRef) while ledger refs are serialized
        # blobs — the double-spend scan only needs ref keys CONSISTENT
        # across members, which the blob hex is.
        verdict = check_history(history, committed_tx_ids, consumed,
                                minority_commits=minority_commits)

        term_after = max(n.raft_member.term for n in notaries)
        stamps = [n.raft_member.stamp() for n in notaries]
        injected = plan_obj.injected()
        result = PartitionResult(
            plan=plan_name,
            prevote=prevote,
            isolate=isolate,
            cluster_size=cluster_size,
            tx_requested=n_tx,
            tx_committed=committed,
            tx_rejected=rejected,
            tx_unresolved=unresolved,
            duration_s=round(duration, 3),
            cut_at_s=round(cut_at, 3),
            healed_at_s=round(healed_at, 3) if healed_at is not None
            else None,
            recovery_s=recovery,
            term_before=term_before,
            term_after=term_after,
            max_term_inflation=term_after - term_before,
            minority_commits_during_cut=minority_commits,
            elections_won=sum(s["elections_won"] for s in stamps),
            prevotes=sum(s["prevotes"] for s in stamps),
            prevote_rejections=sum(s["prevote_rejections"]
                                   for s in stamps),
            checkquorum_stepdowns=sum(s["checkquorum_stepdowns"]
                                      for s in stamps),
            leader_stepdowns=sum(s["leader_stepdowns"] for s in stamps),
            partition_cuts=injected.get("transport.partition:cut", 0),
            partition_drops=injected.get("transport.partition:drop", 0),
            history_linearizable=verdict["history_linearizable"],
            history_events=verdict["events"],
            lost_acks=len(verdict["lost_acks"]),
            double_spends=len(verdict["double_spends"]),
            fail_conflicts=len(verdict["fail_conflicts"]),
            unresolved_ops=len(verdict["unresolved"]),
            history=verdict,
            disruptions=disruptions,
        )
        return result
    finally:
        faults.disarm()
        for n in nodes:
            try:
                n.stop()
            # lint: allow(no-silent-except) harness teardown: a node that dies mid-stop already produced its result; not a production verify/notarise path
            except Exception:
                pass


@dataclass
class ReshardResult:
    """One live-reshard run: the group count changes MID-LOAD and the
    audit proves nobody noticed except the tail. Windows split the per-tx
    latencies at the plan-publish and handoff-complete marks, so the p99
    blip is measured, not asserted."""

    plan: str | None
    epoch: int
    from_shards: int
    to_shards: int
    direction: str  # "split" | "merge"
    tx_requested: int
    tx_committed: int
    tx_rejected: int
    tx_unresolved: int  # flows that never completed (MUST be 0)
    exactly_once: bool  # committed==requested, ledger rows == expected
    cluster_committed: int
    per_group_committed: list
    reserved_leaked: int | None
    cross_requested: int
    wrong_epoch_bounces: int  # fence bounces served (client retry driver)
    handoff_frames: int       # InstallShardState frames acked
    reshard_started_s: float | None   # plan publish, since t0
    reshard_completed_s: float | None  # every member at the new epoch
    duration_s: float
    tx_per_sec: float
    p50_ms: float
    p99_ms: float
    p99_before_ms: float  # completions before the plan published
    p99_during_ms: float  # completions inside the transition window
    p99_after_ms: float   # completions after every member cut over
    faults_injected: dict = field(default_factory=dict)
    # Post-run fsck gate over every node's store (durability plane);
    # None = gate skipped.
    fsck_clean: bool | None = None

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def run_reshard_loadtest(
    plan="reshard",  # FaultPlan | builtin name | plan TOML path | None
    n_tx: int = 240,
    shards: int = 2,
    to_shards: int = 4,
    cluster_size: int = 1,
    verifier: str = "torch",
    batch: BatchConfig | None = None,
    base_dir: str | None = None,
    max_seconds: float = 240.0,
    rate_tx_s: float = 40.0,
    retry_deadline_s: float = 60.0,
    reserve_ttl_s: float = 15.0,
    cross_frac: float = 0.0,
    reshard_after_frac: float = 0.3,
    epoch: int = 1,
) -> ReshardResult:
    """Live shard split/merge under load (and, by default, under the
    lossy `reshard` chaos plan): boot max(shards, to_shards) Raft groups
    with count=shards (the extra groups are pending split targets), pace
    an open loop of moves through RetryingNotariseFlow, publish the
    reshard plan through the netmap once `reshard_after_frac` of the load
    is submitted, and keep driving while the source leaders seal, stream,
    and cut over. The run audits the same exactly-once contract as the
    chaos harness — every tx committed exactly once, ledger rows across
    groups total exactly the consumed refs, zero leaked reservations —
    plus the reshard-specific story: bounded WrongShardEpoch retries and
    a p99 blip confined to the transition window."""
    from ..testing import faults

    if to_shards != 2 * shards and shards != 2 * to_shards:
        raise ValueError(
            f"reshard must double or halve: {shards} -> {to_shards}")
    direction = "split" if to_shards > shards else "merge"
    plan_obj = None
    if plan is not None:
        if isinstance(plan, faults.FaultPlan):
            plan_obj = plan
        elif isinstance(plan, (str, Path)):
            p = Path(plan)
            if p.suffix == ".toml" or p.exists():
                plan_obj = faults.plan_from_toml(
                    p.read_text(encoding="utf-8"))
            else:
                plan_obj = faults.builtin_plan(str(plan))
        else:
            raise TypeError(f"plan: expected FaultPlan/str/Path, got {plan!r}")

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-reshard-"))
    batch = batch or BatchConfig()
    from ..node.config import ShardConfig
    from ..node.services.sharding import publish_reshard_plan, shard_of

    n_groups = max(shards, to_shards)
    groups = tuple(
        tuple(f"Shard{g}{chr(ord('A') + m)}" for m in range(cluster_size))
        for g in range(n_groups))
    shard_cfg = ShardConfig(count=shards, groups=groups,
                            reserve_ttl_s=reserve_ttl_s)
    notaries: list[Node] = []
    group_nodes: list[list[Node]] = []
    if plan_obj is not None:
        faults.arm(plan_obj)
    try:
        for names in shard_cfg.groups:
            row = [_make_node(
                base, name, notary="raft-simple", raft_cluster=names,
                notary_shards=shard_cfg, verifier=verifier, batch=batch)
                for name in names]
            group_nodes.append(row)
            notaries.extend(row)
        client = _make_node(base, "ReshardClient", verifier=verifier,
                            batch=batch)
        nodes = notaries + [client]
        for n in nodes:
            n.refresh_netmap()
        deadline = time.monotonic() + 20.0 + 10.0 * len(group_nodes)
        while time.monotonic() < deadline:
            for n in nodes:
                n.run_once(timeout=0.005)
            if all(any(n.raft_member.role == "leader" for n in row)
                   for row in group_nodes):
                break
        else:
            raise RuntimeError("raft group(s) failed to elect")

        target = notaries[0].identity
        cross_every = round(1.0 / cross_frac) if cross_frac > 0.0 else 0
        cross_requested = 0
        stxs = []

        def _issue(i: int) -> object:
            builder = DummyContract.generate_initial(
                client.identity.ref((i % (1 << 30)).to_bytes(4, "big")),
                i, target)
            builder.sign_with(client.key)
            issue_stx = builder.to_signed_transaction()
            client.services.record_transactions([issue_stx])
            return issue_stx.tx.out_ref(0)

        for i in range(n_tx):
            priors = [_issue(i)]
            if cross_every and shards > 1 and i % cross_every == 0:
                cross_requested += 1
                for attempt in range(1, 17):
                    p2 = _issue(i + n_tx * attempt)
                    if (shard_of(p2.ref, shards)
                            != shard_of(priors[0].ref, shards)):
                        break
                priors.append(p2)
            move = DummyContract.move(priors, client.identity.owning_key)
            move.sign_with(client.key)
            stxs.append(move.to_signed_transaction(
                check_sufficient_signatures=False))

        t0 = time.perf_counter()
        samples: list[tuple[float, float]] = []  # (completed_at, latency)
        handles = []
        submitted = 0
        started_at: float | None = None
        completed_at: float | None = None
        run_deadline = time.monotonic() + max_seconds
        while time.monotonic() < run_deadline:
            now = time.perf_counter() - t0
            while submitted < n_tx and (
                    rate_tx_s <= 0 or now >= submitted / rate_tx_s):
                sched = submitted / rate_tx_s if rate_tx_s > 0 else 0.0
                h = client.start_flow(RetryingNotariseFlow(
                    stxs[submitted], retry_deadline_s))

                def _done(_f, sched=sched):
                    t = time.perf_counter() - t0
                    samples.append((t, t - sched))

                h.result.add_done_callback(_done)
                handles.append(h)
                submitted += 1
                if rate_tx_s > 0:
                    now = time.perf_counter() - t0
            if started_at is None and submitted >= max(
                    1, int(n_tx * reshard_after_frac)):
                # Doubling (or halving) the group count MID-LOAD: the plan
                # rides the shared netmap; source-group leaders pick it up
                # on their next refresh cadence and start the handoff.
                publish_reshard_plan(base / "netmap.json", epoch,
                                     shards, to_shards,
                                     client.identity.owning_key)
                started_at = time.perf_counter() - t0
            for n in nodes:
                n.run_once(timeout=0.002)
                n.refresh_netmap_maybe(0.25)
            if (started_at is not None and completed_at is None
                    and all(getattr(n.uniqueness_provider, "epoch", 0)
                            >= epoch for n in notaries)):
                completed_at = time.perf_counter() - t0
            if (submitted == n_tx
                    and sum(1 for h in handles if h.result.done) == n_tx
                    and completed_at is not None):
                break
        duration = time.perf_counter() - t0

        committed = rejected = unresolved = 0
        for h in handles:
            if not h.result.done:
                unresolved += 1
            elif h.result.exception() is None:
                committed += 1
            else:
                rejected += 1
        unresolved += n_tx - submitted
        # Ledger-side audit at the NEW topology: activation purged every
        # moved row from its source group, so across groups the rows must
        # total exactly the consumed refs — fewer is a lost commit, more
        # is a double-count that survived the handoff.
        per_group_committed = [
            max((n.uniqueness_provider.committed_count for n in row
                 if getattr(n, "uniqueness_provider", None) is not None),
                default=0)
            for row in group_nodes]
        cluster_committed = sum(per_group_committed)
        expected_rows = n_tx + cross_requested
        reserved_leaked = sum(
            min((n.raft_member.stamp()["reserved_states"]
                 for n in row), default=0)
            for row in group_nodes)
        wrong_epoch = sum(
            n.uniqueness_provider.metrics.get("wrong_epoch", 0)
            for n in notaries
            if hasattr(n.uniqueness_provider, "metrics"))
        frames = sum(
            n.uniqueness_provider.metrics.get("handoff_frames", 0)
            for n in notaries
            if hasattr(n.uniqueness_provider, "metrics"))

        def _p99(window) -> float:
            srt = sorted(window)
            if not srt:
                return 0.0
            return round(1e3 * srt[min(len(srt) - 1,
                                       int(len(srt) * 0.99))], 2)

        lat = [l for _, l in samples] or [0.0]
        srt = sorted(lat)
        before = [l for t, l in samples
                  if started_at is not None and t < started_at]
        during = [l for t, l in samples
                  if started_at is not None and t >= started_at
                  and (completed_at is None or t < completed_at)]
        after = [l for t, l in samples
                 if completed_at is not None and t >= completed_at]
        result = ReshardResult(
            plan=(getattr(plan, "name", None) or str(plan)
                  if not isinstance(plan, faults.FaultPlan) else "custom")
                 if plan is not None else None,
            epoch=epoch,
            from_shards=shards,
            to_shards=to_shards,
            direction=direction,
            tx_requested=n_tx,
            tx_committed=committed,
            tx_rejected=rejected,
            tx_unresolved=unresolved,
            exactly_once=(committed == n_tx and rejected == 0
                          and unresolved == 0
                          and cluster_committed == expected_rows
                          and not reserved_leaked),
            cluster_committed=cluster_committed,
            per_group_committed=per_group_committed,
            reserved_leaked=reserved_leaked,
            cross_requested=cross_requested,
            wrong_epoch_bounces=wrong_epoch,
            handoff_frames=frames,
            reshard_started_s=(round(started_at, 3)
                               if started_at is not None else None),
            reshard_completed_s=(round(completed_at, 3)
                                 if completed_at is not None else None),
            duration_s=round(duration, 3),
            tx_per_sec=round(committed / duration, 1) if duration else 0.0,
            p50_ms=round(1e3 * srt[len(srt) // 2], 2),
            p99_ms=_p99(lat),
            p99_before_ms=_p99(before),
            p99_during_ms=_p99(during),
            p99_after_ms=_p99(after),
            faults_injected=(plan_obj.injected() if plan_obj is not None
                             else faults.injected()),
        )
        for n in nodes:
            n.stop()
        # Post-run fsck gate (durability plane): a reshard soak rewrites
        # whole ledgers across groups — every store must still verify.
        was_armed, faults.ACTIVE = faults.ACTIVE, None
        try:
            from .fsck import fsck_paths

            result.fsck_clean = fsck_paths(base)["clean"]
        finally:
            faults.ACTIVE = was_armed
        return result
    finally:
        if plan_obj is not None:
            faults.disarm()


@dataclass
class MultiProcessResult:
    """Aggregate over C client processes firehosing one notary (cluster)."""

    tx_requested: int
    tx_committed: int
    tx_rejected: int
    width: int
    clients: int
    duration_s: float  # max measured-phase duration across clients
    wall_s: float  # coordinator wall incl. prepare (the conservative bound)
    tx_per_sec: float
    sigs_verified: int  # across every node process, RPC metric deltas
    sigs_per_sec: float  # sigs_verified / duration_s — the north-star rate
    p50_ms: float
    p99_ms: float
    per_client: list = field(default_factory=list)
    disruptions: list = field(default_factory=list)
    # Self-describing stamps: which verifier/backend/device each notary
    # member actually ran (round-4 verdict weak #4 — un-stamped numbers
    # made cross-round comparison a trap). Homogeneous: every value is a
    # per-member dict (ADVICE r5 — scalars mixed into the mapping broke
    # consumers iterating members).
    node_stamps: dict = field(default_factory=dict)
    # How long the coordinator waited for the device-owning member's warm
    # gate before starting traffic (0.0 when no accelerator is assigned).
    device_warm_wait_s: float = 0.0
    trace_file: str | None = None  # merged Chrome/Perfetto JSON (--trace)
    # Server-side stats of the host's verification sidecar
    # (crypto/sidecar.py stats(): batch-size histogram, cross-request
    # coalescing counts, device/host batches); None when the run did not
    # use a sidecar.
    sidecar: dict | None = None
    # Sharded-notary runs (shards > 0): group count, cross-shard tx mix,
    # the per-group ledger audit (committed_states rows count consumed
    # REFS: 1 per single move, 2 per cross move), live reservation rows
    # left after the drain, and the exactly-once verdict over all of it.
    # None/0 when the run is unsharded.
    shards: int = 0
    cross_requested: int = 0
    cross_committed: int = 0
    per_group_committed: list | None = None
    ledger_committed: int | None = None
    ledger_expected: int | None = None
    reserved_leaked: int | None = None
    exactly_once: bool | None = None

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


# A member that ran fewer rounds than this has a stage breakdown made of
# noise (a 2-sample stage winning "busiest" steered a whole sweep's
# first_bottleneck verdict) — below it, attribution abstains. The doctor
# owns the constant (its round_breakdown merge honours the same floor);
# this alias keeps the historical loadtest name importable.
BUSIEST_STAGE_MIN_ROUNDS = _doctor.MIN_ATTRIBUTION_ROUNDS


def _busiest_stage(stage: dict | None) -> str | None:
    """The round stage this member spent the most wall time in, guarded:

    * abstains (None) below BUSIEST_STAGE_MIN_ROUNDS rounds — too few
      samples to mean anything;
    * excludes the "rounds" key, which is an integer COUNT riding in the
      same dict as the float seconds (the unguarded ``max(stage,
      key=stage.get)`` happily crowned it after ~200 rounds);
    * breaks ties deterministically (alphabetically first of the maxima)
      so two equal stages can't flap the sweep verdict between runs.
    * abstains when every timed value is zero — a freshly-deltaed window
      that did no measured work has no busiest stage, and crowning the
      alphabetical first would be a fabricated verdict."""
    stage = stage or {}
    if stage.get("rounds", 0) < BUSIEST_STAGE_MIN_ROUNDS:
        return None
    timed = {k: v for k, v in stage.items() if k != "rounds"}
    if not timed or all((v or 0) <= 0 for v in timed.values()):
        return None
    return max(sorted(timed), key=timed.get)


def _delta_counters(current: dict | None, baseline: dict | None) -> dict:
    """Per-key numeric delta of a cumulative counter dict against a
    baseline snapshot (missing baseline keys count 0; negatives clamp —
    a member restart resets its counters)."""
    current = current or {}
    baseline = baseline or {}
    out = {}
    for k, v in current.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out[k] = max(type(v)(0), v - (baseline.get(k) or 0))
    return out


def _member_stamp(metrics: dict, device: str,
                  baseline: dict | None = None) -> dict:
    """One notary member's self-describing stamp from its node_metrics
    snapshot: verifier/backend/device identity, device-vs-host routing,
    and the async-pipeline numbers (depth + overlap ratio: the fraction
    of verify wall time served on the feeder thread instead of inside
    the round — 0.0/None when the pipeline is off or never engaged).

    ``baseline`` (an earlier node_metrics snapshot, e.g. taken after
    warmup) switches the round attribution fields — busiest_stage and
    round_breakdown — to DELTAS over the measured window. Cumulative
    stamps were the stale-carryover trap: a short measured leg inherited
    warmup + earlier legs' round counters, so attribution named whatever
    the PREVIOUS workload was bound by."""
    av = metrics.get("async_verify") or {}
    stage = metrics.get("round_stage_s") or {}
    if baseline is not None:
        stage = _delta_counters(stage, baseline.get("round_stage_s"))
        breakdown = _tm.format_breakdown(_delta_counters(
            metrics.get("round_phase_s"), baseline.get("round_phase_s")))
    else:
        breakdown = metrics.get("round_breakdown")
    wall = av.get("verify_wall_s", 0.0) or 0.0
    in_loop = stage.get("verify", 0.0) or 0.0
    overlap = (round(wall / (wall + in_loop), 3)
               if (wall + in_loop) > 0 else None)
    raft = metrics.get("raft") or {}
    transport = metrics.get("transport") or {}
    dev_b = metrics.get("verify_device_batches") or 0
    host_b = metrics.get("verify_host_batches") or 0
    return {"verifier": metrics.get("verifier"),
            "kernel_backend": metrics.get("kernel_backend"),
            "device": device,
            "device_batches": metrics.get("verify_device_batches"),
            "host_batches": metrics.get("verify_host_batches"),
            # Fraction of this member's verify batches the device tier
            # actually served (0.0 = everything host-routed — the r05
            # regression shape; None when no batch ran at all).
            "device_occupancy": (round(dev_b / (dev_b + host_b), 3)
                                 if (dev_b + host_b) else None),
            "device_ready": metrics.get("verify_device_ready"),
            "device_min_sigs": metrics.get("verify_device_min_sigs"),
            # The EFFECTIVE size crossover in force at stamp time —
            # AdaptiveCrossover moves it at runtime, and without this the
            # artifact can't explain why traffic routed where it did.
            "effective_min_sigs": metrics.get(
                "verify_effective_min_sigs",
                av.get("effective_min_sigs",
                       metrics.get("verify_device_min_sigs"))),
            "static_min_sigs": metrics.get(
                "verify_static_min_sigs", av.get("static_min_sigs")),
            "adaptive_adjustments": av.get("adaptive_adjustments"),
            # Sidecar CLIENT stamps (node/verify_client.py): batches/sigs
            # shipped to the shared server, fallbacks, gate state; None
            # when this member runs without a sidecar. The client stamp
            # embeds a cached SERVER snapshot ("server") whose mesh fields
            # are hoisted flat here so artifacts grep them per member.
            "sidecar": metrics.get("sidecar"),
            "sidecar_devices": ((metrics.get("sidecar") or {}).get("server")
                                or {}).get("mesh_devices"),
            "sidecar_per_device_occupancy": (
                ((metrics.get("sidecar") or {}).get("server")
                 or {}).get("per_device_occupancy")),
            # Federation ROUTER stamps (crypto/federation.py): per-host
            # routing shares / hedges / degrade counters, hoisted flat so
            # doctor.stamp_attribution's host_imbalance rule (and artifact
            # greps) reach them without digging through the sidecar stamp.
            # None when this member feeds a single sidecar or none.
            "federation": ((metrics.get("sidecar") or {}).get("federation")),
            "async_verify": av or None,
            "pipeline_depth": av.get("depth"),
            "overlap_ratio": overlap,
            # Commit-pipeline stamps (ARCHITECTURE.md "Commit pipeline"):
            # group-commit density, wire RTT, and coalescing ratios, so a
            # latency number can't travel without the replication shape
            # that produced it.
            "raft": raft or None,
            "raft_role": raft.get("role"),
            "entries_per_batch": raft.get("entries_per_batch"),
            "replication_rtt_ms_avg": raft.get("replication_rtt_ms_avg"),
            "reply_coalesce_ratio": raft.get("reply_coalesce_ratio"),
            "transport": transport or None,
            "outbox_burst_avg": transport.get("outbox_burst_avg"),
            "bridge_flush_avg": transport.get("bridge_flush_avg"),
            # Ingest-plane observables: total frames this node enqueued for
            # the wire (frames / firehose tx = frames-per-tx) and the
            # session-send coalescer's burst counters (statemachine._pump).
            "frames_sent_total": transport.get("frames_sent_total"),
            "session_bursts": metrics.get("session_bursts"),
            "session_burst_frames": metrics.get("session_burst_frames"),
            # The round stage this member spent the most wall time in — the
            # first SERVER-side bottleneck a saturating firehose exposes
            # (min-sample guarded + tie-broken, see _busiest_stage).
            "busiest_stage": _busiest_stage(stage),
            # The round profiler's phase attribution (obs/telemetry.py):
            # the block that decomposes a busiest_stage of "rounds"/"pump"
            # into poll/verify_wait/seal/replicate/apply/reply shares —
            # delta-windowed when the caller supplied a baseline.
            "round_breakdown": breakdown,
            # Admission-controller counters (rpc node_metrics "admission")
            # so the doctor's shed-dominated rule has evidence in every
            # stamp, not just slo_sweep's separate qos gather.
            "admission": metrics.get("admission")}


def run_loadtest_multiprocess(
    n_tx: int = 1000,
    width: int = 32,
    clients: int = 2,
    notary: str = "raft",  # simple | validating | raft | raft-validating
    cluster_size: int = 3,
    verifier: str = "torch",  # notary-side provider
    client_verifier: str = "cpu",  # client processes never see the card
    # (the driver's production topology), so they verify on the host tier
    notary_device: str = "accelerator",  # "accelerator": first notary (or
    # the sidecar) owns the card; "cpu": every process on the host tier
    inflight: int = 64,
    rate_tx_s: float = 0.0,  # per client; 0 = closed loop
    max_sigs: int = 4096,
    max_wait_ms: float = 2.0,
    coalesce_ms: float = 10.0,  # round accumulation window (all nodes);
    # measured on the 1-core driver host: raft 60->115 tx/s with p99
    # IMPROVING (fewer fsyncs/ACK frames/AppendEntries per tx)
    disrupt: str | None = None,  # kill-follower | sigstop-follower | None
    disrupt_after_s: float = 2.0,  # wall time (incl. prepare) before firing
    base_dir: str | None = None,
    max_seconds: float = 600.0,
    async_verify: bool = True,  # pipelined verification (all nodes)
    async_depth: int = 2,
    trace: str | None = None,  # write a merged Chrome/Perfetto trace here
    sidecar: bool = False,  # spawn ONE verification sidecar for the host;
    # every raft member feeds it, so micro-batches coalesce ACROSS
    # processes (crypto/sidecar.py) instead of host-routing per process
    sidecar_coalesce_us: int = 2000,
    sidecar_devices: int = 0,  # > 1: the sidecar owns an N-device mesh and
    # shards each coalesced bucket data-parallel across it (ops/sharded.py;
    # a virtual CPU mesh when notary_device == "cpu")
    adaptive_coalesce: bool = False,  # sidecar picks its own coalesce
    # window from observed arrival gaps (crypto/sidecar.py controller;
    # PR 7, off by default — flip per run to A/B against the static window)
    federation_hosts: int = 0,  # > 0: spawn N host-local sidecars as
    # simulated hosts and point every member's FederatedVerifier at the
    # set (crypto/federation.py routes by queue depth + QoS lane, hedges
    # slow hosts, quarantines dead ones). Mutually exclusive with
    # `sidecar` — federation IS the multi-sidecar generalization.
    shards: int = 0,  # > 0: boot `shards` independent raft groups of
    # `cluster_size` members each, partitioned by StateRef hash
    # (node/services/sharding.py); requires a raft-flavoured `notary`
    cross_frac: float = 0.0,  # fraction of txs built to span two shards
    # (the 2PC path); 0 = single-shard-only mix
    reserve_ttl_s: float = 15.0,  # cross-shard reservation TTL
    lane: str = "",  # QoS lane label for every firehose tx ("interactive"
    # or "bulk"); non-empty arms the QoS plane on every node. "" keeps the
    # run bit-identical to the pre-QoS harness.
    slo_ms: float = 50.0,  # interactive SLO (deadline per tx) when a lane
    # is set; ignored otherwise
) -> MultiProcessResult:
    """The reference-shaped harness: every node is a REAL OS process (its own
    GIL, transport sockets, sqlite), the coordinator only starts firehoses
    and gathers results over RPC (LoadTest.kt:39-144's remote-nodes shape;
    round-2 VERDICT: 'client/loadgen, raft members, and the device-feeding
    notary must not share one GIL')."""
    from ..testing.driver import driver

    if federation_hosts and sidecar:
        raise ValueError("federation_hosts and sidecar are mutually "
                         "exclusive (federation IS the multi-sidecar "
                         "generalization)")
    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-mp-"))
    def _extra(v: str | None, sidecar_addr: str = "",
               federation_addrs: str = "") -> str:
        out = ((f'verifier = "{v}"\n' if v is not None else "")
               + f"[batch]\nmax_sigs = {max_sigs}\n"
               f"max_wait_ms = {max_wait_ms}\n"
               f"coalesce_ms = {coalesce_ms}\n"
               f"async_verify = {str(async_verify).lower()}\n"
               f"async_depth = {async_depth}\n")
        if federation_addrs:
            out += f"federation_hosts = {json.dumps(federation_addrs)}\n"
        elif sidecar_addr:
            out += f"sidecar = {json.dumps(sidecar_addr)}\n"
            if sidecar_devices:
                out += f"sidecar_devices = {int(sidecar_devices)}\n"
        if lane:
            out += f"[qos]\nenabled = true\nslo_ms = {float(slo_ms)}\n"
        return out

    disruptions: list[str] = []
    # --trace: arm the span recorder in EVERY node process via the driver's
    # env vector (node.main() calls obs.trace.arm_from_env beside faults).
    trace_env = {"CORDA_TPU_TRACE": "1"} if trace else None
    trace_file = None
    side_stats = None
    with driver(base) as d:
        side = None
        fed_handles = []
        if sidecar:
            # The sidecar — not any member — owns the device: all members
            # ship micro-batches to it and it coalesces across processes.
            side = d.start_sidecar(
                verifier=verifier, device=notary_device,
                coalesce_us=sidecar_coalesce_us, max_sigs=max_sigs,
                devices=sidecar_devices or None,
                adaptive_coalesce=adaptive_coalesce, env_extra=trace_env)
        elif federation_hosts:
            # Federation tier: N host-local sidecars as simulated hosts;
            # every member routes verify buckets across the set.
            fed_handles = d.start_federation(
                count=federation_hosts, verifier=verifier,
                device=notary_device, coalesce_us=sidecar_coalesce_us,
                max_sigs=max_sigs, devices=sidecar_devices or None,
                env_extra=trace_env)
        side_addr = side.address if side is not None else ""
        fed_addrs = ",".join(h.address for h in fed_handles)
        toml_extra = _extra(verifier, side_addr, fed_addrs)
        # Followers stay on the host crypto path even when the leader runs
        # a device verifier: the driver hides the card from them (one card,
        # one owning process). (With a sidecar, followers feed the same
        # server instead.)
        follower_extra = _extra("cpu", side_addr, fed_addrs)
        client_extra = _extra(client_verifier)
        if shards > 0:
            if not notary.startswith("raft"):
                raise ValueError("shards > 0 requires a raft-* notary")
            kind = ("raft-validating" if notary.endswith("validating")
                    else "raft-simple")
            # One raft group per shard; every member carries the same batch
            # config (shard runs are symmetric — there is no single
            # "leader owns the device" member across groups, so only an
            # explicit accelerator assignment pins group 0's first member).
            # The card is visible to that member alone, so each member's
            # verifier follows its placement ("torch" there, "cpu" on the
            # others): the shared config names none.
            on_card = (notary_device == "accelerator"
                       and verifier.startswith("torch"))
            rows = d.start_shard_cluster(
                groups=shards, members=cluster_size, notary=kind,
                reserve_ttl_s=reserve_ttl_s,
                extra_toml=_extra(None, side_addr, fed_addrs),
                cordapps=("corda_tpu_torch.testing.dummies",), rpc=True,
                device_member=(0, 0) if on_card else None,
                env_extra=trace_env)
            members = [m for row in rows for m in row]
        else:
            members = _start_notary_processes(
                d, notary, cluster_size, toml_extra,
                follower_extra=follower_extra, device=notary_device,
                rpc=True, env_extra=trace_env)
        handles = []
        rpcs = []
        for i in range(clients):
            handles.append(d.start_node(
                f"Client{i}", rpc=True,
                cordapps=("corda_tpu_torch.tools.loadgen",),
                extra_toml=client_extra, env_extra=trace_env))
        for h in handles:
            rpcs.append(h.rpc("demo", "s3cret", timeout=60.0))
            d.defer(rpcs[-1].close)
        # Notary-side metrics matter now that the notary process can OWN the
        # accelerator (device policy): its pump verifications are exactly
        # the device-backed work, so sigs_verified sums RPC metric deltas
        # across EVERY node process — clients and notary members alike.
        member_rpcs = []
        for m in members:
            member_rpcs.append(m.rpc("demo", "s3cret", timeout=60.0))
            d.defer(member_rpcs[-1].close)
        device_warm_s = 0.0
        if side is not None and notary_device == "accelerator":
            # Sidecar topology: the device lives in the SIDECAR process
            # (members run the sidecar client, which has no local gate), so
            # readiness polls the server's stats endpoint. The port's
            # sidecar warms its kernels before it listens and reports no
            # device_ready, so this returns at once: the wait measured is
            # what the port does.
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            t_warm = time.perf_counter()
            deadline = time.monotonic() + 420.0
            while time.monotonic() < deadline:
                try:
                    ready = fetch_sidecar_stats(
                        side.address).get("device_ready")
                except SidecarError:
                    ready = False
                if ready or ready is None:
                    break
                time.sleep(1.0)
            device_warm_s = round(time.perf_counter() - t_warm, 1)
        elif notary_device == "accelerator":
            # Production shape: a device-owning notary warms its kernels at
            # boot (node.py _warm_verifier_maybe) and takes traffic only
            # once warm. The port's warm runs in line in start(), before
            # the banner the driver waits for, and leaves no gate to poll
            # (verify_device_ready None), so this loop returns at once; a
            # gate closed by a later degrade is still waited for.
            t_warm = time.perf_counter()
            deadline = time.monotonic() + 420.0
            while time.monotonic() < deadline:
                ready = member_rpcs[0].call(
                    "node_metrics").get("verify_device_ready")
                if ready or ready is None:
                    # None: no warm gate exists in that process (e.g. a
                    # cpu verifier on an accelerator-assigned node) — it
                    # will never flip, so waiting buys nothing.
                    break
                time.sleep(1.0)
            device_warm_s = round(time.perf_counter() - t_warm, 1)
        before = [r.call("node_metrics") for r in rpcs + member_rpcs]
        t_start = time.perf_counter()
        per_client_n = n_tx // clients
        flow_args = (per_client_n, width, inflight, float(rate_tx_s),
                     float(cross_frac))
        if lane:  # unlabelled runs keep the pre-QoS start_flow arg shape
            flow_args += (lane, float(slo_ms))
        flow_handles = [
            r.call("start_flow_dynamic", "loadgen.FirehoseFlow", flow_args)
            for r in rpcs]
        results: list = [None] * clients
        deadline = time.monotonic() + max_seconds
        disrupted = False
        while time.monotonic() < deadline:
            all_done = True
            for i, (r, fh) in enumerate(zip(rpcs, flow_handles)):
                if results[i] is not None:
                    continue
                done, value = r.call("flow_result", fh.run_id)
                if done:
                    results[i] = value
                else:
                    all_done = False
            if all_done:
                break
            if (disrupt and not disrupted
                    and time.perf_counter() - t_start > disrupt_after_s
                    and len(members) > 1):
                disrupted = True
                victim = members[1]  # a follower (leader is usually Raft0,
                # and kill-follower must preserve quorum either way: 2/3 up)
                if disrupt == "kill-follower":
                    victim.kill()
                    disruptions.append(f"SIGKILL {victim.name}")
                    members[1] = d.restart_node(victim)
                    disruptions.append(f"restarted {victim.name} from disk")
                elif disrupt == "sigstop-follower":
                    victim.sigstop()
                    disruptions.append(f"SIGSTOP {victim.name} (hung)")
                    time.sleep(2.0)
                    victim.sigcont()
                    disruptions.append(f"SIGCONT {victim.name}")
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"loadtest did not finish in {max_seconds}s: {results}")
        wall = time.perf_counter() - t_start
        after = []
        for r, b in zip(rpcs + member_rpcs, before):
            try:
                after.append(r.call("node_metrics"))
            except Exception:
                # A killed/restarted member's old RPC connection is gone
                # (and a reborn node's counters reset anyway): count zero
                # delta for it — an honest undercount.
                after.append(b)
        stamps = {}
        for m, a in zip(members, after[len(rpcs):]):
            stamps[m.name] = _member_stamp(a, m.device)
        if side is not None:
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            try:
                side_stats = fetch_sidecar_stats(side.address)
            except SidecarError:
                side_stats = {"error": "sidecar unreachable at gather"}
        elif fed_handles:
            # Per-host server view beside the members' client-side
            # federation stamps (node_stamps[...]["federation"]).
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            servers: dict = {}
            for h in fed_handles:
                try:
                    servers[h.address] = fetch_sidecar_stats(h.address)
                except SidecarError:
                    servers[h.address] = {
                        "error": "host unreachable at gather"}
            side_stats = {"federation_servers": servers}
        if trace:
            trace_file = _write_trace(
                trace, _collect_trace_snapshots(rpcs + member_rpcs))

    sigs = sum(max(0, a["verify_sigs"] - b["verify_sigs"])
               for a, b in zip(after, before))
    duration = max(r.duration_s for r in results)
    committed = sum(r.committed for r in results)
    rejected = sum(r.rejected for r in results)
    total = per_client_n * clients
    cross_req = sum(getattr(r, "cross_requested", 0) for r in results)
    cross_com = sum(getattr(r, "cross_committed", 0) for r in results)
    per_group = ledger_committed = ledger_expected = None
    leaked = once = None
    if shards > 0:
        # Ledger-side exactly-once audit: committed_states rows count
        # consumed input REFS, so N committed moves with cross_com of them
        # two-input must leave exactly N + cross_com rows across all
        # groups — one missing row is a lost spend, one extra is a double
        # commit. A clean drain also leaves zero live reservation rows on
        # every member (min per group: a lagging follower may not have
        # applied the abort yet, the leader's floor is the truth).
        member_after = after[len(rpcs):]
        rows_after = [member_after[g * cluster_size:(g + 1) * cluster_size]
                      for g in range(shards)]
        per_group = [max(((a.get("raft") or {}).get("committed_states")
                          or 0) for a in row) for row in rows_after]
        ledger_committed = sum(per_group)
        ledger_expected = committed + cross_com
        leaked = sum(min(((a.get("raft") or {}).get("reserved_states")
                          or 0) for a in row) for row in rows_after)
        once = (rejected == 0 and committed == total
                and ledger_committed == ledger_expected and not leaked)
    return MultiProcessResult(
        tx_requested=total,
        tx_committed=committed,
        tx_rejected=rejected,
        width=width,
        clients=clients,
        duration_s=round(duration, 3),
        wall_s=round(wall, 3),
        tx_per_sec=round(total / duration, 1) if duration else 0.0,
        sigs_verified=sigs,
        sigs_per_sec=round(sigs / duration, 1) if duration else 0.0,
        p50_ms=max(r.p50_ms for r in results),
        p99_ms=max(r.p99_ms for r in results),
        per_client=[r.__dict__ for r in results],
        disruptions=disruptions,
        node_stamps=stamps,
        device_warm_wait_s=device_warm_s,
        trace_file=trace_file,
        sidecar=side_stats,
        shards=shards,
        cross_requested=cross_req,
        cross_committed=cross_com,
        per_group_committed=per_group,
        ledger_committed=ledger_committed,
        ledger_expected=ledger_expected,
        reserved_leaked=leaked,
        exactly_once=once,
    )


def _start_notary_processes(d, notary: str, cluster_size: int,
                            extra_toml: str, follower_extra: str | None = None,
                            device: str = "cpu", rpc: bool = False,
                            env_extra: dict | None = None) -> list:
    """Spawn the notary process(es) for a driver run; returns the members.
    For a raft cluster, member 0 gets extra_toml + device (the leader-owns-
    the-device topology: deterministic timeouts make the first member win
    the initial election) and the rest get follower_extra (defaults to
    extra_toml) on the cpu; an election flip degrades to host crypto
    rather than fighting over one chip."""
    if notary.startswith("raft"):
        kind = ("raft-validating" if notary.endswith("validating")
                else "raft-simple")
        cluster = tuple(f"Raft{i}" for i in range(cluster_size))
        return [d.start_node(
            name, notary=kind, raft_cluster=cluster,
            cordapps=("corda_tpu_torch.testing.dummies",), rpc=rpc,
            extra_toml=extra_toml if i == 0 else (follower_extra
                                                  or extra_toml),
            device=device if i == 0 else "cpu", env_extra=env_extra)
            for i, name in enumerate(cluster)]
    return [d.start_node(
        "Notary", notary=notary, cordapps=("corda_tpu_torch.testing.dummies",),
        rpc=rpc, extra_toml=extra_toml, device=device, env_extra=env_extra)]


@dataclass
class SweepResult:
    """{rate: FirehoseResult} plus per-member node stamps. Mapping-style
    access (sweep[rate], .items(), iteration) delegates to the rate
    results so existing sweep consumers keep working unchanged."""

    results: dict
    node_stamps: dict = field(default_factory=dict)
    # Per-node span snapshots (trace_snapshot RPC shape) when the sweep ran
    # with tracing armed — bench.py feeds these to obs.collect.
    trace_snapshots: list = field(default_factory=list)
    # Server-side verification-sidecar stats for the whole sweep
    # (crypto/sidecar.py stats()); None when the sweep ran without one.
    sidecar: dict | None = None
    # Per-member QoS plane + admission-controller stats (rpc node_metrics
    # "qos"/"admission") when the sweep ran with the plane armed.
    qos: dict | None = None
    # Cluster telemetry fold (obs/export.collect_cluster over per-member
    # telemetry_snapshot RPCs): per-node registries + the merged view.
    telemetry: dict | None = None
    # Flight-recorder artifact paths the sweep produced (slo_sweep with
    # flight_dir set: the latched slo_breach dump); None when unarmed.
    flight: list | None = None
    # The performance doctor's evidence-ranked attribution over the
    # member stamps (obs/doctor.stamp_attribution): ranked bottlenecks
    # with per-entry evidence + next experiment. This — not the legacy
    # Counter-majority over busiest_stage — is where first_bottleneck
    # comes from; None when the sweep gathered no stamps.
    doctor: dict | None = None

    @property
    def first_bottleneck(self):
        """Top of the doctor's ranked bottleneck list; honest None when
        no member produced enough evidence (the <MIN_ATTRIBUTION_ROUNDS
        abstention contract survives end-to-end)."""
        return (self.doctor or {}).get("first_bottleneck")

    def __getitem__(self, rate):
        return self.results[rate]

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)

    def __contains__(self, rate):
        return rate in self.results

    def items(self):
        return self.results.items()

    def keys(self):
        return self.results.keys()

    def values(self):
        return self.results.values()


def _merge_firehose(values: list):
    """Fold per-client FirehoseResults for ONE offered rate into a single
    summary: counts/signatures/throughput sum, the measured phase is the
    slowest client's, and each percentile takes the worst client (an upper
    bound — exact merged percentiles would need the raw latency lists,
    which stay in the client processes by design)."""
    from .loadgen import FirehoseResult

    return FirehoseResult(
        requested=sum(v.requested for v in values),
        committed=sum(v.committed for v in values),
        rejected=sum(v.rejected for v in values),
        duration_s=max(v.duration_s for v in values),
        tx_per_sec=round(sum(v.tx_per_sec for v in values), 1),
        p50_ms=max(v.p50_ms for v in values),
        p90_ms=max(v.p90_ms for v in values),
        p99_ms=max(v.p99_ms for v in values),
        width=values[0].width,
        sigs_signed=sum(v.sigs_signed for v in values),
        cross_requested=sum(getattr(v, "cross_requested", 0)
                            for v in values),
        cross_committed=sum(getattr(v, "cross_committed", 0)
                            for v in values),
        lane=getattr(values[0], "lane", ""),
        shed=sum(getattr(v, "shed", 0) for v in values),
        # Ingest attribution: throughput rates sum across clients (they
        # prepared concurrently in separate processes); prepare wall is the
        # slowest client's; CPU is the honest total burned.
        tx_built_per_s=round(sum(getattr(v, "tx_built_per_s", 0.0)
                                 for v in values), 1),
        sigs_signed_per_s=round(sum(getattr(v, "sigs_signed_per_s", 0.0)
                                    for v in values), 1),
        serialize_ms=round(sum(getattr(v, "serialize_ms", 0.0)
                               for v in values), 3),
        prepare_s=round(max(getattr(v, "prepare_s", 0.0)
                            for v in values), 4),
        cpu_s=round(sum(getattr(v, "cpu_s", 0.0) for v in values), 4),
    )


def run_latency_sweep(
    # Raised for round 15: columnar prepare (one native batch sign per
    # chunk) moved the per-client ceiling off build/sign, so the stale
    # (30, 90, 150) ladder never left the comfortable region — the top
    # rung must sit ABOVE single-process capacity for the sweep to show
    # a knee.
    rates: tuple[float, ...] = (60.0, 240.0, 720.0),
    n_tx: int = 250,
    width: int = 4,
    clients: int = 1,  # client processes splitting each offered rate;
    # one client process's measured phase saturates near a few hundred
    # tx/s of submissions, so rates above that need the load SPREAD (each
    # paces at rate/clients) or the sweep measures the generator, not the
    # notary — or use run_ingest_sweep, whose replay workers skip
    # build/sign entirely
    notary: str = "simple",  # simple | validating | raft | raft-validating
    cluster_size: int = 3,
    verifier: str = "torch",  # notary member 0's provider (followers: cpu)
    notary_device: str = "accelerator",  # "accelerator": first notary (or
    # the sidecar) owns the card; "cpu": every process on the host tier
    max_sigs: int = 4096,
    max_wait_ms: float = 2.0,
    # 0 preserves the pre-r5 sweep behaviour so the simple-notary trend
    # line keeps its meaning; the raft sweep passes the production 10 ms.
    coalesce_ms: float = 0.0,
    base_dir: str | None = None,
    max_seconds: float = 300.0,
    async_verify: bool = True,
    async_depth: int = 2,
    trace: "str | bool | None" = None,  # True: collect span snapshots onto
    # the SweepResult; a path additionally writes the merged Chrome trace
    sidecar: bool = False,  # one host-wide verification sidecar; members
    # feed it so batches coalesce across processes (crypto/sidecar.py)
    sidecar_coalesce_us: int = 2000,
    sidecar_devices: int = 0,  # > 1: the sidecar owns an N-device mesh
) -> SweepResult:
    """Open-loop tail-latency measurement: a notary (or raft cluster) +
    `clients` client processes, the firehose driven at each offered load in
    `rates` sequentially (rate_tx_s pacing: flows start on schedule
    regardless of completions; with clients > 1 the rate is split evenly so
    offered loads beyond one generator's GIL ceiling stay honest). Per-tx latency is measured from scheduled submission, so
    queueing at offered loads near capacity shows up as a p99 ≫ p50 tail —
    the number the closed-loop start-all-then-pump shape structurally cannot
    produce (round-3 VERDICT item 3). notary="raft" sweeps the flagship
    BASELINE config-1 cluster through real OS processes (round-4 VERDICT
    item 4: the flagship config's p99 was only ever measured closed-loop).
    Returns a SweepResult: {rate: FirehoseResult} plus node_stamps
    attributing each member's routing (device_batches, pipeline depth,
    overlap ratio) for the whole sweep."""
    from ..testing.driver import driver

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-lat-"))
    def _extra(v: str, sidecar_addr: str = "") -> str:
        out = (f'verifier = "{v}"\n'
               f"[batch]\nmax_sigs = {max_sigs}\n"
               f"max_wait_ms = {max_wait_ms}\n"
               f"coalesce_ms = {coalesce_ms}\n"
               f"async_verify = {str(async_verify).lower()}\n"
               f"async_depth = {async_depth}\n")
        if sidecar_addr:
            out += f"sidecar = {json.dumps(sidecar_addr)}\n"
            if sidecar_devices:
                out += f"sidecar_devices = {int(sidecar_devices)}\n"
        return out

    results: dict = {}
    stamps: dict = {}
    snapshots: list = []
    side_stats = None
    trace_env = {"CORDA_TPU_TRACE": "1"} if trace else None
    with driver(base) as d:
        side = None
        if sidecar:
            side = d.start_sidecar(
                verifier=verifier, device=notary_device,
                coalesce_us=sidecar_coalesce_us, max_sigs=max_sigs,
                devices=sidecar_devices or None, env_extra=trace_env)
        side_addr = side.address if side is not None else ""
        toml_extra = _extra(verifier, side_addr)
        members = _start_notary_processes(
            d, notary, cluster_size, toml_extra,
            follower_extra=_extra("cpu", side_addr), device=notary_device,
            rpc=True, env_extra=trace_env)
        member_rpcs = []
        for m in members:
            member_rpcs.append(m.rpc("demo", "s3cret", timeout=60.0))
            d.defer(member_rpcs[-1].close)
        if side is not None and notary_device == "accelerator":
            # The device lives in the sidecar process (see the
            # multiprocess harness): poll the server's stats endpoint.
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            deadline = time.monotonic() + 420.0
            while time.monotonic() < deadline:
                try:
                    ready = fetch_sidecar_stats(
                        side.address).get("device_ready")
                except SidecarError:
                    ready = False
                if ready or ready is None:
                    break
                time.sleep(1.0)
        elif notary_device == "accelerator":
            # Same policy as the multiprocess harness: take traffic only
            # once the device-owning member's gate (if any) is open.
            deadline = time.monotonic() + 420.0
            while time.monotonic() < deadline:
                ready = member_rpcs[0].call(
                    "node_metrics").get("verify_device_ready")
                if ready or ready is None:
                    break
                time.sleep(1.0)
        clients = max(1, clients)
        client_rpcs = []
        for i in range(clients):
            handle = d.start_node(f"Client{i}", rpc=True,
                                  cordapps=("corda_tpu_torch.tools.loadgen",),
                                  extra_toml=_extra("cpu"),
                                  env_extra=trace_env)
            client_rpcs.append(handle.rpc("demo", "s3cret", timeout=60.0))
            d.defer(client_rpcs[-1].close)
        rpc = client_rpcs[0]
        # Warm-up: a tiny closed-loop burst per client drives session
        # establishment, netmap propagation and first-contact code paths
        # OUTSIDE the measured rates — a cold-start redelivery backoff
        # would otherwise show up as a multi-second p99 artifact in the
        # first rate.
        warms = [r.call("start_flow_dynamic", "loadgen.FirehoseFlow",
                        (5, width, 5, 0.0)) for r in client_rpcs]
        deadline = time.monotonic() + max_seconds
        pending = list(zip(client_rpcs, warms))
        while pending and time.monotonic() < deadline:
            pending = [(r, w) for r, w in pending
                       if not r.call("flow_result", w.run_id)[0]]
            time.sleep(0.1)
        if pending:
            raise TimeoutError("latency-sweep warmup did not finish")
        for rate in rates:
            # Each client paces at rate/clients with its share of n_tx:
            # the notary sees the full offered load, no single generator
            # process has to sustain more than its GIL can schedule.
            per_n = max(1, n_tx // clients)
            fhs = [r.call("start_flow_dynamic", "loadgen.FirehoseFlow",
                          (per_n, width, 1 << 30, float(rate) / clients))
                   for r in client_rpcs]
            values: list = [None] * clients
            deadline = time.monotonic() + max_seconds
            while time.monotonic() < deadline:
                for i, (r, fh) in enumerate(zip(client_rpcs, fhs)):
                    if values[i] is None:
                        done, value = r.call("flow_result", fh.run_id)
                        if done:
                            values[i] = value
                if all(v is not None for v in values):
                    break
                time.sleep(0.25)
            else:
                raise TimeoutError(
                    f"open-loop sweep at {rate} tx/s did not finish "
                    f"in {max_seconds}s")
            results[rate] = (values[0] if clients == 1
                             else _merge_firehose(values))
        for m, r in zip(members, member_rpcs):
            try:
                stamps[m.name] = _member_stamp(
                    r.call("node_metrics"), m.device)
            # lint: allow(no-silent-except) sweep tooling: a dead member costs its stamp, not the whole sweep; not a production verify/notarise path
            except Exception:
                pass  # a dead member costs its stamp, not the sweep
        if side is not None:
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            try:
                side_stats = fetch_sidecar_stats(side.address)
            except SidecarError:
                side_stats = {"error": "sidecar unreachable at gather"}
        if trace:
            snapshots = _collect_trace_snapshots(member_rpcs + client_rpcs)
            if isinstance(trace, str):
                _write_trace(trace, snapshots)
    return SweepResult(results=results, node_stamps=stamps,
                       trace_snapshots=snapshots, sidecar=side_stats,
                       doctor=_doctor.stamp_attribution(stamps))


def run_slo_sweep(
    # Raised for round 15 (vectorized ingest): with columnar prepare the
    # generators pace well past the old 240 top rung, so the default
    # ladder now reaches into overload — calibrate_admission re-derives
    # its knobs (and provenance) from whatever ladder actually ran.
    rates: tuple[float, ...] = (120.0, 240.0, 480.0),
    n_tx: int = 240,
    width: int = 4,
    clients: int = 2,
    interactive_frac: float = 0.25,  # share of each offered load (and of
    # n_tx) labelled interactive; the rest runs on the bulk lane
    slo_ms: float = 50.0,  # the explicit SLO: interactive deadline per tx
    bulk_rate: float = 0.0,  # bulk admission bucket (tx/s; 0 = unlimited,
    # the watermark alone does the shedding)
    queue_watermark: int = 48,  # runnable-backlog depth above which the
    # notary sheds BULK (interactive is never watermark-shed)
    notary: str = "simple",  # simple | validating | raft | raft-validating
    cluster_size: int = 3,
    verifier: str = "torch",
    notary_device: str = "accelerator",
    max_sigs: int = 4096,
    max_wait_ms: float = 2.0,
    coalesce_ms: float = 0.0,
    base_dir: str | None = None,
    max_seconds: float = 300.0,
    async_verify: bool = True,
    async_depth: int = 2,
    sidecar: bool = False,
    sidecar_coalesce_us: int = 2000,
    sidecar_devices: int = 0,
    qos: bool = True,  # False: the SAME mixed-lane offered load through an
    # unarmed plane — the no-QoS baseline the SLO verdict compares against
    flight_dir: str | None = None,  # arm the driver-side flight recorder:
    # the first rate whose merged interactive p99 breaches slo_ms dumps
    # ONE artifact (breaching window's per-rate metric deltas + member
    # spans) into this directory
) -> SweepResult:
    """Mixed-lane open-loop sweep for the explicit p99 SLO verdict: at each
    offered load, every client process drives TWO concurrent firehoses —
    one interactive (lane-labelled, deadline = slo_ms) at
    ``rate * interactive_frac`` and one bulk at the remainder — so the
    notary sees a contended mix, not a single-class stream. Per-lane
    FirehoseResults (p50/p99, committed, shed) are merged across clients;
    results[rate] is ``{"interactive": FirehoseResult, "bulk": ...}``.

    With ``qos=True`` every node arms the plane ([qos] in its TOML): lanes
    reorder the runnable queue, deadlines early-flush the three batching
    points, and the notary's admission controller watermark-sheds bulk —
    the claim under test is that interactive p99 stays inside slo_ms while
    bulk absorbs the overload as sheds. With ``qos=False`` the same load
    runs bit-identical to the pre-QoS tree and both lanes collapse
    together — the baseline."""
    from ..obs import telemetry as _tm
    from ..testing.driver import driver

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-slo-"))
    recorder = None
    member_env = None
    if flight_dir:
        # Driver-side recorder: the sweep loop ticks it with per-rate lane
        # summaries, so the breach artifact's window reads as "how the
        # ladder climbed into the breach". Members get tracing armed so
        # the artifact carries their spans; they do NOT get their own
        # flight dir (exactly-one-artifact is the sweep's contract, and a
        # member overload dump would race it).
        recorder = _tm.FlightRecorder(str(flight_dir), node="slo-driver")
        member_env = {"CORDA_TPU_TRACE": "1"}

    def _extra(v: str, sidecar_addr: str = "") -> str:
        out = (f'verifier = "{v}"\n'
               f"[batch]\nmax_sigs = {max_sigs}\n"
               f"max_wait_ms = {max_wait_ms}\n"
               f"coalesce_ms = {coalesce_ms}\n"
               f"async_verify = {str(async_verify).lower()}\n"
               f"async_depth = {async_depth}\n")
        if sidecar_addr:
            out += f"sidecar = {json.dumps(sidecar_addr)}\n"
            if sidecar_devices:
                out += f"sidecar_devices = {int(sidecar_devices)}\n"
        if qos:
            # Arms the plane in EVERY node process: clients stamp lane
            # contexts onto generated txs, members schedule/shed by them.
            out += (f"[qos]\nenabled = true\n"
                    f"slo_ms = {float(slo_ms)}\n"
                    f"bulk_rate = {float(bulk_rate)}\n"
                    f"queue_watermark = {int(queue_watermark)}\n")
        return out

    results: dict = {}
    stamps: dict = {}
    qstats: dict = {}
    tsnaps: dict = {}
    side_stats = None
    lanes = (("interactive", float(interactive_frac), float(slo_ms)),
             ("bulk", 1.0 - float(interactive_frac), 0.0))
    with driver(base) as d:
        side = None
        if sidecar:
            side = d.start_sidecar(
                verifier=verifier, device=notary_device,
                coalesce_us=sidecar_coalesce_us, max_sigs=max_sigs,
                devices=sidecar_devices or None)
        side_addr = side.address if side is not None else ""
        members = _start_notary_processes(
            d, notary, cluster_size, _extra(verifier, side_addr),
            follower_extra=_extra("cpu", side_addr), device=notary_device,
            rpc=True, env_extra=member_env)
        member_rpcs = []
        for m in members:
            member_rpcs.append(m.rpc("demo", "s3cret", timeout=60.0))
            d.defer(member_rpcs[-1].close)
        clients = max(1, clients)
        client_rpcs = []
        for i in range(clients):
            handle = d.start_node(f"Client{i}", rpc=True,
                                  cordapps=("corda_tpu_torch.tools.loadgen",),
                                  extra_toml=_extra("cpu"))
            client_rpcs.append(handle.rpc("demo", "s3cret", timeout=60.0))
            d.defer(client_rpcs[-1].close)
        # Same warm-up as the latency sweep: session establishment and
        # first-contact paths run OUTSIDE the measured rates.
        warms = [r.call("start_flow_dynamic", "loadgen.FirehoseFlow",
                        (5, width, 5, 0.0)) for r in client_rpcs]
        deadline = time.monotonic() + max_seconds
        pending = list(zip(client_rpcs, warms))
        while pending and time.monotonic() < deadline:
            pending = [(r, w) for r, w in pending
                       if not r.call("flow_result", w.run_id)[0]]
            time.sleep(0.1)
        if pending:
            raise TimeoutError("SLO-sweep warmup did not finish")
        for rate in rates:
            # Two firehoses per client — the lanes CONTEND inside each
            # client process and at the notary, which is the point.
            fhs = []
            for lane, frac, lane_slo in lanes:
                ln = max(1, int(round(n_tx * frac)) // clients)
                lane_rate = float(rate) * frac / clients
                for r in client_rpcs:
                    fhs.append((r, r.call(
                        "start_flow_dynamic", "loadgen.FirehoseFlow",
                        (ln, width, 1 << 30, lane_rate, 0.0,
                         lane, lane_slo)), lane))
            values: list = [None] * len(fhs)
            deadline = time.monotonic() + max_seconds
            while time.monotonic() < deadline:
                for i, (r, fh, _) in enumerate(fhs):
                    if values[i] is None:
                        done, value = r.call("flow_result", fh.run_id)
                        if done:
                            values[i] = value
                if all(v is not None for v in values):
                    break
                time.sleep(0.25)
            else:
                raise TimeoutError(
                    f"SLO sweep at {rate} tx/s did not finish "
                    f"in {max_seconds}s")
            by_lane: dict = {}
            for (_, _, lane), v in zip(fhs, values):
                by_lane.setdefault(lane, []).append(v)
            results[rate] = {lane: _merge_firehose(vs)
                             for lane, vs in by_lane.items()}
            if recorder is not None:
                sample: dict = {"rate_tx_s": float(rate)}
                for lane, fr in results[rate].items():
                    sample[f"{lane}_p99_ms"] = fr.p99_ms
                    sample[f"{lane}_tx_per_sec"] = fr.tx_per_sec
                    sample[f"{lane}_committed"] = fr.committed
                    sample[f"{lane}_shed"] = fr.shed
                recorder.tick(sample)
                inter = results[rate].get("interactive")
                if inter is not None and inter.p99_ms > slo_ms:
                    # SLO breach: dump once (the recorder latches on the
                    # reason, so later breaching rungs add nothing) with
                    # the breaching window's deltas, the members' span
                    # buffers, and their telemetry counters AT the breach.
                    spans: list = []
                    counters: dict = {}
                    routing: dict = {}
                    for m, r in zip(members, member_rpcs):
                        try:
                            spans.extend(
                                r.call("trace_snapshot").get("spans") or [])
                            counters[m.name] = (
                                (r.call("telemetry_snapshot").get("snapshot")
                                 or {}).get("counters"))
                            # Federation routing state AT the breach:
                            # per-host shares + the recent-decisions ring
                            # (which host each batch went to and why), so
                            # a breach on the federated plane is
                            # attributable to a routing choice, not just
                            # a latency number. Absent when the member
                            # feeds a single sidecar or none.
                            fed = ((r.call("node_metrics").get("sidecar")
                                    or {}).get("federation"))
                            if fed:
                                routing[m.name] = fed
                        # lint: allow(no-silent-except) sweep tooling: a dead member costs its breach evidence, not the sweep; not a production verify/notarise path
                        except Exception:
                            pass
                    recorder.trigger("slo_breach", extra={
                        "rate_tx_s": float(rate), "slo_ms": float(slo_ms),
                        "interactive_p99_ms": inter.p99_ms,
                        "member_counters": counters,
                        "federation_routing": routing or None}, spans=spans)
        for m, r in zip(members, member_rpcs):
            try:
                metrics = r.call("node_metrics")
                stamps[m.name] = _member_stamp(metrics, m.device)
                qstats[m.name] = {"qos": metrics.get("qos"),
                                  "admission": metrics.get("admission")}
                tsnaps[m.name] = r.call(
                    "telemetry_snapshot").get("snapshot")
            # lint: allow(no-silent-except) sweep tooling: a dead member costs its stamp, not the whole sweep; not a production verify/notarise path
            except Exception:
                pass  # a dead member costs its stamp, not the sweep
        if side is not None:
            from ..node.verify_client import SidecarError, fetch_sidecar_stats

            try:
                side_stats = fetch_sidecar_stats(side.address)
            except SidecarError:
                side_stats = {"error": "sidecar unreachable at gather"}
    from ..obs.export import collect_cluster

    return SweepResult(results=results, node_stamps=stamps,
                       sidecar=side_stats, qos=qstats or None,
                       telemetry=collect_cluster(tsnaps) if tsnaps else None,
                       flight=(sorted(recorder.dumped.values())
                               if recorder is not None else None),
                       doctor=_doctor.stamp_attribution(stamps))


_LOSSY_PLAN_TOML = """\
seed = 7
[[rule]]
point = "transport.send"
action = "drop"
p = 0.05
max_fires = 500
"""


def run_ingest_sweep(
    rates: tuple[float, ...] = (1200.0, 3600.0, 10000.0),
    n_tx: int = 2000,
    width: int = 1,
    workers: int = 3,  # replay worker processes splitting each offered rate
    notary: str = "simple",  # simple | raft (validating kinds rejected:
    # replay workers hold no issue provenance — uniqueness does not need
    # the back chain, validation would)
    cluster_size: int = 3,
    cross_frac: float = 0.0,
    verifier: str = "torch",
    max_sigs: int = 4096,
    max_wait_ms: float = 2.0,
    coalesce_ms: float = 10.0,
    chaos: str | None = None,  # "lossy" or a fault-plan TOML path: armed
    # (via CORDA_TPU_FAULT_PLAN) in member + worker processes, NOT the
    # builder — the corpus build stays deterministic, delivery does not
    base_dir: str | None = None,
    max_seconds: float = 600.0,
    async_verify: bool = True,
    async_depth: int = 2,
    pipeline: bool = True,  # commit-plane round pipelining ([raft]
    # pipeline): False runs the serial reference path for before/after
    # committed-tx/s deltas (bench.bench_ingest_sweep stamps both)
) -> SweepResult:
    """The multiprocess ingest firehose: ONE builder process constructs,
    batch-signs and serializes the whole corpus (loadgen.IngestBuildFlow →
    a CTI1 multi-tx frame on disk), then `workers` replay processes each
    drive a DISJOINT slice of that frame open-loop at rate/workers — no
    worker ever rebuilds or re-signs a transaction, so the offered rate
    scales with worker count instead of one process's build+sign ceiling.

    Each rate gets a FRESH corpus (reusing one would double-spend its
    inputs) and is isolated: a failed rate records {"error": ...} in
    results[rate] and the sweep continues. results[rate] is otherwise a
    flat dict: offered/achieved tx/s, commit counts, latency percentiles,
    frames-per-tx (worker transport deltas), the builder's ingest
    attribution block, and the exactly-once audit verdict."""
    from ..testing.driver import driver

    if "validating" in notary:
        raise ValueError(
            "ingest sweep requires a non-validating notary: replay "
            "workers carry no issue provenance")
    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-ingest-"))

    def _extra(v: str) -> str:
        return (f'verifier = "{v}"\n'
                f"[batch]\nmax_sigs = {max_sigs}\n"
                f"max_wait_ms = {max_wait_ms}\n"
                f"coalesce_ms = {coalesce_ms}\n"
                f"async_verify = {str(async_verify).lower()}\n"
                f"async_depth = {async_depth}\n"
                f"[raft]\npipeline = {str(pipeline).lower()}\n")

    chaos_env = None
    if chaos:
        plan = Path(chaos)
        if plan.suffix == ".toml" or plan.exists():
            plan_path = str(plan)
        elif chaos == "lossy":
            plan_path = str(base / "fault-plan.toml")
            base.mkdir(parents=True, exist_ok=True)
            Path(plan_path).write_text(_LOSSY_PLAN_TOML, encoding="utf-8")
        else:
            raise ValueError(f"chaos: expected 'lossy' or a TOML path, "
                             f"got {chaos!r}")
        chaos_env = {"CORDA_TPU_FAULT_PLAN": plan_path}

    results: dict = {}
    stamps: dict = {}
    with driver(base) as d:
        # Member 0 runs `verifier`; a "torch" kind needs the card visible.
        members = _start_notary_processes(
            d, notary, cluster_size, _extra(verifier),
            follower_extra=_extra("cpu"), rpc=True, env_extra=chaos_env,
            device=("accelerator" if verifier.startswith("torch")
                    else "cpu"))
        member_rpcs = []
        for m in members:
            member_rpcs.append(m.rpc("demo", "s3cret", timeout=60.0))
            d.defer(member_rpcs[-1].close)
        builder = d.start_node("Ingest0", rpc=True,
                               cordapps=("corda_tpu_torch.tools.loadgen",),
                               extra_toml=_extra("cpu"))
        builder_rpc = builder.rpc("demo", "s3cret", timeout=60.0)
        d.defer(builder_rpc.close)
        workers = max(1, workers)
        worker_rpcs = []
        for i in range(workers):
            h = d.start_node(f"Worker{i}", rpc=True,
                             cordapps=("corda_tpu_torch.tools.loadgen",),
                             extra_toml=_extra("cpu"), env_extra=chaos_env)
            worker_rpcs.append(h.rpc("demo", "s3cret", timeout=60.0))
            d.defer(worker_rpcs[-1].close)

        def _await(jobs, what):
            """jobs: [(rpc, flow_handle)] -> values, bounded wait."""
            values: list = [None] * len(jobs)
            deadline = time.monotonic() + max_seconds
            while time.monotonic() < deadline:
                for i, (r, fh) in enumerate(jobs):
                    if values[i] is None:
                        done, value = r.call("flow_result", fh.run_id)
                        if done:
                            values[i] = value
                if all(v is not None for v in values):
                    return values
                time.sleep(0.1)
            raise TimeoutError(f"{what} did not finish in {max_seconds}s")

        # Warm-up: session establishment / netmap / first-contact paths
        # run OUTSIDE the measured rates (same policy as the sweeps).
        _await([(r, r.call("start_flow_dynamic", "loadgen.FirehoseFlow",
                           (3, 1, 3, 0.0))) for r in worker_rpcs],
               "ingest-sweep warmup")
        # Post-warmup baseline snapshots: the end-of-sweep member stamps
        # delta against these, so busiest_stage / round_breakdown describe
        # the MEASURED legs — cumulative stamps carried warmup and earlier
        # rate legs into the verdict (the stale-"rounds" trap: a short
        # pipelined run inherited the previous workload's attribution).
        baselines: dict = {}
        for m, r in zip(members, member_rpcs):
            try:
                baselines[m.name] = r.call("node_metrics")
            # lint: allow(no-silent-except) sweep tooling: losing a baseline degrades one stamp to cumulative, not the sweep
            except Exception:
                pass
        for rate in rates:
            try:
                corpus_path = str(base / f"corpus-{rate:g}.bin")
                bh = builder_rpc.call(
                    "start_flow_dynamic", "loadgen.IngestBuildFlow",
                    (corpus_path, n_tx, width, float(cross_frac)))
                build = _await([(builder_rpc, bh)], f"corpus build@{rate}")[0]
                t_before = [r.call("node_metrics").get("transport") or {}
                            for r in worker_rpcs]
                per_n = max(1, n_tx // workers)
                jobs = [(r, r.call(
                    "start_flow_dynamic", "loadgen.FirehoseReplayFlow",
                    (corpus_path, i * per_n, per_n, 1 << 30,
                     float(rate) / workers)))
                    for i, r in enumerate(worker_rpcs)]
                values = _await(jobs, f"ingest replay@{rate}")
                t_after = [r.call("node_metrics").get("transport") or {}
                           for r in worker_rpcs]
                merged = _merge_firehose(values)
                frames = sum(
                    (a.get("frames_sent_total") or 0)
                    - (b.get("frames_sent_total") or 0)
                    for a, b in zip(t_after, t_before))
                results[rate] = {
                    "offered_tx_s": float(rate),
                    "achieved_tx_s": merged.tx_per_sec,
                    "requested": merged.requested,
                    "committed": merged.committed,
                    "rejected": merged.rejected,
                    "duration_s": merged.duration_s,
                    "p50_ms": merged.p50_ms,
                    "p99_ms": merged.p99_ms,
                    "workers": workers,
                    "frames_per_tx": (round(frames / merged.requested, 3)
                                      if merged.requested else None),
                    # No tx lost, none double-counted: every requested tx
                    # resolved exactly once as commit or loud reject.
                    "exactly_once": (merged.committed + merged.rejected
                                     == merged.requested),
                    "ingest": {
                        "tx_built_per_s": build.tx_built_per_s,
                        "sigs_signed_per_s": build.sigs_signed_per_s,
                        "serialize_ms": build.serialize_ms,
                        "prepare_s": build.prepare_s,
                        "bytes_written": build.bytes_written,
                        "sigs_signed": build.sigs_signed,
                        # Client-plane CPU attribution: builder prepare +
                        # worker load/drive CPU, all processes.
                        "cpu_s": round(build.cpu_s + merged.cpu_s, 4),
                        "load_prepare_s": merged.prepare_s,
                    },
                }
            except Exception as e:
                # Per-sub-run isolation: one rate failing (timeout, dead
                # worker) records an error row; later rates still run.
                results[rate] = {"error": f"{type(e).__name__}: {e}",
                                 "offered_tx_s": float(rate)}
        for m, r in zip(members, member_rpcs):
            try:
                stamps[m.name] = _member_stamp(
                    r.call("node_metrics"), m.device,
                    baseline=baselines.get(m.name))
            # lint: allow(no-silent-except) sweep tooling: a dead member costs its stamp, not the whole sweep; not a production verify/notarise path
            except Exception:
                pass  # a dead member costs its stamp, not the sweep
    return SweepResult(results=results, node_stamps=stamps,
                       doctor=_doctor.stamp_attribution(stamps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tx", type=int, default=100)
    ap.add_argument("--notary", choices=("simple", "validating", "raft",
                                         "raft-validating"),
                    default="simple")
    ap.add_argument("--cluster-size", type=int, default=3)
    ap.add_argument("--disrupt",
                    choices=("kill-notary", "kill-follower",
                             "sigstop-follower"),
                    default=None)
    ap.add_argument("--verifier", choices=("cpu", "torch", "torch-shadow"),
                    default="torch",
                    help="notary-side provider (the card unless cpu)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-sigs", type=int, default=4096)
    ap.add_argument("--processes", action="store_true",
                    help="real OS-process nodes via the driver (+ loadgen "
                         "cordapp firehose) instead of in-process nodes")
    ap.add_argument("--width", type=int, default=32,
                    help="signatures per transaction (multi-owner states)")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--inflight", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop offered load per client (tx/s); 0 = "
                         "closed loop")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="chaos mode: arm a fault plan (lossy | slow-disk | "
                         "flaky-device | bitrot | partition.split-brain | "
                         "partition.asym | partition.flap | path to a plan "
                         "TOML) and notarise through the retrying client "
                         "flow; partition.* plans auto-bind their cut sides "
                         "leader-first over the live cluster")
    ap.add_argument("--kill-leader", action="store_true",
                    help="chaos mode: kill the raft LEADER mid-burst and "
                         "measure recovery (implies chaos mode)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-stage spans on every node and write "
                         "one merged Chrome trace-event JSON here (open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--notary-device", choices=("cpu", "accelerator"),
                    default="accelerator",
                    help="device the first notary member (or the sidecar, "
                         "with --sidecar) owns; --processes mode only")
    ap.add_argument("--sidecar", action="store_true",
                    help="spawn ONE verification sidecar for the host and "
                         "point every notary member at it, coalescing "
                         "verify batches ACROSS processes "
                         "(crypto/sidecar.py; --processes mode only). "
                         "If the sidecar dies, members degrade to their "
                         "local host tier and re-probe on a cooldown — "
                         "at-least-once replay, never a wrong answer")
    ap.add_argument("--sidecar-devices", type=int, default=0,
                    help="mesh width the sidecar owns (--sidecar only): the "
                         "driver passes --devices to the sidecar process "
                         "and, on cpu hosts, forces a virtual device mesh "
                         "of that size so the data-parallel verify plane "
                         "is exercised end to end")
    ap.add_argument("--federation-hosts", type=int, default=0,
                    help="spawn N host-local verification sidecars as "
                         "simulated hosts and point every notary member's "
                         "FederatedVerifier at the set "
                         "(crypto/federation.py: depth + QoS-lane routing, "
                         "hedged re-dispatch, quarantine/re-admit; "
                         "--processes mode, excludes --sidecar). A lost "
                         "host degrades its in-flight batch to the local "
                         "host tier — never a wrong answer")
    ap.add_argument("--shards", type=int, default=0,
                    help="boot N independent raft notary groups partitioned "
                         "by StateRef hash (--processes + raft notary); "
                         "see node/services/sharding.py")
    ap.add_argument("--cross-frac", type=float, default=0.0,
                    help="fraction of transactions spanning two shards "
                         "(the two-phase commit path)")
    ap.add_argument("--lane", choices=("interactive", "bulk"), default="",
                    help="QoS lane label for every firehose transaction "
                         "(--processes mode); arms the QoS plane on every "
                         "node (qos/context.py). Omit for the unlabelled, "
                         "bit-identical pre-QoS run")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="interactive SLO in ms: each interactive tx "
                         "carries deadline = admit + slo_ms, which the "
                         "plane's three batching points flush against "
                         "(with --lane or --offered-load)")
    ap.add_argument("--offered-load", default=None, metavar="R1,R2,..",
                    help="run the mixed-lane SLO sweep instead of a single "
                         "burst: at each offered load (tx/s, comma list) "
                         "every client drives an interactive AND a bulk "
                         "firehose concurrently; prints per-lane p50/p99, "
                         "committed and shed counts plus member QoS stats")
    ap.add_argument("--ingest-sweep", default=None, metavar="R1,R2,..",
                    help="run the multiprocess ingest firehose: one builder "
                         "process batch-signs and serializes the corpus to "
                         "a multi-tx frame, --clients replay workers drive "
                         "disjoint slices of it open-loop at each offered "
                         "rate (tx/s, comma list); prints per-rate "
                         "achieved tx/s, ingest attribution and the "
                         "exactly-once verdict (optionally under --chaos)")
    args = ap.parse_args(argv)
    if args.shards and not args.processes:
        ap.error("--shards requires --processes (each shard group is a "
                 "real raft cluster of OS-process nodes)")
    if args.sidecar and not args.processes:
        ap.error("--sidecar requires --processes (one sidecar per HOST "
                 "only makes sense with real OS-process nodes)")
    if args.sidecar_devices and not args.sidecar:
        ap.error("--sidecar-devices requires --sidecar (the mesh lives "
                 "inside the sidecar server)")
    if args.federation_hosts:
        if not args.processes:
            ap.error("--federation-hosts requires --processes (each "
                     "simulated host is a real sidecar OS process)")
        if args.sidecar:
            ap.error("--federation-hosts excludes --sidecar (federation "
                     "IS the multi-sidecar generalization)")
    if args.lane and not args.processes:
        ap.error("--lane requires --processes (the QoS plane spans real "
                 "node processes; in-process mode has no lane plumbing)")
    if args.ingest_sweep:
        sweep = run_ingest_sweep(
            rates=tuple(float(x) for x in args.ingest_sweep.split(",")),
            n_tx=args.tx, width=args.width, workers=args.clients,
            notary=args.notary, cluster_size=args.cluster_size,
            cross_frac=args.cross_frac, verifier=args.verifier,
            max_sigs=args.max_sigs, max_wait_ms=args.max_wait_ms,
            chaos=args.chaos)
        print(json.dumps({
            "rates": {f"{rate:g}": row for rate, row in sweep.items()},
            "node_stamps": sweep.node_stamps,
            "first_bottleneck": sweep.first_bottleneck,
            "doctor": sweep.doctor,
        }))
        return 0
    if args.offered_load:
        sweep = run_slo_sweep(
            rates=tuple(float(x) for x in args.offered_load.split(",")),
            n_tx=args.tx, width=args.width, clients=args.clients,
            slo_ms=args.slo_ms, notary=args.notary,
            cluster_size=args.cluster_size, verifier=args.verifier,
            notary_device=args.notary_device, max_sigs=args.max_sigs,
            max_wait_ms=args.max_wait_ms, sidecar=args.sidecar,
            sidecar_devices=args.sidecar_devices)
        print(json.dumps({
            "slo_ms": args.slo_ms,
            "rates": {f"{rate:g}": {lane: dict(vars(fr))
                                    for lane, fr in by_lane.items()}
                      for rate, by_lane in sweep.items()},
            "node_stamps": sweep.node_stamps,
            "qos": sweep.qos,
            "first_bottleneck": sweep.first_bottleneck,
            "doctor": sweep.doctor,
        }))
        return 0
    if args.chaos is not None or args.kill_leader:
        result = run_chaos_loadtest(
            plan=args.chaos, n_tx=args.tx, cluster_size=args.cluster_size,
            kill_leader=args.kill_leader, verifier=args.verifier,
            batch=BatchConfig(max_sigs=args.max_sigs,
                              max_wait_ms=args.max_wait_ms),
            rate_tx_s=args.rate, trace=args.trace)
    elif args.processes:
        result = run_loadtest_multiprocess(
            n_tx=args.tx, width=args.width, clients=args.clients,
            notary=args.notary, cluster_size=args.cluster_size,
            verifier=args.verifier, inflight=args.inflight,
            rate_tx_s=args.rate, max_sigs=args.max_sigs,
            max_wait_ms=args.max_wait_ms, disrupt=args.disrupt,
            notary_device=args.notary_device,
            trace=args.trace, sidecar=args.sidecar,
            sidecar_devices=args.sidecar_devices,
            federation_hosts=args.federation_hosts,
            shards=args.shards, cross_frac=args.cross_frac,
            lane=args.lane, slo_ms=args.slo_ms)
    else:
        result = run_loadtest(
            n_tx=args.tx, notary=args.notary,
            cluster_size=args.cluster_size,
            disrupt=args.disrupt, verifier=args.verifier,
            batch=BatchConfig(max_sigs=args.max_sigs,
                              max_wait_ms=args.max_wait_ms),
            trace=args.trace)
    print(result.to_json())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
