"""Closed loop of client nodes through a raft-validating notary cluster
whose members verify through one card sidecar, every node and the sidecar a
process of the program's own entry points (``corda_tpu_torch.node.node``,
``corda_tpu_torch.crypto.sidecar``), spawned under the run's temporary
directory by the program's multi-process driver (``testing/driver.py``).

Traffic keys: ``moves_per_client`` (the corpus each client signs from the
seed at set-up), ``inflight`` moves a client, ``warm`` outcomes a client
before the window opens, ``tampered_per_block`` and ``second_per_block``
moves in every ``block`` (``cluster/plan.py``), and ``cores``: the cores
(indices into the harness's own, sorted) each process is pinned to, by
name (``harness``, ``sidecar``, the clients) and for the members a list
of core sets, one a member in the order of their names. A host with fewer
cores runs unpinned. The configuration gives the members, the clients,
the width, the majority and the ``[batch]`` and sidecar settings.

The clients run ``cluster/fh32_flow.py``, started once every client's
network map lists every member. Each takes its notary as the program's
clients do, ``get_any_notary``: the map's first, and the map lists nodes
by name, so every move goes to ``Raft0``, which validates it and commits
its inputs through whichever member leads. The sidecar runs through
``cluster/sidecar_host.py`` when the run is traced (the profiler over the
window, inside the process that holds the card) or a fault is planted.

The window opens once every client has had ``warm`` outcomes (the election,
the sidecar's first batches and sqlite's first pages lie behind it) and
closes ``--seconds`` later, when the clients stop starting moves; they then
drain. ``verified_sigs_per_s`` = width x moves whose outcome (acknowledged
or refused) reached their client inside the window / the window.

Correct: every move any client started, judged by ``reference/judge.py``
against its label from the seed and the members' stores read after they
stopped, the notary signatures by the frozen oracle.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ..cluster import plan
from ..harness import card, signing
from ..reference import judge

BOOT_TIMEOUT_S = 180.0
WARM_TIMEOUT_S = 300.0
TRACE_TIMEOUT_S = 120.0
DRAIN_TIMEOUT_S = 120.0
SETTLE_TIMEOUT_S = 30.0
POLL_S = 0.05
CLIENT_CORDAPP = "benchmark.cluster.fh32_flow"


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return json.dumps(v)


def batch_toml(cfg: dict, sidecar: str = "") -> str:
    """The ``[batch]`` table every node's TOML carries."""
    lines = ["[batch]"] + [f"{k} = {_toml_value(v)}"
                           for k, v in cfg["batch"].items()]
    if sidecar:
        lines.append(f"sidecar = {json.dumps(sidecar)}")
    return "\n".join(lines)


def layout(cores: dict | None) -> dict | None:
    """{process name: cpu ids} from the traffic's ``cores``, or None when
    unpinned (none given, or fewer cores here than it names)."""
    if not cores:
        return None
    mine = sorted(os.sched_getaffinity(0))
    sets = [ids for name, ids in cores.items() if name != "members"]
    sets += cores.get("members", [])
    if max(i for ids in sets for i in ids) >= len(mine):
        return None
    out = {name: [mine[i] for i in ids] for name, ids in cores.items()
           if name != "members"}
    out["members"] = [[mine[i] for i in ids]
                      for ids in cores.get("members", [])]
    return out


def pin(pid: int, cpus) -> None:
    """Every thread of process ``pid`` onto ``cpus`` (threads it starts
    later inherit them)."""
    try:
        tids = [int(t) for t in os.listdir(f"/proc/{pid}/task")]
    except OSError:
        tids = [pid]
    for tid in tids:
        try:
            os.sched_setaffinity(tid, cpus)
        except OSError:
            pass


def card_memory_bytes() -> int:
    """The card's memory in use (nvidia-smi), 0 when it cannot say: the
    sidecar is the one process that holds the card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return 0
    try:
        out = subprocess.run(
            [exe, "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return int(float(out.splitlines()[0])) * 2 ** 20
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return 0


def _wait(pred, timeout: float, what: str, alive=None):
    """``pred()``'s first true value, polled until ``timeout``."""
    deadline = time.monotonic() + timeout
    while not (value := pred()):
        if alive is not None:
            alive()
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} did not happen in {timeout} s")
        time.sleep(POLL_S)
    return value


def _fs_type(path: Path) -> str:
    """The file system type of the mount that holds ``path``."""
    best, kind = "", "?"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                mnt, fs = line.split()[1:3]
                if str(path).startswith(mnt) and len(mnt) > len(best):
                    best, kind = mnt, fs
    except OSError:
        pass
    return kind


def _member_view(metrics: dict) -> dict:
    """What the readers take from a member's node_metrics."""
    return {"round_stage_s": dict(metrics.get("round_stage_s") or {}),
            "raft": dict(metrics.get("raft") or {})}


def _touch(path: Path) -> None:
    path.write_text(str(time.time()))


class Cluster:
    """The run's processes and the harness's RPC clients to them."""

    def __init__(self, ctx, base: Path, control: Path):
        from corda_tpu_torch.testing.driver import Driver

        self.ctx = ctx
        self.cfg, self.t = ctx.config, ctx.traffic
        self.control = control
        self.d = Driver(base)
        self.cores = layout(self.t.get("cores"))
        self.rpcs: dict = {}
        self.members = [f"Raft{i}" for i in range(int(self.cfg["members"]))]
        self.clients = [f"Client{i}" for i in range(int(self.cfg["clients"]))]

    def _pin(self, name: str, pid: int) -> None:
        if self.cores is None:
            return
        if name in self.members:
            pin(pid, self.cores["members"][self.members.index(name)])
        else:
            pin(pid, self.cores[name])

    def boot(self) -> None:
        """The sidecar first, alone and on any core (torch's import and the
        card's set-up), pinned once up; then the nodes, each pinned as it is
        spawned. (Nodes booting beside the sidecar slowed both and left the
        cluster electing leaders into the window.)"""
        ctx, cfg = self.ctx, self.cfg
        fault = ctx.overrides.get("sidecar_fault")
        if ctx.trace or fault:
            self.d._SIDECAR_ARGV = [
                sys.executable, "-m", "benchmark.cluster.sidecar_host",
                "--control", str(self.control)] + (
                ["--trace"] if ctx.trace else []) + (
                ["--fault", fault] if fault else []) + ["--"]
        sc = cfg["sidecar"]
        self.sidecar = self.d.start_sidecar(
            # On a CPU the plain PyTorch verifier takes tens of seconds a
            # batch: a CPU rehearsal's sidecar verifies on the host tier.
            verifier="torch" if ctx.device == "cuda" else "cpu",
            device="accelerator" if ctx.device == "cuda" else "cpu",
            coalesce_us=int(sc["coalesce_us"]), max_sigs=int(sc["max_sigs"]),
            depth=int(sc["depth"]), wait=False)
        self.sidecar.wait_up(BOOT_TIMEOUT_S)
        self._pin("sidecar", self.sidecar.process.pid)
        ctx.mark("sidecar up")
        member_toml = batch_toml(cfg, self.sidecar.address)
        for name in self.members:
            h = self.d.start_node(
                name, notary=cfg["notary"], raft_cluster=tuple(self.members),
                cordapps=("corda_tpu_torch.testing.dummies",), rpc=True,
                extra_toml=member_toml, device="cpu", wait=False)
            self._pin(name, h.process.pid)
        for name in self.clients:
            h = self.d.start_node(
                name, rpc=True, cordapps=(CLIENT_CORDAPP,),
                extra_toml=batch_toml(cfg), device="cpu", wait=False)
            self._pin(name, h.process.pid)
        if self.cores is not None:
            os.sched_setaffinity(0, self.cores["harness"])
        for h in self.d.nodes:
            if h is not self.sidecar:
                h.wait_up(BOOT_TIMEOUT_S)
                rpc = h.rpc("demo", "s3cret", timeout=60.0)
                self.d.defer(rpc.close)
                self.rpcs[h.name] = rpc
        ctx.mark("nodes up")

    def leader(self) -> str | None:
        """The member that leads the cluster, if one does."""
        return next((m for m in self.members
                     if (self.rpcs[m].call("node_metrics").get("raft")
                         or {}).get("role") == "leader"), None)

    def map_complete(self) -> bool:
        """Every client's network map lists every member."""
        return all(set(self.members) <= {
            n.legal_identity.name
            for n in self.rpcs[c].call("network_map_snapshot")}
            for c in self.clients)

    def notary_keys(self) -> set:
        """The members' notary public keys, as the clients record them."""
        return {bytes(k.encoded) for m in self.members
                for k in self.rpcs[m].call("node_identity").owning_key.keys}

    def alive(self) -> None:
        for h in self.d.nodes:
            if h.process.poll() is not None:
                raise RuntimeError(f"{h.name} exited with "
                                   f"{h.process.returncode}")

    def snapshot(self) -> dict:
        from corda_tpu_torch.node.verify_client import fetch_sidecar_stats

        out = {"members": {m: _member_view(self.rpcs[m].call("node_metrics"))
                           for m in self.members},
               "clients": {c: _member_view(self.rpcs[c].call("node_metrics"))
                           for c in self.clients}}
        out["sidecar"] = fetch_sidecar_stats(self.sidecar.address,
                                             timeout=20.0)
        return out

    def settled(self) -> bool:
        """Every member has applied what the leader committed."""
        stamps = [self.rpcs[m].call("node_metrics").get("raft") or {}
                  for m in self.members]
        return (len({s.get("commit_index") for s in stamps}) == 1
                and len({s.get("committed_states") for s in stamps}) == 1
                and not any(s.get("apply_backlog") for s in stamps))

    def stop(self) -> None:
        try:
            self.d.stop_all()
        finally:
            for h in self.d.nodes:
                if h.process.poll() is None:
                    h.process.kill()
                    h.process.wait(timeout=10)


def _exit_on_term(signum, frame):
    raise SystemExit(128 + signum)


def _cpu_steal() -> tuple[int, int]:
    """(steal, total) jiffies of this machine so far (/proc/stat): the time
    the host gave this virtual machine's cores to others."""
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return 0, 0
    return (cpu[7] if len(cpu) > 7 else 0), sum(cpu)


def _start_flows(ctx, cluster: Cluster, control: Path) -> dict:
    """Each client's firehose: {client: flow handle}."""
    t = ctx.traffic
    return {name: cluster.rpcs[name].call(
        "start_flow_dynamic", "bench.Fh32Flow",
        (ctx.seed, i, int(t["moves_per_client"]), int(ctx.config["width"]),
         int(t["inflight"]), int(t["warm"]), int(t["tampered_per_block"]),
         int(t["second_per_block"]), int(t["block"]), str(control)))
        for i, name in enumerate(cluster.clients)}


def _moves(ctx, clients: list, control: Path, results: dict) -> list:
    """Every move the clients started, as the judge takes it, with its label
    from the seed and the time its outcome reached its client."""
    t = ctx.traffic
    moves = []
    for i, name in enumerate(clients):
        kind, _ = plan.moves(ctx.seed, i, int(t["moves_per_client"]),
                             int(t["tampered_per_block"]),
                             int(t["second_per_block"]), int(t["block"]))
        records = json.loads((control / f"records_{i}.json").read_text())
        if len({r["i"] for r in records}) != results[name]["started"]:
            raise RuntimeError(f"{name} recorded {len(records)} of "
                               f"{results[name]['started']} moves")
        for r in records:
            m = {"honest": kind[r["i"]] == plan.HONEST, "acked": r["acked"],
                 "tx_id": bytes.fromhex(r["tx_id"]),
                 "inputs": [(bytes.fromhex(h), k) for h, k in r["inputs"]],
                 "t_start": r["t_start"], "t_done": r["t_done"]}
            if r["acked"]:
                m["notary_pk"] = bytes.fromhex(r["notary_pk"])
                m["notary_sig"] = bytes.fromhex(r["notary_sig"])
            moves.append(m)
    return moves


def _stage_ms(view: list, moves: int) -> dict:
    """A process's Δ``round_stage_s`` over the window, ms a window move."""
    b, a = (v["round_stage_s"] for v in view)
    out = {k: round(1e3 * (a[k] - b.get(k, 0)) / max(1, moves), 3)
           for k in a if k != "rounds"}
    out["rounds"] = a.get("rounds", 0) - b.get("rounds", 0)
    return out


def run(ctx) -> dict:
    cfg = ctx.config
    width = int(cfg["width"])
    control = ctx.tmp / "control"
    control.mkdir()
    cluster = Cluster(ctx, ctx.tmp / "cluster", control)
    home_cores = os.sched_getaffinity(0)
    results = {}
    # A run stopped from outside (SIGTERM) still stops every process it
    # started, on the way out through the ``finally`` below.
    old_term = signal.signal(signal.SIGTERM, _exit_on_term)
    try:
        cluster.boot()
        first_leader = _wait(cluster.leader, BOOT_TIMEOUT_S,
                             "the cluster's election", alive=cluster.alive)
        ctx.mark("elected")
        _wait(cluster.map_complete, BOOT_TIMEOUT_S, "the clients' maps",
              alive=cluster.alive)
        flows = _start_flows(ctx, cluster, control)

        def flows_alive():
            cluster.alive()
            for name, fh in flows.items():
                done, value = cluster.rpcs[name].call("flow_result",
                                                      fh.run_id)
                if done:
                    raise RuntimeError(f"{name}'s flow ended early: {value}")

        _wait(lambda: all((control / f"warm_{i}").exists()
                          for i in range(len(cluster.clients))),
              WARM_TIMEOUT_S, "the clients' warm-up", alive=flows_alive)
        ctx.mark("warm")
        before = cluster.snapshot()
        pinned = {h.name: sorted(os.sched_getaffinity(h.process.pid))
                  for h in cluster.d.nodes}
        if ctx.trace:
            _touch(control / "trace_start")
            _wait((control / "trace_started").exists, TRACE_TIMEOUT_S,
                  "the sidecar's profiler start", alive=cluster.alive)
        steal0 = _cpu_steal()
        t0 = time.time()
        ctx.open_window()
        time.sleep(ctx.seconds)
        t1 = time.time()
        _touch(control / "stop")
        steal1 = _cpu_steal()
        if ctx.trace:
            _touch(control / "trace_stop")
        after = cluster.snapshot()
        memory = card_memory_bytes() if ctx.device == "cuda" else 0

        def drained() -> bool:
            for name, fh in flows.items():
                if name not in results:
                    done, value = cluster.rpcs[name].call("flow_result",
                                                          fh.run_id)
                    if done:
                        results[name] = value
            return len(results) == len(flows)

        _wait(drained, DRAIN_TIMEOUT_S, "the clients' drain",
              alive=cluster.alive)
        _wait(cluster.settled, SETTLE_TIMEOUT_S, "the members' apply",
              alive=cluster.alive)
        term_end = max(cluster.rpcs[m].call("node_metrics")["raft"]["term"]
                       for m in cluster.members)
        notary_keys = cluster.notary_keys()
        trace = None
        if ctx.trace:
            path = control / "trace.json"
            _wait(path.exists, TRACE_TIMEOUT_S, "the sidecar's trace",
                  alive=cluster.alive)
            trace = json.loads(path.read_text())
    finally:
        cluster.stop()
        os.sched_setaffinity(0, home_cores)
        signal.signal(signal.SIGTERM, old_term)
    for name, value in results.items():
        if not isinstance(value, dict):
            raise RuntimeError(f"{name}'s flow failed: {value!r}")
    stores = [judge.committed(cluster.d.base_dir / m / "node.db")
              for m in cluster.members]
    moves = _moves(ctx, cluster.clients, control, results)
    with signing.pool() as workers:
        checks = judge.judge(
            moves, stores, int(cfg["majority"]), notary_keys,
            lambda lanes: signing.oracle_verdicts(lanes, pool=workers))
    window = t1 - t0
    in_window = [m for m in moves if t0 <= m["t_done"] <= t1]
    leader = next((m for m in cluster.members
                   if after["members"][m]["raft"].get("role") == "leader"),
                  None)
    layer = {"window_s": window, "moves_in_window": len(in_window),
             "leader": leader,
             "members": {m: [before["members"][m], after["members"][m]]
                         for m in cluster.members},
             "sidecar": [before["sidecar"], after["sidecar"]]}
    if trace is not None:
        layer["trace"] = trace
    import torch

    device = {"kind": (torch.cuda.get_device_name(0)
                       if ctx.device == "cuda" else "cpu"),
              "memory_peak_bytes": int(memory)}
    out = {"e2e": {"verified_sigs_per_s": width * len(in_window) / window},
           "attempted": len(in_window),
           "failed": sum(m["acked"] is not m["honest"] for m in in_window),
           "checks": {k: (v, 0) for k, v in checks.items()},
           "device": device, "layer": layer}
    lat = np.array([m["t_done"] - m["t_start"] for m in in_window] or [0.0])
    dones = np.array([m["t_done"] for m in in_window])
    sb, sa = before["sidecar"], after["sidecar"]
    out["detail"] = {
        "moves_in_window": len(in_window), "window_s": window,
        "tx_per_s": len(in_window) / window,
        "latency_ms_p50_p99": [1e3 * float(np.percentile(lat, 50)),
                               1e3 * float(np.percentile(lat, 99))],
        "moves_started": len(moves), "leader": [first_leader, leader],
        "term": [max(before["members"][m]["raft"].get("term") or 0
                     for m in cluster.members), term_end],
        "clients": {name: dict(v, prepared_at=v["prepared_at"]
                               - ctx.t_process)
                    for name, v in results.items()},
        "pinned": pinned,
        "outcomes_by_third": [int(np.count_nonzero(
            (dones >= t0 + k * window / 3)
            & (dones < t0 + (k + 1) * window / 3))) for k in range(3)],
        "stage_ms_per_move": {
            n: _stage_ms([before[g][n], after[g][n]], len(in_window))
            for g in ("members", "clients") for n in before[g]},
        "sidecar_window": {k: (sa.get(k) or 0) - (sb.get(k) or 0) for k in
                           ("requests", "batches", "sigs", "device_batches",
                            "wait_s_total", "verify_s_total")},
        "committed_states": [len(s) for s in stores],
        "cpu_steal_share": ((steal1[0] - steal0[0])
                            / max(1, steal1[1] - steal0[1])),
        "tmp_fs": _fs_type(ctx.tmp)}
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    if ctx.device == "cuda":
        device.update(card.smi())
    return out
