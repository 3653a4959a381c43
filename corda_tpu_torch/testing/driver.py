"""The multi-process driver: spawn REAL node processes for integration tests.

Capability match for the reference's driver DSL (reference:
node/src/main/kotlin/net/corda/node/driver/Driver.kt:56-107 — spawns real
node JVMs with real transport + network-map registration, hands back handles;
used by DriverTests, DistributedNotaryTests and every demo). Here each node
is a `python -m corda_tpu_torch.node.node <config.toml>` subprocess over real
sockets and its own sqlite; the driver writes configs, waits for the "up at"
banner, and exposes RPC handles and kill/restart for disruption tests.

Node PLACEMENT goes through the Host seam (reference: the loadtest drives
nodes on remote machines over SSH, tools/loadtest/.../ConnectionManager.kt):
every file write, log read and process spawn is a Host method, so the
harness never assumes localhost — LocalHost is the in-tree placement; an
SSH host implements the same four methods to run the identical workload
against a remote cluster.

The port's own copy of ``corda_tpu/testing/driver.py``. What differs: a
node's placement (``device``) picks its verifier unless the caller names
one — "cpu" renders ``verifier = "cpu"`` and hides the card from the child
(``CUDA_VISIBLE_DEVICES`` empty, so it cannot create a CUDA context);
"accelerator" renders ``verifier = "torch"`` and leaves the card visible.
No JAX environment is set: a spawned node finds its kernels already built
under ``build/corda_tpu_torch/`` (ops.BUILD_ROOT) or builds them at its
warm-up. A sidecar (``start_sidecar``, and ``start_federation``'s simulated
hosts) runs ``python -m corda_tpu_torch.crypto.sidecar`` with
``--device cuda`` on an "accelerator" placement and ``--device cpu`` (the
card hidden) otherwise; ``devices=N`` on a CPU placement splits batches
over N copies of the CPU device (no virtual-device environment is needed).
A node spawned over a base_dir whose log already holds a banner (a restart)
waits for its own banner, not the previous process's.

Usage:
    with driver(tmp_path) as d:
        notary = d.start_node("Notary", notary="simple")
        party = d.start_node("Alice", cordapps=[...], rpc=True)
        client = party.rpc("demo", "s3cret")
        handle = client.start_flow("IssueAndNotariseFlow", 7)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

# The repository root: spawned nodes run `python -m corda_tpu_torch...` from
# here, so the package imports without installation.
_REPO_ROOT = str(Path(__file__).resolve().parents[2])

DEFAULT_RPC_USER = {"username": "demo", "password": "s3cret",
                    "permissions": ["ALL"]}


class Host:
    """Node-placement seam (reference: tools/loadtest/src/main/kotlin/net/
    corda/loadtest/ConnectionManager.kt — the loadtest drives nodes on
    REMOTE hosts over SSH; LoadTest.kt:39-144 runs against them). A Host
    provides file IO + process spawning on the machine that runs a node;
    every Driver operation goes through it, so the harness itself never
    assumes localhost. LocalHost is the in-tree implementation; an SSH twin
    implements the same four methods over a remote connection (sftp for
    files, remote exec returning a signal-capable handle) without touching
    the Driver.

    The handle returned by spawn() must provide the Popen subset the
    driver's disruption primitives use: poll(), wait(timeout),
    send_signal(sig), kill(), terminate(), returncode.
    """

    name = "abstract"

    def mkdir(self, path) -> None:
        raise NotImplementedError

    def write_file(self, path, text: str) -> None:
        raise NotImplementedError

    def read_text(self, path) -> str:
        """Contents of a (log) file; missing file raises OSError."""
        raise NotImplementedError

    def spawn(self, argv: list, log_path, cwd: str, env: dict):
        raise NotImplementedError


class LocalHost(Host):
    """Runs node processes on this machine (the default placement)."""

    name = "localhost"

    def mkdir(self, path) -> None:
        Path(path).mkdir(parents=True, exist_ok=True)

    def write_file(self, path, text: str) -> None:
        Path(path).write_text(text)

    def read_text(self, path) -> str:
        return Path(path).read_text(errors="replace")

    def spawn(self, argv: list, log_path, cwd: str, env: dict):
        # Output goes to a file, NOT a pipe: an undrained pipe would
        # eventually block the node on a full buffer, and the log survives
        # for post-mortem.
        log = open(log_path, "ab")
        try:
            return subprocess.Popen(argv, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    cwd=cwd, env=env)
        finally:
            log.close()  # the child owns the fd now


def _toml_escape(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise TypeError(f"cannot TOML-encode {v!r}")


@dataclass
class NodeProcess:
    name: str
    base_dir: Path
    config_path: Path
    process: object  # Host.spawn handle (Popen subset; see Host doc)
    address: tuple[str, int] | None = None
    rpc_users: list = field(default_factory=list)
    device: str = "cpu"  # "cpu" | "accelerator" — survives restart_node
    host: Host = field(default_factory=LocalHost)
    # Characters of node.log written before this process was spawned: a
    # restart over the same base_dir appends to the log, and its banner
    # must be searched for after the previous process's.
    log_offset: int = 0

    @property
    def log_path(self) -> Path:
        return self.base_dir / "node.log"

    def wait_up(self, timeout: float = 60.0) -> "NodeProcess":
        """Block until the node logs its startup banner; parse the port."""
        deadline = time.monotonic() + timeout
        prefix = f"node {self.name} up at "
        while time.monotonic() < deadline:
            if self.process.poll() is not None:
                tail = ""
                try:
                    tail = self.host.read_text(self.log_path)[-2000:]
                except OSError:
                    pass
                raise RuntimeError(
                    f"node {self.name} exited with {self.process.returncode}:"
                    f"\n{tail}")
            try:
                text = self.host.read_text(self.log_path)[self.log_offset:]
            except OSError:
                text = ""
            for line in text.splitlines():
                if line.startswith(prefix):
                    host, port = line.rsplit(" ", 1)[-1].rsplit(":", 1)
                    self.address = (host, int(port))
                    return self
            time.sleep(0.02)
        raise TimeoutError(f"node {self.name} did not come up in {timeout}s")

    def rpc(self, user: str, password: str, timeout: float = 20.0):
        from ..node.messaging.tcp import TcpAddress
        from ..node.rpc import RpcClient

        assert self.address is not None, "wait_up first"
        return RpcClient(TcpAddress(*self.address), user, password,
                         timeout=timeout)

    def kill(self) -> None:
        """SIGKILL — the Disruption.kt:18-60 'kill the process' primitive."""
        self.process.kill()
        self.process.wait(timeout=10)

    def sigstop(self) -> None:
        """SIGSTOP — the 'hang' primitive (Disruption.kt strainer): the
        process is frozen, not dead; peers see an unresponsive node whose
        sockets stay open — a different failure mode than a clean kill."""
        import signal

        self.process.send_signal(signal.SIGSTOP)

    def sigcont(self) -> None:
        import signal

        self.process.send_signal(signal.SIGCONT)

    def strain(self, seconds: float = 5.0, duty: float = 0.8,
               period: float = 0.1) -> "threading.Thread":
        """CPU-strain disruption (reference: Disruption.kt strainCpu): the
        node is made SLOW-BUT-ALIVE — frozen for `duty` of every `period`
        via SIGSTOP/SIGCONT duty-cycling on a background thread, the
        portable equivalent of the reference's openssl busy-loop siblings.
        Sockets stay open; peers see a node that responds, late — the
        failure mode that exposes timeout tuning, distinct from both a
        clean kill and a full hang. Returns the (daemon) thread; join it to
        wait the strain out."""
        import threading

        def cycle():
            end = time.monotonic() + seconds
            while time.monotonic() < end and self.process.poll() is None:
                try:
                    self.sigstop()
                    time.sleep(duty * period)
                    self.sigcont()
                    time.sleep((1.0 - duty) * period)
                except (OSError, ValueError):
                    return  # process gone mid-cycle
            try:  # never leave the node frozen
                self.sigcont()
            except (OSError, ValueError):
                pass

        t = threading.Thread(target=cycle, daemon=True,
                             name=f"strain-{self.name}")
        t.start()
        return t

    def terminate(self) -> None:
        self.process.terminate()
        try:
            self.process.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=5)


@dataclass
class SidecarProcess:
    """Handle on a spawned verification sidecar (crypto/sidecar.py) -- the
    one device-owning verify server every node process on the host feeds.
    Implements the Popen-subset methods stop_all uses, so it rides the
    driver's node list for lifecycle."""

    name: str
    base_dir: Path
    address: str  # unix socket path or host:port
    process: object  # Host.spawn handle (Popen subset)
    host: Host = field(default_factory=LocalHost)

    @property
    def log_path(self) -> Path:
        return self.base_dir / "sidecar.log"

    def wait_up(self, timeout: float = 60.0) -> "SidecarProcess":
        deadline = time.monotonic() + timeout
        prefix = "sidecar up at "
        while time.monotonic() < deadline:
            if self.process.poll() is not None:
                tail = ""
                try:
                    tail = self.host.read_text(self.log_path)[-2000:]
                except OSError:
                    pass
                raise RuntimeError(
                    f"sidecar {self.name} exited with "
                    f"{self.process.returncode}:\n{tail}")
            try:
                text = self.host.read_text(self.log_path)
            except OSError:
                text = ""
            for line in text.splitlines():
                if line.startswith(prefix):
                    # tcp with port 0 resolves here; unix echoes the path
                    self.address = line[len(prefix):].strip()
                    return self
            time.sleep(0.02)
        raise TimeoutError(
            f"sidecar {self.name} did not come up in {timeout}s")

    def kill(self) -> None:
        """SIGKILL mid-batch -- the kill-sidecar chaos primitive: clients
        must degrade to their host tier and flows replay, never mis-commit."""
        self.process.kill()
        self.process.wait(timeout=10)

    def sigcont(self) -> None:
        import signal

        self.process.send_signal(signal.SIGCONT)

    def terminate(self) -> None:
        self.process.terminate()
        try:
            self.process.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=5)


def render_node_config(name: str, node_dir, netmap, notary: str = "none",
                       raft_cluster: tuple[str, ...] = (),
                       cordapps: tuple[str, ...] = (),
                       extra_toml: str = "",
                       rpc_users: list | None = None,
                       verifier: str | None = None) -> str:
    """The node.toml the driver writes for a child. Ordering is
    load-bearing: extra_toml goes BEFORE any [[rpc_users]] table — TOML
    keys after a table header belong to that table, so a trailing
    `verifier = ...` would silently become an rpc_users field and the node
    would run the default verifier (observed: every RPC-enabled node
    ignored its configured verifier). ``verifier`` None writes no verifier
    key (extra_toml may carry one)."""
    lines = [
        f"name = {_toml_escape(name)}",
        f"base_dir = {_toml_escape(str(node_dir))}",
        f"network_map = {_toml_escape(str(netmap))}",
        f"notary = {_toml_escape(notary)}",
    ]
    if raft_cluster:
        lines.append(
            "raft_cluster = ["
            + ", ".join(_toml_escape(n) for n in raft_cluster) + "]")
    if verifier is not None:
        lines.append(f"verifier = {_toml_escape(verifier)}")
    if cordapps:
        lines.append(
            "cordapps = ["
            + ", ".join(_toml_escape(c) for c in cordapps) + "]")
    if extra_toml:
        lines.append(extra_toml)
    for user in rpc_users or []:
        lines.append("[[rpc_users]]")
        lines.append(f"username = {_toml_escape(user['username'])}")
        lines.append(f"password = {_toml_escape(user['password'])}")
        lines.append("permissions = ["
                     + ", ".join(_toml_escape(p)
                                 for p in user["permissions"]) + "]")
    return "\n".join(lines) + "\n"


def shard_groups_toml(groups, reserve_ttl_s: float = 15.0,
                      count: int | None = None) -> str:
    """The `[notary_shards]` fragment for a sharded-notary topology
    (services/sharding.py): identical text for every member — each node
    derives its own group from its own name. `groups` is a sequence of
    member-name sequences, index = shard id. `count` below len(groups)
    marks the trailing groups as PENDING split targets (booted and
    electable but owning no keyspace until a reshard epoch activates
    them). NOTE: this opens a TOML table, so when composing extra_toml put
    this fragment LAST among bare keys (the same ordering rule
    render_node_config applies to [[rpc_users]])."""
    groups = list(groups)
    rows = ",\n  ".join(
        "[" + ", ".join(_toml_escape(str(m)) for m in g) + "]"
        for g in groups)
    return ("[notary_shards]\n"
            f"count = {len(groups) if count is None else int(count)}\n"
            f"reserve_ttl_s = {_toml_escape(float(reserve_ttl_s))}\n"
            "groups = [\n  " + rows + ",\n]")


def _names_verifier(extra_toml: str) -> bool:
    """Whether ``extra_toml`` sets the top-level ``verifier`` key (a key
    before its first table header); the placement's default then yields."""
    for line in extra_toml.splitlines():
        line = line.strip()
        if line.startswith("["):
            return False
        if line.split("=", 1)[0].strip() == "verifier" and "=" in line:
            return True
    return False


def _node_env(device: str) -> dict:
    """Per-node device policy (the production topology: only the notary
    process owns the card; every other child stays on the host path).

    * "cpu": hide the card from the child (``CUDA_VISIBLE_DEVICES`` empty),
      so it cannot create a CUDA context.
    * "accelerator": the inherited environment, card visible.
    """
    env = dict(os.environ)
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif device != "accelerator":
        raise ValueError(f"device must be cpu | accelerator, got {device!r}")
    return env


def _log_size(host: Host, path) -> int:
    """Characters already in a node's log (0 when there is none)."""
    try:
        return len(host.read_text(path))
    except OSError:
        return 0


class Driver:
    def __init__(self, base_dir: Path, host: Host | None = None):
        self.base_dir = Path(base_dir)
        self.nodes: list[NodeProcess] = []
        self._deferred: list = []  # cleanup callbacks (run first in stop_all)
        self.netmap = self.base_dir / "netmap.json"
        # Default placement for every node; start_node(host=...) overrides
        # per node (the reference's loadtest places nodes on the remote
        # hosts its config lists, ConnectionManager.kt).
        self.host = host or LocalHost()

    _NODE_ARGV = [sys.executable, "-m", "corda_tpu_torch.node.node"]
    _NODE_CWD = _REPO_ROOT

    def start_node(self, name: str, notary: str = "none",
                   cordapps: tuple[str, ...] = (), rpc: bool = False,
                   raft_cluster: tuple[str, ...] = (),
                   wait: bool = True, extra_toml: str = "",
                   device: str = "cpu",
                   env_extra: dict | None = None,
                   config_overlay: dict | None = None,
                   host: Host | None = None) -> NodeProcess:
        """The node's verifier follows ``device``: "torch" on an
        "accelerator" placement, "cpu" otherwise, unless ``extra_toml``
        names one (a top-level ``verifier = ...``). env_extra: extra
        environment for the child (e.g.
        CORDA_TPU_FAULT_PLAN=<plan.toml> to arm a chaos plan in that
        process without touching node.toml). config_overlay: per-knob
        config overrides for THIS child, shipped as one
        CORDA_TPU_CONFIG_OVERLAY env (JSON) that NodeConfig.load
        deep-merges over node.toml — the autotune sweep road; precedence
        is TOML < overlay < explicit CORDA_TPU_* env vars."""
        host = host or self.host
        node_dir = self.base_dir / name
        host.mkdir(node_dir)
        rpc_users = [DEFAULT_RPC_USER] if rpc else []
        config_path = node_dir / "node.toml"
        host.write_file(config_path, render_node_config(
            name=name, node_dir=node_dir, netmap=self.netmap, notary=notary,
            raft_cluster=raft_cluster, cordapps=cordapps,
            extra_toml=extra_toml, rpc_users=rpc_users,
            verifier=(None if _names_verifier(extra_toml)
                      else "torch" if device == "accelerator" else "cpu")))

        env = _node_env(device)
        offset = _log_size(host, node_dir / "node.log")
        if config_overlay:
            env["CORDA_TPU_CONFIG_OVERLAY"] = json.dumps(
                config_overlay, sort_keys=True)
        if env_extra:
            env.update({k: str(v) for k, v in env_extra.items()})
        process = host.spawn(
            self._NODE_ARGV + [str(config_path)],
            node_dir / "node.log", self._NODE_CWD, env)
        handle = NodeProcess(name, node_dir, config_path, process,
                             rpc_users=rpc_users, device=device, host=host,
                             log_offset=offset)
        self.nodes.append(handle)
        if wait:
            handle.wait_up()
        return handle

    def start_shard_cluster(self, groups: int = 2, members: int = 3,
                            notary: str = "raft-simple",
                            reserve_ttl_s: float = 15.0,
                            extra_toml: str = "",
                            cordapps: tuple[str, ...] = (),
                            rpc: bool = False,
                            device_member: tuple[int, int] | None = None,
                            env_extra: dict | None = None,
                            wait: bool = True,
                            prefix: str = "Shard",
                            count: int | None = None) -> list:
        """Boot a sharded notary: `groups` independent Raft groups of
        `members` nodes each (names Shard0A, Shard0B, ... Shard1A, ...),
        every member carrying the same [notary_shards] map so each derives
        its group from its own name. Returns handles indexed
        [group][member]. `device_member` names the single (group, member)
        that owns the card (production placement: one card, one process;
        its verifier is "torch"); everyone else stays on the host path
        (verifier "cpu", the card hidden). `count` below
        `groups` boots the trailing groups as pending split targets for a
        live reshard (publish_reshard_plan activates them)."""
        names = [[f"{prefix}{g}{chr(ord('A') + m)}" for m in range(members)]
                 for g in range(groups)]
        shard_toml = shard_groups_toml(names, reserve_ttl_s, count=count)
        merged = (extra_toml + "\n" + shard_toml) if extra_toml else shard_toml
        handles = []
        for g, group_names in enumerate(names):
            row = []
            for m, name in enumerate(group_names):
                device = ("accelerator" if device_member == (g, m) else "cpu")
                row.append(self.start_node(
                    name, notary=notary, raft_cluster=tuple(group_names),
                    cordapps=cordapps, rpc=rpc,
                    wait=False, extra_toml=merged, device=device,
                    env_extra=env_extra))
            handles.append(row)
        if wait:
            for row in handles:
                for h in row:
                    h.wait_up()
        return handles

    _SIDECAR_ARGV = [sys.executable, "-m", "corda_tpu_torch.crypto.sidecar"]

    def start_sidecar(self, name: str = "sidecar", verifier: str = "torch",
                      device: str = "accelerator", coalesce_us: int = 2000,
                      max_sigs: int = 4096, depth: int = 2,
                      address: str | None = None,
                      env_extra: dict | None = None,
                      wait: bool = True,
                      devices: int | None = None,
                      adaptive_coalesce: bool = False,
                      host: Host | None = None) -> SidecarProcess:
        """Spawn ONE verification sidecar for the host (crypto/sidecar.py).
        Point node processes at it via `[batch] sidecar = "<address>"` (or
        CORDA_TPU_SIDECAR in env_extra) so their verify batches coalesce
        across processes. Default address: a unix socket under the
        sidecar's base dir (falls back to a short temp dir when the path
        would blow the ~108-byte AF_UNIX limit).

        device: "accelerator" runs the sidecar's verifier on the card
        (``--device cuda``), "cpu" hides the card and runs it on the CPU.
        devices=N splits each batch across N devices (TorchMeshVerifier);
        on "cpu" that is N copies of the CPU device."""
        host = host or self.host
        side_dir = self.base_dir / name
        host.mkdir(side_dir)
        if address is None:
            address = str(side_dir / "sc.sock")
            if len(address) > 90:
                import tempfile

                address = str(Path(tempfile.mkdtemp(
                    prefix="corda-tpu-sc-")) / "sc.sock")
        env = _node_env(device)
        if env_extra:
            env.update({k: str(v) for k, v in env_extra.items()})
        argv = self._SIDECAR_ARGV + [
            "--socket", address, "--verifier", verifier,
            "--device", "cuda" if device == "accelerator" else "cpu",
            "--coalesce-us", str(coalesce_us),
            "--max-sigs", str(max_sigs), "--depth", str(depth)]
        if devices:
            argv += ["--devices", str(devices)]
        if adaptive_coalesce:
            argv += ["--adaptive-coalesce"]
        process = host.spawn(argv, side_dir / "sidecar.log",
                             self._NODE_CWD, env)
        handle = SidecarProcess(name, side_dir, address, process, host=host)
        # Rides the node list so stop_all terminates it with the cluster.
        self.nodes.append(handle)
        if wait:
            handle.wait_up()
        return handle

    def start_federation(self, count: int = 2,
                         name_prefix: str = "fedhost",
                         verifier: str = "cpu", device: str = "cpu",
                         coalesce_us: int = 2000, max_sigs: int = 4096,
                         depth: int = 2, devices: int | None = None,
                         env_extra: dict | None = None,
                         wait: bool = True) -> list[SidecarProcess]:
        """Spawn `count` sidecar servers as SIMULATED HOSTS for the
        federated verify plane (crypto/federation.py) -- each its own
        process with its own socket, scheduler and device(s), so
        cross-host routing/hedging/degrade runs on one box. Point nodes at
        the tier by joining the returned handles' addresses with "," into
        `[batch] federation_hosts` (or CORDA_TPU_FEDERATION in env_extra).
        Kill any one handle to exercise the per-host quarantine -> re-probe
        -> re-admit path."""
        handles = [
            self.start_sidecar(
                name=f"{name_prefix}{i}", verifier=verifier, device=device,
                coalesce_us=coalesce_us, max_sigs=max_sigs, depth=depth,
                devices=devices, env_extra=env_extra, wait=False)
            for i in range(count)]
        if wait:
            for h in handles:
                h.wait_up()
        return handles

    def restart_node(self, handle: NodeProcess,
                     wait: bool = True) -> NodeProcess:
        """Re-spawn a (killed) node over its existing base_dir + config —
        rebirth purely from disk (the kill/restart Disruption primitive)."""
        offset = _log_size(handle.host, handle.log_path)
        process = handle.host.spawn(
            self._NODE_ARGV + [str(handle.config_path)],
            handle.base_dir / "node.log", self._NODE_CWD,
            _node_env(handle.device))
        reborn = NodeProcess(handle.name, handle.base_dir, handle.config_path,
                             process, rpc_users=handle.rpc_users,
                             device=handle.device, host=handle.host,
                             log_offset=offset)
        self.nodes.append(reborn)
        if wait:
            reborn.wait_up()
        return reborn

    def defer(self, cleanup) -> None:
        """Register a cleanup (e.g. an RpcClient.close) to run at driver
        exit, BEFORE nodes are stopped — success or exception alike."""
        self._deferred.append(cleanup)

    def stop_all(self) -> None:
        for cleanup in self._deferred:
            try:
                cleanup()
            # lint: allow(no-silent-except) harness teardown: stop_all() must run every deferred cleanup even when earlier ones fail; never on a node path
            except Exception:
                pass
        self._deferred.clear()
        for node in self.nodes:
            if node.process.poll() is None:
                try:
                    node.sigcont()  # un-freeze SIGSTOP'd nodes so they exit
                except (OSError, ValueError):
                    pass
                node.terminate()


@contextmanager
def driver(base_dir: str | Path, host: Host | None = None):
    d = Driver(Path(base_dir), host=host)
    try:
        yield d
    finally:
        d.stop_all()
