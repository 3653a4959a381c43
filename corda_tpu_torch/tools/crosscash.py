"""CrossCash: random cash traffic + a predicted state model + convergence.

Capability match for the reference's CrossCashTest (reference:
tools/loadtest/src/main/kotlin/net/corda/loadtest/tests/CrossCashTest.kt:1-80
and LoadTest.kt:121-129): random issues / payments between real node
processes, a coordinator-side PREDICTED model of every node's cash balance,
and a gather step that polls remote vaults until they CONVERGE to the
prediction — the check that catches double-spends, lost updates and
vault/notary divergence that commit/reject counting cannot.

Model-shape differences from the reference, by design:

* The reference gathers mid-traffic and therefore needs an interleaving
  search over per-node diff queues (CrossCashTest.kt:50-66). Here commands
  execute in seeded WAVES and every wave ends with a poll-until-converged
  gather, where each notarised transaction has a deterministic eventual
  state — broadcast laggards are absorbed by the polling loop rather than a
  queue search. Same detection power at the states we check.
* The model predicts per-node TOTALS, not per-issuer buckets: which coins
  Cash.generate_spend consumes depends on vault iteration order, which a
  remote model cannot know — predicting issuer flows would need to mirror
  it. Totals are order-independent and still expose every consistency bug
  the check exists for (a double-spend inflates a balance; a lost update
  deflates one). Per-issuer detail is still gathered for diagnostics.

Disruptions (reference: Disruption.kt:18-60): kill-follower (SIGKILL +
restart from disk), sigstop-follower (hang), and strain-follower — the
CPU-strain equivalent implemented as SIGSTOP duty-cycling, producing the
slow-but-alive node that exposes timeout tuning.

The port's own copy of ``corda_tpu/tools/crosscash.py``. What differs:
every node process (the notary members and the banks) runs on the card
unless the caller asks for the host (``device="accelerator"``, CLI
``--device``; a node asked for the card on a host without one fails to
start, and the run raises), the nodes load the port's cordapp
(``corda_tpu_torch.tools.crosscash``), the flow registers in the port's
own flow registry, the result carries each process's verify batches by
tier and the kernel launches it made after its boot warm, read over RPC
before the nodes stop (``verify_tiers``), and
``CashCommandResult`` registers under its module's wire name even when the
file runs as ``__main__``, so ``python -m corda_tpu_torch.tools.crosscash``
decodes the nodes' replies (the reference's CLI cannot).
"""

from __future__ import annotations

import random
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..finance import Amount, Cash, CashState
from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.finality import FinalityFlow
from ..serialization.codec import register_class
from ..transactions.builder import TransactionBuilder

CURRENCY = "USD"


@dataclass(frozen=True)
class CashCommandResult:
    committed: bool
    error: str | None = None


# Under the module's own wire name even when this file runs as __main__
# (``python -m``): the nodes' replies name it so, and a name taken from
# __main__ would leave the CLI unable to decode them.
register_class(CashCommandResult, name="tools.crosscash.CashCommandResult")


def _party_by_name(hub, name: str):
    for info in hub.network_map_cache.party_nodes:
        if info.legal_identity.name == name:
            return info.legal_identity
    raise FlowException(f"no party named {name!r} in the network map")


def _notary_of(hub):
    # The cache's notary_nodes predicate (service type is_sub_type_of
    # NOTARY_TYPE) — NOT "any advertised service", which would happily
    # pick an oracle as the notary.
    notary = hub.network_map_cache.get_any_notary()
    if notary is None:
        raise FlowException("no notary advertised in the network map")
    return notary


@register_flow(name="crosscash.CashCommandFlow")
class CashCommandFlow(FlowLogic):
    """RPC-startable: one CrossCash command on this node.

    kind "issue": self-issued cash paid straight to `recipient` (a node
    name). kind "pay": coin-select own vault cash, pay `recipient`.
    Both finalise through the notary and broadcast to participants, so
    recipient vaults converge via the data-vending resolve path.
    """

    def __init__(self, kind: str, quantity: int, recipient: str = "",
                 nonce: int = 0):
        self.kind = kind
        self.quantity = quantity
        self.recipient = recipient
        self.nonce = nonce

    def call(self):
        hub = self.service_hub
        me = hub.my_identity
        notary = _notary_of(hub)
        try:
            recipient = _party_by_name(hub, self.recipient)
            if self.kind == "issue":
                tx = Cash.generate_issue(
                    Amount(self.quantity, CURRENCY),
                    me.ref(self.nonce.to_bytes(4, "big")),
                    recipient.owning_key, notary, nonce=self.nonce)
            elif self.kind == "pay":
                tx = TransactionBuilder(notary=notary)
                # Soft-locked selection: concurrent pay commands on one
                # node reserve disjoint coins (the chaos harness runs
                # several at once against a shared vault).
                states = hub.vault_service.select_coins(
                    str(CURRENCY), self.quantity,
                    holder=self.run_id or b"crosscash")
                Cash.generate_spend(
                    tx, Amount(self.quantity, CURRENCY),
                    recipient.owning_key, states,
                    change_owner=me.owning_key)
            else:
                raise FlowException(f"unknown command kind {self.kind!r}")
        except Exception as e:
            return CashCommandResult(False, f"{type(e).__name__}: {e}")
        tx.sign_with(hub.legal_identity_key)
        stx = tx.to_signed_transaction(check_sufficient_signatures=False)
        try:
            yield from self.sub_flow(FinalityFlow(stx, (recipient,)))
        except Exception as e:
            return CashCommandResult(False, f"{type(e).__name__}: {e}")
        return CashCommandResult(True)


def install(node) -> None:
    """Cordapp hook — importing registers the flow + codec types."""


# ---------------------------------------------------------------------------
# Coordinator-side model + harness
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CrossCashCommand:
    kind: str  # issue | pay
    node: str  # executing node name
    quantity: int
    recipient: str
    nonce: int = 0

    def rpc_args(self) -> tuple:
        return (self.kind, self.quantity, self.recipient, self.nonce)


@dataclass
class CrossCashModel:
    """Predicted per-node cash totals (the simplified CrossCashState)."""

    balances: dict = field(default_factory=dict)

    def apply(self, cmd: CrossCashCommand) -> None:
        if cmd.kind == "issue":
            self.balances[cmd.recipient] = (
                self.balances.get(cmd.recipient, 0) + cmd.quantity)
        elif cmd.kind == "pay":
            if self.balances.get(cmd.node, 0) < cmd.quantity:
                raise ValueError(f"model generated unpayable command {cmd}")
            self.balances[cmd.node] -= cmd.quantity
            self.balances[cmd.recipient] = (
                self.balances.get(cmd.recipient, 0) + cmd.quantity)
        else:
            raise ValueError(cmd.kind)


def generate_wave(model: CrossCashModel, node_names: list[str],
                  rng: random.Random, size: int) -> list[CrossCashCommand]:
    """Seeded command generation against the model (CrossCashTest.kt's
    generate): issues always possible; pays only up to the predicted
    balance. One command per spender node per wave."""
    cmds: list[CrossCashCommand] = []
    nonce = rng.randrange(1 << 30)
    spenders = rng.sample(node_names, min(size, len(node_names)))
    for i, node in enumerate(spenders):
        balance = model.balances.get(node, 0)
        kind = rng.choice(["issue", "pay", "pay"]) if balance else "issue"
        recipient = rng.choice([n for n in node_names if n != node])
        if kind == "issue":
            cmds.append(CrossCashCommand(
                "issue", node, rng.randrange(100, 10_000), recipient,
                nonce + i))
        else:
            cmds.append(CrossCashCommand(
                "pay", node, rng.randrange(1, balance + 1), recipient))
    return cmds


def gather_balances(rpc) -> dict:
    """One node's vault over RPC -> {issuer_name: quantity} (diagnostic
    detail; convergence compares totals)."""
    out: dict = {}
    for sar in rpc.call("vault_snapshot"):
        state = sar.state.data
        if isinstance(state, CashState):
            issuer = state.amount.token.issuer.party.name
            out[issuer] = out.get(issuer, 0) + state.amount.quantity
    return out


def vaults_match(expected_totals: dict, gathered_by_issuer: dict) -> bool:
    """Per-node total equality (absent == zero)."""
    nodes = set(expected_totals) | set(gathered_by_issuer)
    for node in nodes:
        if expected_totals.get(node, 0) \
                != sum(gathered_by_issuer.get(node, {}).values()):
            return False
    return True


@dataclass
class CrossCashResult:
    waves: int
    commands_run: int
    commands_committed: int
    commands_rejected: int
    converged: bool
    disruptions: list
    expected: dict
    gathered: dict
    verify_tiers: dict = field(default_factory=dict)


CORDAPP = "corda_tpu_torch.tools.crosscash"


def verify_tiers(rpc) -> dict:
    """One process's verify batches by tier, its kernel backend, and the
    kernel launches it made after its boot warm, from its RPC
    ``node_metrics``."""
    m = rpc.call("node_metrics")
    boot = m["kernel_launches_at_boot"] or {}
    return {"batches": m["verify_batches"],
            "launches": {k: n - boot.get(k, 0) for k, n in
                         (m["kernel_launches"] or {}).items()},
            "device": m["verify_device_batches"] or 0,
            "host": m["verify_host_batches"] or 0,
            "degraded": m["verify_device_degraded"],
            "kernel_backend": m["kernel_backend"]}


def run_crosscash(
    n_waves: int = 4,
    wave_size: int = 3,
    clients: int = 3,
    notary: str = "raft",
    cluster_size: int = 3,
    seed: int = 7,
    disrupt: str | tuple | None = None,  # kill-follower | sigstop-follower
    # | strain-follower, or a tuple of them — one per successive wave
    disrupt_wave: int = 1,  # inject the first before this wave (0-based)
    base_dir: str | None = None,
    converge_timeout: float = 90.0,
    max_seconds: float = 600.0,
    device: str = "accelerator",  # every node process's placement: the
    # card ("accelerator", verifier "torch") or the host ("cpu")
    _drop_model_update: bool = False,  # fault-injection hook for tests: lose
    # one committed update from the model; convergence MUST then fail, which
    # proves the checker detects a lost-update/double-spend class divergence.
) -> CrossCashResult:
    """The generate → execute → gather-and-converge loop over real OS-process
    nodes (LoadTest.kt:39-144 + CrossCashTest), with fault injection."""
    from ..testing.driver import driver

    base = Path(base_dir or tempfile.mkdtemp(prefix="corda-tpu-xc-"))
    rng = random.Random(seed)
    model = CrossCashModel()
    disruptions: list[str] = []
    n_run = n_ok = n_rej = 0
    dropped = False
    deadline = time.monotonic() + max_seconds
    with driver(base) as d:
        members = []
        if notary.startswith("raft"):
            cluster = tuple(f"Raft{i}" for i in range(cluster_size))
            for name in cluster:
                members.append(d.start_node(
                    name, notary="raft-simple", raft_cluster=cluster,
                    cordapps=(CORDAPP,), rpc=True, device=device))
        else:
            members.append(d.start_node(
                "Notary", notary=notary, cordapps=(CORDAPP,), rpc=True,
                device=device))
        names = [f"Bank{i}" for i in range(clients)]
        rpcs = {}
        for name in names:
            handle = d.start_node(
                name, rpc=True, cordapps=(CORDAPP,), device=device)
            rpcs[name] = handle.rpc("demo", "s3cret", timeout=60.0)
            d.defer(rpcs[name].close)

        kinds = ((disrupt,) if isinstance(disrupt, str)
                 else tuple(disrupt or ()))
        schedule = {disrupt_wave + k: kind for k, kind in enumerate(kinds)}
        converged = True
        sigstopped_wave = None
        gathered: dict = {}
        for wave in range(n_waves):
            kind = schedule.get(wave)
            if kind and len(members) > 1:
                victim = members[1]
                if kind == "kill-follower":
                    victim.kill()
                    disruptions.append(f"SIGKILL {victim.name}")
                    members[1] = d.restart_node(victim)
                    disruptions.append(f"restarted {victim.name}")
                elif kind == "sigstop-follower":
                    victim.sigstop()
                    disruptions.append(f"SIGSTOP {victim.name}")
                    sigstopped_wave = wave
                elif kind == "strain-follower":
                    victim.strain(seconds=6.0, duty=0.8)
                    disruptions.append(
                        f"strain {victim.name} (80% duty-cycle hang)")
            cmds = generate_wave(model, names, rng, wave_size)
            flows = [(cmd, rpcs[cmd.node].call(
                "start_flow_dynamic", "crosscash.CashCommandFlow",
                cmd.rpc_args())) for cmd in cmds]
            for cmd, fh in flows:
                while time.monotonic() < deadline:
                    done, value = rpcs[cmd.node].call("flow_result", fh.run_id)
                    if done:
                        break
                    time.sleep(0.1)
                else:
                    raise TimeoutError(f"wave {wave} did not finish")
                n_run += 1
                if value.committed:
                    n_ok += 1
                    if _drop_model_update and not dropped \
                            and cmd.kind == "pay":
                        dropped = True  # injected lost-update
                    else:
                        model.apply(cmd)
                else:
                    n_rej += 1
            if sigstopped_wave == wave and len(members) > 1:
                members[1].sigcont()
                disruptions.append(f"SIGCONT {members[1].name}")
                sigstopped_wave = None
            # Converge BEFORE the next wave: the next wave's pays rely on
            # broadcast cash having landed in recipient vaults.
            converged = False
            poll_deadline = min(time.monotonic() + converge_timeout, deadline)
            while time.monotonic() < poll_deadline:
                gathered = {n: gather_balances(rpcs[n]) for n in names}
                if vaults_match(model.balances, gathered):
                    converged = True
                    break
                time.sleep(0.4)
            if not converged:
                break  # report the divergence; do not compound it
        tiers = {n: verify_tiers(rpcs[n]) for n in names}
        for member in members:
            rpc = member.rpc("demo", "s3cret", timeout=60.0)
            try:
                tiers[member.name] = verify_tiers(rpc)
            finally:
                rpc.close()
    return CrossCashResult(
        waves=n_waves, commands_run=n_run, commands_committed=n_ok,
        commands_rejected=n_rej, converged=converged,
        disruptions=disruptions,
        expected=dict(model.balances), gathered=gathered,
        verify_tiers=tiers)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="CrossCash: random cash traffic + convergence checking")
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--wave-size", type=int, default=3)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--notary", choices=("simple", "validating", "raft"),
                    default="raft")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--disrupt", action="append", default=None,
                    choices=("kill-follower", "sigstop-follower",
                             "strain-follower"),
                    help="repeatable; one disruption per successive wave")
    ap.add_argument("--device", choices=("accelerator", "cpu"),
                    default="accelerator",
                    help="every node process's placement: the card "
                         "(default) or the host")
    args = ap.parse_args(argv)
    result = run_crosscash(
        n_waves=args.waves, wave_size=args.wave_size, clients=args.clients,
        notary=args.notary, seed=args.seed,
        disrupt=tuple(args.disrupt) if args.disrupt else None,
        device=args.device)
    print(json.dumps(result.__dict__))
    return 0 if result.converged else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
