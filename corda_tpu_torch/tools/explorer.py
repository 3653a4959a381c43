"""Explorer: the operations dashboard, served as a web page over RPC.

Capability match for the reference's explorer tool (reference:
tools/explorer/src/main/kotlin/net/corda/explorer/Main.kt — a TornadoFX/
JavaFX GUI whose views are CashViewer, transaction viewer and network
identity lists, all fed by the client RPC observables via NodeMonitorModel,
client/src/main/kotlin/net/corda/client/model/NodeMonitorModel.kt).

TPU-framework form: the node side is identical (everything rides the RPC
surface: vault/network/state-machine snapshots plus the ``state_machine_
changes`` cursor stream), but the presentation tier is a dependency-free web
dashboard instead of a desktop JavaFX shell — an http.server endpoint that
renders one self-refreshing HTML page and exposes the same data as JSON
(``/api/dashboard``) for headless consumers. The JFX observable models
(ContractStateModel's cash rollup, GatheredTransactionDataModel's tx list,
NodeMonitorModel's flow progress feed) map to the ``gather()`` aggregation
below: cash balances grouped by currency, recent transactions, in-flight
flows with progress, node metrics.

The port's own copy of ``corda_tpu/tools/explorer.py``. The demo's
in-process node (``--demo``) runs on the card: ``_run_demo`` takes its
verifier as an argument, ``"torch"`` unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto.hashes import SecureHash
from ..crypto.party import Party
from ..node.rpc import RpcClient


def render_value(obj, depth: int = 0):
    """Recursively turn ledger objects into plain JSON-able structures.
    The explorer displays *everything* the RPC surface returns, so this is
    deliberately generic: dataclasses become tagged dicts, keys/hashes render
    as short strings, and depth is capped against adversarial nesting."""
    if depth > 12:
        return "…"
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return obj.hex() if len(obj) <= 64 else f"{len(obj)} bytes"
    if isinstance(obj, SecureHash):
        return obj.prefix_chars(12)
    if isinstance(obj, Party):
        return str(obj.name)
    from ..transactions.signed import SignedTransaction

    if isinstance(obj, SignedTransaction):
        # Render the deserialized wire transaction, not the opaque tx_bits
        # (the GUI explorer's transaction viewer shows components).
        return {"_type": "SignedTransaction",
                "id": render_value(obj.id, depth + 1),
                "tx": render_value(obj.tx, depth + 1),
                "sigs": render_value(obj.sigs, depth + 1)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"_type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = render_value(getattr(obj, f.name), depth + 1)
        return out
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = [render_value(x, depth + 1) for x in obj]
        if isinstance(obj, (set, frozenset)):
            items.sort(key=json.dumps)
        return items
    if isinstance(obj, dict):
        return {str(k): render_value(v, depth + 1) for k, v in obj.items()}
    to_render = getattr(obj, "__dict__", None)
    if to_render is not None:
        return {"_type": type(obj).__name__,
                **{k: render_value(v, depth + 1)
                   for k, v in to_render.items() if not k.startswith("_")}}
    return repr(obj)


def cash_balances(vault_states) -> dict[str, int]:
    """ContractStateModel.kt's cash rollup: sum CashState quantities per
    currency code across the unconsumed set."""
    from ..finance import CashState

    balances: dict[str, int] = {}
    for sref in vault_states:
        data = getattr(getattr(sref, "state", sref), "data", None)
        if isinstance(data, CashState):
            currency = data.amount.token.product
            balances[str(currency)] = (
                balances.get(str(currency), 0) + data.amount.quantity)
    return balances


class ExplorerModel:
    """The data-gathering half (NodeMonitorModel.kt capability): aggregates
    every RPC feed into one dashboard snapshot, tracking the state-machine
    change cursor across polls so flow history accumulates client-side."""

    MAX_TX, MAX_EVENTS = 50, 200

    # Renew the push subscription well inside the server's 120 s TTL.
    RESUBSCRIBE_S = 30.0

    def __init__(self, rpc: RpcClient):
        self.rpc = rpc
        self._cursor = 0
        self._events: list = []
        # Flow events arrive as SERVER-PUSHED frames (RpcClient.
        # subscribe_changes): the node streams its change feed to us and
        # _on_pushed accumulates it; gather() only drains the transport.
        # The subscription id is sticky, so a reconnect resumes from the
        # last pushed cursor without loss.
        self._subscription_id: bytes | None = None
        self._subscribed_at = 0.0
        # Transactions are immutable and content-addressed: fetch each hash
        # over RPC once, ever, instead of ~MAX_TX round trips per poll.
        self._tx_cache: dict = {}
        # tx id (short hex) -> producing flow run ids; seeded once from the
        # RPC snapshot, then maintained from pushed tx_recorded events.
        self._provenance: dict = {}
        self._provenance_seeded = False
        self._provenance_gaps = 0

    def _on_pushed(self, events: tuple, cursor: int) -> None:
        self._events.extend(events)
        self._cursor = cursor
        del self._events[:-self.MAX_EVENTS]
        # Provenance is maintained INCREMENTALLY from the pushed
        # ("tx_recorded", run_id, tx_id) events: the tx_mappings log is
        # append-only and unbounded, so re-polling the full snapshot every
        # refresh would grow without limit (one snapshot seeds the view;
        # push keeps it current; a detected push gap triggers re-seed).
        for ev in events:
            if ev and ev[0] == "tx_recorded":
                self._add_provenance(bytes(ev[1]), bytes(ev[2]))

    def _add_provenance(self, run_id: bytes, tx_id: bytes) -> None:
        runs = self._provenance.setdefault(tx_id.hex()[:16], [])
        short = run_id.hex()[:8]
        if short not in runs:
            runs.append(short)
        while len(self._provenance) > 4 * self.MAX_TX:  # bound the view
            self._provenance.pop(next(iter(self._provenance)))

    def _ensure_subscribed(self) -> None:
        import time as _time

        now = _time.monotonic()
        if now - self._subscribed_at < self.RESUBSCRIBE_S:
            return
        self._subscription_id = self.rpc.subscribe_changes(
            self._on_pushed, subscription_id=self._subscription_id,
            cursor=self._cursor)
        self._subscribed_at = now

    MAX_VAULT_PAGES = 64  # dashboard view bound: 64 pages × 256 states

    def _gather_vault(self, rpc) -> tuple:
        """The unconsumed set via keyset-paginated vault_page calls —
        bounded frames instead of one vault_snapshot that grows with the
        ledger (and a page cap: a dashboard never needs a million rows)."""
        states: list = []
        cursor = (None, 0)
        for _ in range(self.MAX_VAULT_PAGES):
            page, cursor = rpc.call(
                "vault_page", cursor[0], cursor[1], 256)
            states.extend(page)
            if cursor is None:
                break
        return tuple(states)

    def gather(self) -> dict:
        rpc = self.rpc
        self._ensure_subscribed()
        identity = rpc.call("node_identity")
        network = rpc.call("network_map_snapshot")
        vault = self._gather_vault(rpc)
        balances = rpc.call("vault_balances")
        in_flight = rpc.call("state_machines_snapshot")
        metrics = rpc.call("node_metrics")
        rpc.poll_push()  # drain any pushed frames not seen during calls

        # Flow→tx provenance join (reference: the explorer's transaction
        # view joins flows to transactions through StateMachineRecorded
        # TransactionMappingStorage): one full RPC snapshot seeds the
        # view, then the pushed ("tx_recorded", ...) events keep it
        # current (_on_pushed); a detected push gap re-seeds so evicted
        # events cannot leave the join silently stale.
        gaps = sum(rpc.push_gaps.values())
        if not self._provenance_seeded or gaps != self._provenance_gaps:
            for m in rpc.call("state_machine_recorded_transaction_mapping"):
                self._add_provenance(m.run_id, m.tx_id.bytes)
            self._provenance_seeded = True
            self._provenance_gaps = gaps

        transactions = []
        seen = set()
        for sref in vault:
            ref = getattr(sref, "ref", None)
            txhash = getattr(ref, "txhash", None)
            if txhash is None or txhash in seen:
                continue
            seen.add(txhash)
            stx = self._tx_cache.get(txhash)
            if stx is None:  # never cache a miss: the tx may land later
                stx = rpc.call("verified_transaction", txhash)
                if stx is not None:
                    self._tx_cache[txhash] = stx
            if stx is not None:
                transactions.append(stx)
            if len(transactions) >= self.MAX_TX:
                break
        # Bound the cache to hashes still referenced by the vault (the full
        # snapshot, not just the prefix visited before the MAX_TX break).
        if len(self._tx_cache) > 4 * self.MAX_TX:
            live = {getattr(getattr(s, "ref", None), "txhash", None)
                    for s in vault}
            self._tx_cache = {h: s for h, s in self._tx_cache.items()
                              if h in live}

        return {
            "identity": render_value(identity),
            "network": render_value(network),
            "balances": {str(c): int(q) for c, q in balances.items()},
            "vault": render_value(vault),
            "transactions": render_value(transactions),
            "tx_provenance": dict(self._provenance),
            "flows_in_flight": render_value(in_flight),
            "flow_events": render_value(self._events),
            "metrics": render_value(metrics),
        }


_PAGE = """<!DOCTYPE html>
<html><head><title>corda_tpu_torch explorer</title><style>
 body { font-family: system-ui, sans-serif; margin: 2em; color: #222; }
 h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.4em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #ccc; padding: 4px 10px; font-size: 0.85em;
          text-align: left; vertical-align: top; }
 pre { background: #f6f6f6; padding: 8px; font-size: 0.8em;
       max-height: 22em; overflow: auto; }
 .muted { color: #777; }
</style></head><body>
<h1>corda_tpu_torch explorer <span class="muted" id="who"></span></h1>
<h2>Cash balances</h2><table id="balances"></table>
<h2>Network</h2><table id="network"></table>
<h2>Flows in flight</h2><pre id="flows"></pre>
<h2>Recent flow events</h2><pre id="events"></pre>
<h2>Vault (unconsumed states)</h2><pre id="vault"></pre>
<h2>Recent transactions</h2><pre id="txs"></pre>
<h2>Transaction provenance <span class="muted">(tx id &rarr; producing flow
run ids)</span></h2><table id="provenance"></table>
<h2>Node metrics</h2><table id="metrics"></table>
<script>
function rows(el, pairs) {
  // Ledger data (party names, currency codes) is attacker-influenced:
  // build DOM nodes so it can never execute as HTML.
  el.replaceChildren(...pairs.map(p => {
    const tr = document.createElement("tr");
    const th = document.createElement("th");
    const td = document.createElement("td");
    th.textContent = String(p[0]);
    td.textContent = String(p[1]);
    tr.append(th, td);
    return tr;
  }));
}
async function refresh() {
  const r = await fetch("/api/dashboard");
  if (!r.ok) return;
  const d = await r.json();
  document.getElementById("who").textContent = "— " + d.identity;
  rows(document.getElementById("balances"), Object.entries(d.balances));
  rows(document.getElementById("network"),
       d.network.map(n => [n.legal_identity ?? JSON.stringify(n),
                           JSON.stringify(n.address)]));
  rows(document.getElementById("metrics"), Object.entries(d.metrics));
  document.getElementById("flows").textContent =
      JSON.stringify(d.flows_in_flight, null, 1);
  document.getElementById("events").textContent =
      JSON.stringify(d.flow_events.slice(-40), null, 1);
  document.getElementById("vault").textContent =
      JSON.stringify(d.vault, null, 1);
  document.getElementById("txs").textContent =
      JSON.stringify(d.transactions, null, 1);
  rows(document.getElementById("provenance"),
       Object.entries(d.tx_provenance).map(p => [p[0], p[1].join(", ")]));
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


class ExplorerServer:
    """HTTP shell around ExplorerModel (the Main.kt/TornadoFX equivalent)."""

    def __init__(self, rpc: RpcClient, host: str = "127.0.0.1",
                 port: int = 0):
        self.model = ExplorerModel(rpc)
        model = self.model
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                try:
                    if self.path == "/":
                        body, ctype = _PAGE.encode(), "text/html"
                    elif self.path == "/api/dashboard":
                        with lock:  # one RPC conversation at a time
                            body = json.dumps(model.gather()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # pragma: no cover - network races
                    try:
                        self.send_error(500, str(e)[:200])
                    # lint: allow(no-silent-except) demo HTTP tooling: the client already vanished mid-error-reply; nothing to count or degrade
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)


class DemoTraffic:
    """Random-but-valid cash activity against an in-process node — the
    reference explorer's simulated-node mode (explorer Main.kt `-S` flag +
    client/mock EventGenerator): issues and moves drawn from the generator
    monad keep the dashboard alive without a real network."""

    def __init__(self, node, period: float = 0.7, seed: int = 42):
        import random

        from ..finance.cash import Cash
        from ..testing.generators import (
            ExitEvent, IssueEvent, MoveEvent, cash_event_generator)

        self.node = node
        self.period = period
        self._stop = threading.Event()
        self._rng = random.Random(seed)
        keys = node.services.key_management_service
        owners = [node.identity.owning_key] + [
            keys.fresh_key().public.composite for _ in range(3)]

        def issued() -> int:
            # O(#currencies) aggregate instead of a per-tick vault scan.
            return sum(node.services.vault_service.balances().values())

        self._gen = cash_event_generator(owners, issued)
        self._cash = Cash
        self._issue_cls = IssueEvent
        self._move_cls = MoveEvent
        self._exit_cls = ExitEvent
        self._nonce = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self._tick()
            # lint: allow(no-silent-except) demo traffic generator: a failed tick is retried next period; this never runs on a production path
            except Exception:
                pass  # demo traffic is best-effort

    def _tick(self) -> None:
        from ..finance import CashState
        from ..transactions.builder import TransactionBuilder

        node = self.node
        event = self._gen.generate(self._rng)
        if isinstance(event, self._issue_cls):
            self._nonce += 1
            builder = self._cash.generate_issue(
                event.amount, node.identity.ref(bytes([self._nonce % 256])),
                event.owner, node.identity, nonce=self._nonce)
            builder.sign_with(node.key)
            node.services.record_transactions([builder.to_signed_transaction()])
        elif isinstance(event, (self._move_cls, self._exit_cls)):
            builder = TransactionBuilder(notary=node.identity)
            if isinstance(event, self._move_cls):
                # Indexed soft-locked selection instead of a vault scan.
                states = node.services.vault_service.select_coins(
                    str(event.amount.token), event.amount.quantity,
                    holder=b"explorer-demo")
                if not states:
                    return
                signers = self._cash.generate_spend(
                    builder, event.amount, event.new_owner, states)
            else:
                states = node.services.vault_service.unconsumed_states(
                    CashState)
                if not states:
                    return
                # Exit burns an exact issued token: pick one and clamp.
                from ..finance import Amount

                token = states[0].state.data.amount.token
                avail = sum(s.state.data.amount.quantity for s in states
                            if s.state.data.amount.token == token)
                qty = min(event.amount.quantity, avail)
                signers = self._cash.generate_exit(
                    builder, Amount(qty, token), states)
            keys = node.services.key_management_service
            for key in signers:
                for pub in key.keys:
                    kp = keys.keys.get(pub)
                    if kp is not None:
                        builder.sign_with(kp)
                        break
            node.services.record_transactions(
                [builder.to_signed_transaction(
                    check_sufficient_signatures=False)])

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def _run_demo(listen: int, verifier: str = "torch"):
    """An in-process node + generated traffic + dashboard (Main.kt -S); the
    node verifies with ``verifier`` (the card by default)."""
    import tempfile
    from pathlib import Path

    from ..node.config import NodeConfig
    from ..node.node import Node

    tmp = Path(tempfile.mkdtemp(prefix="corda-tpu-explorer-demo-"))
    node = Node(NodeConfig(
        name="DemoBank", base_dir=tmp / "DemoBank",
        network_map=tmp / "netmap.json", verifier=verifier,
        rpc_users=({"username": "demo", "password": "demo",
                    "permissions": ["ALL"]},))).start()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            node.run_once(timeout=0.02)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    traffic = DemoTraffic(node)
    rpc = RpcClient(node.messaging.my_address, "demo", "demo")
    server = ExplorerServer(rpc, port=listen)

    def cleanup():
        import shutil

        traffic.stop()
        server.stop()
        rpc.close()
        stop.set()
        pumper.join(timeout=2)  # never tear the node down under run_once
        node.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    return server, cleanup


def main(argv=None) -> None:
    from ..node.messaging.tcp import TcpAddress

    parser = argparse.ArgumentParser(
        description="Web explorer for a running corda_tpu_torch node")
    parser.add_argument("node", nargs="?",
                        help="node RPC address, host:port")
    parser.add_argument("user", nargs="?")
    parser.add_argument("password", nargs="?")
    parser.add_argument("--listen", type=int, default=8880,
                        help="dashboard port (default 8880)")
    parser.add_argument("--demo", action="store_true",
                        help="spin up an in-process node with generated "
                             "cash traffic (the reference explorer's "
                             "simulation mode)")
    args = parser.parse_args(argv)
    if args.demo:
        server, cleanup = _run_demo(args.listen)
    elif args.node and args.user and args.password:
        host, _, port = args.node.partition(":")
        rpc = RpcClient(TcpAddress(host, int(port)), args.user, args.password)
        server = ExplorerServer(rpc, port=args.listen)

        def cleanup():
            server.stop()
            rpc.close()
    else:
        parser.error("either --demo or node/user/password are required")
    print(f"explorer on http://{server.address[0]}:{server.address[1]}/")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        cleanup()


if __name__ == "__main__":
    main()
