"""corda_tpu_torch stands alone: no module of it, and not chip_smoke.py,
imports jax or anything of the JAX package corda_tpu.

The import check reads each file's AST and matches top-level module names
exactly, so ``corda_tpu_torch`` itself is not mistaken for ``corda_tpu``.
A fresh interpreter then imports the port, verifies a 64-lane batch on the
CPU through the device path's plain versions and through the host tier,
primes the ids of a small transaction wave through the SHA-256 kernel's
plain version, notarises through the port's MockNetwork with both notary
kinds, through three port ``Node``s over localhost TCP and sqlite, and
through a raft-simple cluster of three port ``Node``s, trades papers for
cash over the MockNetwork and over three port ``Node``s on the indexed
vault, changes two states' notary, agrees a SIMM portfolio valuation
through the rate oracle, issues, fixes and settles an interest-rate swap,
notarises 3-of-3 board moves, builds a node's TLS material from the dev
CA, verifies a clause contract loaded from an attachment (which names the
platform as ``corda_tpu.<x>``) under the deterministic sandbox, and
verifies a batch through a two-host federation of the port's sidecar
processes, imports the load harness, the perf doctor and the autotuner,
and must end with neither jax nor corda_tpu loaded.

A module's name can also reach an import as a string: a node imports each
of its ``cordapps`` with ``importlib.import_module``, and the autotuner's
validator imports the module an env knob names. No string constant in the
port names a module under ``corda_tpu.``; the port's CLIs leave the
reference's ``artifacts/TRAJECTORY.jsonl`` byte-unchanged.
"""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "corda_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "corda_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_corda_tpu_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


# The notary path's modules, the node slice's and the raft slice's (each a
# copy of the JAX package's module of the same path, or a cut of it): all
# are among the files checked above.
NOTARY_PATH_MODULES = [
    "utils/clock.py", "utils/progress.py", "qos/__init__.py",
    "qos/context.py", "qos/admission.py", "qos/calibrate.py",
    "transactions/ledger.py", "transactions/filtered.py",
    "transactions/graph_search.py", "flows/__init__.py", "flows/api.py",
    "flows/fetch.py", "flows/data_vending.py", "flows/resolve.py",
    "flows/notary.py", "flows/finality.py", "node/messaging/__init__.py",
    "node/messaging/api.py", "node/messaging/inmem.py",
    "node/services/__init__.py", "node/services/api.py",
    "node/services/inmemory.py", "node/services/notary.py",
    "node/services/raft.py", "node/services/sharding.py",
    "node/statemachine.py", "testing/mock_network.py", "testing/faults.py",
    "testing/notary_load.py",
    "native/__init__.py", "node/__init__.py", "node/node.py",
    "node/config.py", "node/rpc.py", "node/messaging/tcp.py",
    "node/services/integrity.py", "node/services/persistence.py",
    "node/services/schema.py", "node/services/scheduler.py",
    "node/services/vault_observers.py", "contracts/dsl.py",
    "finance/__init__.py", "finance/amount.py", "finance/on_ledger_asset.py",
    "finance/cash.py", "tools/__init__.py", "tools/fsck.py",
    "tools/demo_cordapp.py", "testing/driver.py",
    # The raft slice: the whole raft.py and sharding.py (listed above), the
    # Node's raft wiring (node/node.py), the driver's shard clusters and
    # the builtin fault plans (testing/faults.py).
    # The vault and trader-demo slice: the indexed vault, the wire map, the
    # web API, the trade flows and contracts, the notary change and the
    # test DSL the contracts' tests use.
    "node/services/vault.py", "node/services/netmap_service.py",
    "node/webserver.py", "finance/commercial_paper.py", "finance/trade.py",
    "finance/commodity.py", "flows/state_replacement.py",
    "testing/identities.py", "testing/ledger_dsl.py",
    # BASELINE configs 5 and 4: the rate types, the oracle, deals, the
    # universal contract, fixable deals, the IRS, the SIMM model and the
    # portfolio agreement, and the workloads the chip phases run.
    "finance/types.py", "flows/oracle.py", "flows/deal.py",
    "contracts/universal.py", "finance/fixable_deal.py", "finance/irs.py",
    "tools/simm.py", "tools/portfolio.py", "testing/simm_load.py",
    "testing/multisig_load.py",
    # Mutual TLS with the doorman, contracts from attachments under the
    # sandbox, and the multi-device verify plane.
    "crypto/x509.py", "crypto/certsigning.py", "contracts/clauses.py",
    "contracts/sandbox.py", "contracts/attachments_loader.py",
    "testing/contract_load.py", "ops/sharded.py", "crypto/federation.py",
    "crypto/sidecar.py", "crypto/provider.py", "crypto/async_verify.py",
    "node/verify_client.py",
    # The load, diagnosis and tuning plane.
    "obs/stages.py", "obs/collect.py", "obs/doctor.py", "tools/ingest.py",
    "tools/loadgen.py", "tools/loadtest.py", "tools/perfdoctor.py",
    "tools/autotune.py", "autotune/__init__.py", "autotune/space.py",
    "autotune/runtime.py", "autotune/controller.py", "testing/history.py",
    # The last modules: the analyzer, Obligation, the generators, the
    # expect DSL and the simulation, CrossCash, the explorer, the
    # visualiser, the card watcher, the small utilities, and the chip
    # phase's obligation workload.
    "analysis/__init__.py", "analysis/__main__.py", "analysis/engine.py",
    "analysis/rules.py", "finance/obligation.py", "testing/generators.py",
    "testing/expect.py", "testing/simulation.py",
    "testing/obligation_load.py", "tools/crosscash.py",
    "tools/explorer.py", "tools/visualiser.py", "tools/tunnel_watch.py",
    "utils/collections.py", "utils/interpolators.py",
    "utils/progress_render.py", "utils/service_identity.py",
]


@pytest.mark.parametrize("rel", NOTARY_PATH_MODULES)
def test_notary_path_module_is_checked(rel):
    path = os.path.join(REPO, "corda_tpu_torch", rel)
    assert path in _port_files()
    assert not _imported_roots(path) & FORBIDDEN


def test_root_matching_is_exact():
    assert "corda_tpu_torch" not in FORBIDDEN
    assert _imported_roots(os.path.join(REPO, "chip_smoke.py")) >= {
        "corda_tpu_torch", "torch", "numpy"}


# A module path under the JAX package, as a string: "corda_tpu.x" (the
# port's own "corda_tpu_torch.x" does not match).
_REFERENCE_MODULE = re.compile(r"(?<![\w/])corda_tpu\.[A-Za-z_]")


def _string_constants(path):
    """(line, value) of every str constant of a file that is not a
    docstring."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                docs.add(id(first.value))
    return [(n.lineno, n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_string_names_a_jax_package_module(path):
    """A cordapp name or a knob's module given as "corda_tpu.<x>" would
    load the JAX package, and jax, into a port process by import_module;
    the import check above cannot see a string."""
    bad = [(line, v) for line, v in _string_constants(path)
           if _REFERENCE_MODULE.search(v)]
    assert not bad, bad


def _cordapp_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "cordapps":
            names += [c.value for c in ast.walk(node.value)
                      if isinstance(c, ast.Constant)]
    return names


def test_harness_cordapps_are_the_ports():
    names = _cordapp_names(os.path.join(REPO, "corda_tpu_torch", "tools",
                                        "loadtest.py"))
    assert set(names) == {"corda_tpu_torch.testing.dummies",
                          "corda_tpu_torch.tools.loadgen"}
    from corda_tpu_torch.autotune import space

    for knob in space.KNOBS.values():
        if knob.target.startswith("env:"):
            assert knob.target.split(":")[2].startswith("corda_tpu_torch.")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_port_clis_leave_the_reference_trajectory_unchanged(tmp_path):
    store = os.path.join(REPO, "artifacts", "TRAJECTORY.jsonl")
    before = _sha256(store)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CORDA_TPU_TRAJECTORY", None)
    verdict = tmp_path / "verdict.json"
    runs = [
        ["corda_tpu_torch.tools.perfdoctor",
         os.path.join("artifacts", "BENCH_r05_local_e.json")],
        ["corda_tpu_torch.tools.perfdoctor", "--gate"],
        ["corda_tpu_torch.tools.perfdoctor", "--backfill", "artifacts",
         "--trajectory", str(tmp_path / "T.jsonl")],
        ["corda_tpu_torch.tools.autotune", "--validate"],
        ["corda_tpu_torch.tools.autotune",
         os.path.join("artifacts", "INGEST_r15_local.json"), "--mock",
         "monotone", "--budget", "2", "--seed", "3",
         "--trajectory", str(tmp_path / "T.jsonl"),
         "--out", str(verdict)],
    ]
    for argv in runs:
        proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                              cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, (argv, proc.stderr[-2000:])
    assert _sha256(store) == before
    assert json.loads(verdict.read_text())["decision_sequence"]


_PROBE = r"""
import sys
import numpy as np
from corda_tpu_torch.crypto import sidecar
assert "torch" not in sys.modules, "importing the codec pulled in torch"
from corda_tpu_torch.crypto import provider, ref_ed25519 as ref
jobs = []
for i in range(64):
    seed = bytes([i + 1]) * 32
    msg = bytes([i]) * 32
    sig = ref.sign(seed, msg)
    if i % 5 == 0:
        sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    jobs.append(provider.VerifyJob(ref.public_key(seed), msg, sig))
want = [i % 5 != 0 for i in range(64)]
got = provider.TorchVerifier(device="cpu", device_min_sigs=0).verify_batch(jobs)
assert got.tolist() == want, got
assert provider.CpuVerifier().verify_batch(jobs).tolist() == want
# A small resolve wave: build, serialize, prime the ids from fresh copies.
from corda_tpu_torch.crypto.keys import KeyPair
from corda_tpu_torch.crypto.party import Party
from corda_tpu_torch.serialization.codec import deserialize, serialize
from corda_tpu_torch.testing.dummies import DummyContract
from corda_tpu_torch.transactions.signed import SignedTransaction
key = KeyPair.generate(b"\x62" * 32)
notary = Party.of("N", KeyPair.generate(b"\x61" * 32).public)
party = Party.of("P", key.public)
stxs = []
for i in range(3):
    b = DummyContract.generate_initial(party.ref(bytes([i])), i, notary)
    stxs.append(b.sign_with(key).to_signed_transaction())
wave = [deserialize(serialize(s).bytes) for s in stxs]
assert SignedTransaction.prime_ids(wave, device_min=0, device="cpu") == "device"
assert [s.tx.id for s in wave] == [s.id for s in stxs]
# Notarise through the port's MockNetwork, both notary kinds.
from corda_tpu_torch.testing import notary_load as nl
api = nl.port_api()
for validating in (False, True):
    net, n, a, b = nl.make_network(api, provider.CpuVerifier(), validating)
    work = nl.build_workload(api, n, a, b, 4, 1, 1, 3)
    res = nl.run_workload(api, net, n, a, b, work)
    kinds = [o[:1] if o[0] == "ok" else o for o in res["outcomes"]]
    assert kinds == nl.expected_outcomes(work), kinds
    assert res["committed_count"] == res["notarised"] == 3
    net.stop_nodes()
# One notarisation through port Nodes over localhost TCP and sqlite.
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    n, a, b = nl.make_tcp_nodes(api, tmp, "cpu", validating=False)
    try:
        work = nl.build_workload(api, n, a, b, 2, 0, 1, 3)
        res = nl.run_tcp_workload(api, n, a, b, work, timeout_s=60.0)
        assert [o[0] for o in res["outcomes"]] == ["ok", "ok",
                                                   "NotaryException"], res
        assert res["committed_count"] == 2
    finally:
        for node in (n, a, b):
            node.stop()
# One notarisation through a raft-simple cluster of three port Nodes.
with tempfile.TemporaryDirectory() as tmp:
    members, a, b = nl.make_raft_nodes(api, tmp, "cpu", validating=False)
    try:
        work = nl.build_workload(api, members[0], a, b, 2, 0, 1, 3)
        res = nl.run_raft_workload(api, members, a, b, work, timeout_s=60.0)
        assert [o[0] for o in res["outcomes"]] == ["ok", "ok",
                                                   "NotaryException"], res
        assert all(len(c) == 2 for c in res["members_committed"].values())
    finally:
        for node in (*members, a, b):
            node.stop()
# The trader demo over the MockNetwork and over three port Nodes on the
# indexed vault (web API, wire map, ballast in the buyer's vault), and a
# notary change.
from corda_tpu_torch.contracts.structures import now_micros
net, n, a, b = nl.make_trade_network(api, provider.CpuVerifier())
trades = nl.build_trades(api, n, a, b, 2, 3, now_micros())
res = nl.run_mock_trades(api, net, n, a, b, trades, 2)
assert res["settled"] == 2 and res["committed"] == res["trade_inputs"], res
net.stop_nodes()
with tempfile.TemporaryDirectory() as tmp:
    nl.seed_ballast(api, tmp + "/ballast.db", 10)
    nodes = nl.make_trade_nodes(api, tmp + "/run", "cpu", tmp + "/ballast.db")
    try:
        trades = nl.build_trades(api, *nodes, 2, 3, now_micros())
        res = nl.run_tcp_trades(api, *nodes, trades, 2, timeout_s=60.0)
        assert res["settled"] == 2, res["outcomes"]
        assert res["vaults"]["BankA"]["papers"] == 2
    finally:
        for node in nodes:
            node.stop()
res = nl.run_notary_change(api, provider.CpuVerifier(), 2, 3)
assert [o[0] for o in res["outcomes"]] == ["ok", "ok"], res["outcomes"]
# BASELINE config 5: a tear-off proof, a portfolio agreed through the
# oracle, a swap issued, fixed and settled; config 4: board moves.
from corda_tpu_torch.testing import multisig_load as ml, simm_load as sl
sapi = sl.port_api()
wtx, ftx = sl.tear_off(sapi)
assert ftx.verify(wtx.id)
net, *snodes = sl.make_simm_network(sapi, provider.CpuVerifier())
res = sl.run_valuations(sapi, net, snodes,
                        sl.build_portfolios(sapi, *snodes, 1, 10))
assert [o[1][1] for o in res["outcomes"]] == res["expected"], res
net.stop_nodes()
net, *snodes = sl.make_irs_network(sapi, provider.CpuVerifier(), 1)
res = sl.run_swaps(sapi, net, snodes, sl.build_swaps(sapi, *snodes, 1))
assert sl.check_swaps(sapi, res, 1) == [], res
net.stop_nodes()
mapi = ml.port_api()
net, mn, mt = ml.make_move_network(mapi, provider.CpuVerifier())
res = ml.run_moves(mapi, net, mn, mt, *ml.build_moves(mapi, mn, mt, 8, 3))
assert [o[0] for o in res["outcomes"]] == ["ok"] * 7 + ["NotaryException"]
net.stop_nodes()
# TLS material from the dev CA; an attachment's clause contract under the
# sandbox; a batch through a two-host federation of port sidecars.
from corda_tpu_torch.crypto import x509
from corda_tpu_torch.contracts.sandbox import DeterministicSandbox
from corda_tpu_torch.testing import contract_load as cl
with tempfile.TemporaryDirectory() as tmp:
    paths = x509.generate_dev_tls_material(tmp + "/Alice", tmp, "Alice")
    assert all(p.exists() for p in paths.values())
net, n, a, b = nl.make_network(api, provider.CpuVerifier(), False)
views = cl.contract_views(nl.build_workload(api, n, a, b, 12, 1, 1, 3))
net.stop_nodes()
contract = cl.load_clause_contract()
assert cl.verdicts(contract, views, DeterministicSandbox()) == \
    cl.verdicts(contract, views)
from corda_tpu_torch.crypto.federation import FederatedVerifier
from corda_tpu_torch.testing.driver import driver
with tempfile.TemporaryDirectory() as tmp:
    with driver(tmp) as d:
        hosts = d.start_federation(2, verifier="cpu", device="cpu",
                                   coalesce_us=0)
        fed = FederatedVerifier([h.address for h in hosts],
                                deadline_ms=20_000.0, device_min_sigs=0)
        assert fed.verify_batch(jobs).tolist() == want
        assert fed.device_batches == 1 and fed.fallbacks == 0
from corda_tpu_torch.tools import autotune, loadtest, perfdoctor
from corda_tpu_torch.autotune import space
assert space.validate_registry() == []
assert loadtest.run_loadtest(n_tx=2, notary="validating",
                             verifier="cpu").tx_committed == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "corda_tpu"))
assert not bad, bad
print("isolated-ok")
"""


def test_port_runs_without_jax_in_a_fresh_interpreter():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("isolated-ok")
