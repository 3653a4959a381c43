"""corda_tpu_torch stands alone: no module of it, and not chip_smoke.py,
imports jax or anything of the JAX package corda_tpu.

The import check reads each file's AST and matches top-level module names
exactly, so ``corda_tpu_torch`` itself is not mistaken for ``corda_tpu``.
A fresh interpreter then imports the port, verifies a 64-lane batch on the
CPU through the device path's plain versions and through the host tier,
primes the ids of a small transaction wave through the SHA-256 kernel's
plain version, notarises through the port's MockNetwork with both notary
kinds, through three port ``Node``s over localhost TCP and sqlite, and
through a raft-simple cluster of three port ``Node``s, and must end with
neither jax nor corda_tpu loaded.
"""

import ast
import os
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
