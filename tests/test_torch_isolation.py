"""corda_tpu_torch stands alone: no module of it, and not chip_smoke.py,
imports jax or anything of the JAX package corda_tpu.

The import check reads each file's AST and matches top-level module names
exactly, so ``corda_tpu_torch`` itself is not mistaken for ``corda_tpu``.
A fresh interpreter then imports the port, verifies a 64-lane batch on the
CPU through the device path's plain versions and through the host tier,
and must end with neither jax nor corda_tpu loaded.
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
