"""The port's attachment loader (corda_tpu_torch/contracts/
attachments_loader.py) against the JAX package's: the mirror of
tests/test_attachments_loader.py, every case run on both packages with the
same verdict and reason; then one attachment zip, with one hash, loaded
and verified in both packages (attachment code names the platform as
``corda_tpu.<x>``, which the port resolves to its own module without ever
importing ``corda_tpu``), and phase 26 (b)'s clause contract
(corda_tpu_torch/testing/contract_load.py) sandboxed against direct."""

import importlib
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from corda_tpu_torch.testing import contract_load as cl

PKGS = ("corda_tpu", "corda_tpu_torch")
_NS: dict = {}


def ns(pkg) -> SimpleNamespace:
    if pkg not in _NS:
        m = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa
        loader_mod = m("contracts.attachments_loader")
        SecureHash = m("crypto.hashes").SecureHash

        class BlobAttachment(m("contracts.structures").Attachment):
            def __init__(self, data: bytes):
                self._data = data

            @property
            def id(self):
                return SecureHash.sha256(self._data)

            def open(self) -> bytes:
                return self._data

        _NS[pkg] = SimpleNamespace(
            Loader=loader_mod.AttachmentsModuleLoader,
            OverlappingAttachments=loader_mod.OverlappingAttachments,
            make_attachment_zip=loader_mod.make_attachment_zip,
            SandboxViolation=m("contracts.sandbox").SandboxViolation,
            SandboxCostExceeded=m("contracts.sandbox").SandboxCostExceeded,
            DeterministicSandbox=m("contracts.sandbox").DeterministicSandbox,
            CostBudget=m("contracts.sandbox").CostBudget,
            TransactionForContract=m(
                "contracts.verification").TransactionForContract,
            DummySingleOwnerState=m("testing.dummies").DummySingleOwnerState,
            SecureHash=SecureHash, BlobAttachment=BlobAttachment)
    return _NS[pkg]


GOOD_CONTRACT = b"""
from dataclasses import dataclass

from corda_tpu.contracts.structures import Contract, ContractState
from corda_tpu.contracts.dsl import require_that
from helpers import MAGIC

class ShippedContract(Contract):
    def verify(self, tx):
        with require_that() as req:
            req("exactly one output", len(tx.outputs) == 1)
            req("magic matches", MAGIC == 42)
"""

HELPERS = b"MAGIC = 42\n"


def loader_for(p, files, extra=()):
    blobs = [p.BlobAttachment(p.make_attachment_zip(files))]
    for f in extra:
        blobs.append(p.BlobAttachment(p.make_attachment_zip(f)))
    return p.Loader(blobs)


CASES: dict = {}


def case(want):
    def deco(fn):
        CASES[fn.__name__] = (fn, want)
        return fn
    return deco


@case("ok")
def load_contract_and_sibling_import(p):
    loader = loader_for(p, {"shipped.py": GOOD_CONTRACT,
                            "helpers.py": HELPERS,
                            "docs/legal.txt": b"prose"})
    contract = loader.load_contract("shipped.ShippedContract")
    assert type(contract).__name__ == "ShippedContract"
    assert loader.get_resource("docs/legal.txt") == b"prose"
    tx = p.TransactionForContract(
        inputs=(), outputs=(p.DummySingleOwnerState(0),), attachments=(),
        commands=(), id=p.SecureHash.random(), notary=None)
    contract.verify(tx)  # one output, MAGIC == 42 -> accepts
    bad = p.TransactionForContract(
        inputs=(), outputs=(), attachments=(), commands=(),
        id=p.SecureHash.random(), notary=None)
    with pytest.raises(Exception, match="one output") as e:
        contract.verify(bad)
    return type(e.value).__name__, str(e.value)


@case(("OverlappingAttachments", "helpers.py"))
def overlapping_paths_rejected(p):
    loader_for(p, {"helpers.py": HELPERS},
               extra=[{"helpers.py": b"MAGIC = 13\n"}])


@case(("OverlappingAttachments", ""))
def case_variant_paths_rejected(p):
    loader_for(p, {"Helpers.py": HELPERS}, extra=[{"helpers.py": HELPERS}])


@case(("ModuleNotFoundError", ""))
def missing_module_raises_module_not_found(p):
    loader_for(p, {"helpers.py": HELPERS}).load_module("nope")


@case(("SandboxViolation", "socket"))
def hostile_attachment_rejected_at_load_time(p):
    evil = b"import socket\nHOST = socket.gethostname()\n"
    loader_for(p, {"evil.py": evil}).load_module("evil")


@case(("SandboxViolation", "open"))
def hostile_builtin_rejected_at_load_time(p):
    evil = b"secret = open('/etc/passwd').read()\n"
    loader_for(p, {"evil.py": evil}).load_module("evil")


@case(("SandboxViolation", "__builtins__"))
def builtins_subscript_escape_rejected(p):
    evil = b"LEAK = __builtins__['open']\n"
    loader_for(p, {"evil.py": evil}).load_module("evil")


@case(("SandboxViolation", "os.path"))
def stub_shadowing_host_package_rejected(p):
    files = {"os.py": b"STUB = 1\n",
             "evil.py": b"from os.path import exists\nHIT = exists('/')\n"}
    loader_for(p, files).load_module("evil")


@case("ok")
def attachment_builtins_are_restricted(p):
    module = loader_for(p, {"helpers.py": HELPERS}).load_module("helpers")
    b = module.__dict__["__builtins__"]
    assert "open" not in b and "eval" not in b and "exec" not in b
    assert "len" in b and "ValueError" in b
    return sorted(b)


@case(("SandboxViolation", ""))
def runtime_import_escape_rejected(p):
    sneaky = b"from helpers import MAGIC\n"
    loader_for(p, {"sneaky.py": sneaky}).load_module("sneaky")


@case(("TypeError", ""))
def loaded_contract_is_not_a_contract_type_error(p):
    loader_for(p, {"helpers.py": HELPERS}).load_contract("helpers.MAGIC")


def verdict(pkg, name):
    fn, _ = CASES[name]
    p = ns(pkg)
    try:
        return "ok", fn(p)
    except (p.OverlappingAttachments, p.SandboxViolation,
            ModuleNotFoundError, TypeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(CASES))
def test_loader_case_same_verdict_and_reason(name):
    want = CASES[name][1]
    port, jax = verdict("corda_tpu_torch", name), verdict("corda_tpu", name)
    assert port == jax
    if want == "ok":
        assert port[0] == "ok"
    else:
        assert port[0] == want[0] and want[1] in port[1], port


# -- one zip in both packages ------------------------------------------------

def _views(pkg, n=60):
    """Phase 26 (b)'s views, on ``pkg``'s own notary workload."""
    nl = importlib.import_module("corda_tpu_torch.testing.notary_load")
    if pkg == "corda_tpu_torch":
        api = nl.port_api()
    else:
        m = lambda path: importlib.import_module(f"corda_tpu.{path}")  # noqa
        api = SimpleNamespace(
            MockNetwork=m("testing.mock_network").MockNetwork,
            DummyContract=m("testing.dummies").DummyContract,
            NotaryClientFlow=m("flows.notary").NotaryClientFlow)
    verifier = importlib.import_module(
        f"{pkg}.crypto.provider").CpuVerifier()
    net, notary, alice, bob = nl.make_network(api, verifier, False)
    try:
        work = nl.build_workload(api, notary, alice, bob, n, 1, 1, 26)
    finally:
        net.stop_nodes()
    if pkg == "corda_tpu_torch":
        return cl.contract_views(work)
    p = ns(pkg)
    structures = importlib.import_module("corda_tpu.contracts.structures")
    issued = {s.id: s for s in work.issues}
    return [p.TransactionForContract(
        inputs=tuple(issued[r.txhash].tx.outputs[r.index].data
                     for r in s.tx.inputs),
        outputs=tuple(o.data for o in s.tx.outputs), attachments=(),
        commands=tuple(structures.AuthenticatedObject(c.signers, (), c.value)
                       for c in s.tx.commands),
        id=s.id, notary=s.tx.notary) for s in work.moves]


def _clause_verdicts(pkg, sandboxed):
    p = ns(pkg)
    blob = p.make_attachment_zip(cl.CLAUSE_FILES)
    contract = p.Loader([p.BlobAttachment(blob)]).load_contract(
        cl.CLAUSE_CONTRACT_NAME)
    dsl = importlib.import_module(f"{pkg}.contracts.dsl")
    out = []
    for view in _views(pkg):
        try:
            if sandboxed:
                p.DeterministicSandbox().run(type(contract).verify, contract,
                                             view)
            else:
                contract.verify(view)
            out.append(True)
        except dsl.RequirementFailed:
            out.append(False)
    return bytes(p.BlobAttachment(blob).id.bytes), out


def test_one_attachment_zip_verifies_the_same_in_both_packages():
    port_id, port = _clause_verdicts("corda_tpu_torch", sandboxed=True)
    jax_id, jax = _clause_verdicts("corda_tpu", sandboxed=True)
    assert port_id == jax_id  # one zip, one hash
    assert port == jax
    assert any(port) and not all(port)  # the magic rule splits the moves


@pytest.mark.parametrize("sandboxed", [False, True],
                         ids=["direct", "sandboxed"])
def test_clause_contract_sandboxed_equals_direct(sandboxed):
    """contract_load's helpers: the attachment contract's verdicts under
    DeterministicSandbox.run equal the direct run's."""
    from corda_tpu_torch.contracts.sandbox import DeterministicSandbox

    contract = cl.load_clause_contract()
    views = _views("corda_tpu_torch")
    got = cl.verdicts(contract, views,
                      DeterministicSandbox() if sandboxed else None)
    assert got == _clause_verdicts("corda_tpu_torch", sandboxed=False)[1]


@pytest.mark.parametrize("name", list(cl.HOSTILE))
def test_hostile_attachment_refused_at_load(name):
    from corda_tpu_torch.contracts.sandbox import SandboxViolation

    files, reason = cl.HOSTILE[name]
    with pytest.raises(SandboxViolation, match=reason):
        cl.loader_for(files).load_module("evil")


def test_looping_attachment_contract_is_killed():
    from corda_tpu_torch.contracts.sandbox import (CostBudget,
                                                   DeterministicSandbox,
                                                   SandboxCostExceeded)

    contract = cl.loader_for({"looping.py": cl.LOOPING_CONTRACT}) \
        .load_contract("looping.LoopingContract")
    p = ns("corda_tpu_torch")
    view = p.TransactionForContract(
        inputs=(), outputs=(), attachments=(), commands=(),
        id=p.SecureHash.random(), notary=None)
    sandbox = DeterministicSandbox(budget=CostBudget(jumps=10_000))
    with pytest.raises(SandboxCostExceeded) as e:
        sandbox.run(type(contract).verify, contract, view)
    assert e.value.kind == "jump"


def test_platform_prefix_never_imports_the_jax_package():
    """In a fresh interpreter, loading and running attachment code that
    imports corda_tpu.<x> leaves corda_tpu out of sys.modules."""
    probe = (
        "import sys\n"
        "from corda_tpu_torch.testing import contract_load as cl\n"
        "c = cl.load_clause_contract()\n"
        "assert type(c).__name__ == 'ClauseContract'\n"
        "bad = [m for m in sys.modules if m == 'corda_tpu' "
        "or m.startswith('corda_tpu.')]\n"
        "assert not bad, bad\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", probe], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
