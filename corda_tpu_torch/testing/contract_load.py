"""Contract code from an attachment, verified under the deterministic
sandbox: the workload of ``chip_smoke.py`` phase 26 (b) and of
``tests/test_torch_attachments_loader.py``.

A contract built from clauses (``AllComposition`` of two clauses) ships as
an attachment zip beside a helper module it imports; it names the
platform as the JAX package does (``corda_tpu.contracts...``), so the same
zip, with the same hash, loads in either package (contracts/sandbox.py's
``platform_module_name``). :func:`contract_views` turns a notary workload's
moves (testing/notary_load.py) into the ``TransactionForContract`` views a
contract verifies; :func:`verdicts` runs the contract over them, directly
or under ``DeterministicSandbox.run``. The hostile attachments are refused
at load (HOSTILE), and a looping contract is killed by the cost budget
(LOOPING).

Usage (the port):
    contract = load_clause_contract()
    views = contract_views(work)
    assert verdicts(contract, views, DeterministicSandbox()) == \\
        verdicts(contract, views)
"""

from __future__ import annotations

from ..contracts.attachments_loader import (AttachmentsModuleLoader,
                                            make_attachment_zip)
from ..contracts.dsl import RequirementFailed
from ..contracts.structures import Attachment, AuthenticatedObject
from ..contracts.verification import TransactionForContract
from ..crypto.hashes import SecureHash

CLAUSE_CONTRACT = b'''
from corda_tpu.contracts.clauses import AllComposition, Clause, verify_clause
from corda_tpu.contracts.dsl import require_that
from corda_tpu.contracts.structures import Contract
from rules import MAX_OUTPUTS, magic_ok


class ShapeClause(Clause):
    def verify(self, tx, inputs, outputs, commands, key):
        with require_that() as req:
            req("one input", len(inputs) == 1)
            req("at most MAX_OUTPUTS outputs", len(outputs) <= MAX_OUTPUTS)
            req("the magic number is kept", all(
                o.magic_number == inputs[0].magic_number for o in outputs))
        return set()


class MagicClause(Clause):
    def verify(self, tx, inputs, outputs, commands, key):
        with require_that() as req:
            req("the magic number passes the rule",
                all(magic_ok(o.magic_number) for o in outputs))
        return set()


class ClauseContract(Contract):
    def verify(self, tx):
        verify_clause(tx, AllComposition(ShapeClause(), MagicClause()),
                      tx.commands)
'''

RULES = b'''MAX_OUTPUTS = 1


def magic_ok(magic):
    return magic % 3 != 0
'''

CLAUSE_FILES = {"clause_contract.py": CLAUSE_CONTRACT, "rules.py": RULES}
CLAUSE_CONTRACT_NAME = "clause_contract.ClauseContract"

# Attachments the loader must refuse, each with the text its
# SandboxViolation names: a builtin reaching the file system, dynamic code,
# and an import of a module that is not in the attachment set nor
# whitelisted (the runtime import escape).
HOSTILE = {
    "open": ({"evil.py": b"SECRET = open('/etc/passwd').read()\n"}, "open"),
    "eval": ({"evil.py": b"VALUE = eval('1 + 1')\n"}, "eval"),
    "import": ({"evil.py": b"from socket import gethostname\n"
                           b"HOST = gethostname()\n"}, "socket"),
}

LOOPING_CONTRACT = b'''
from corda_tpu.contracts.structures import Contract


class LoopingContract(Contract):
    def verify(self, tx):
        n = 0
        while True:
            n += 1
'''


class BlobAttachment(Attachment):
    """An attachment over bytes in memory."""

    def __init__(self, data: bytes):
        self._data = data

    @property
    def id(self) -> SecureHash:
        return SecureHash.sha256(self._data)

    def open(self) -> bytes:
        return self._data


def loader_for(files: dict[str, bytes]) -> AttachmentsModuleLoader:
    return AttachmentsModuleLoader([BlobAttachment(
        make_attachment_zip(files))])


def load_clause_contract():
    """The clause contract, loaded from its attachment zip and vetted."""
    return loader_for(CLAUSE_FILES).load_contract(CLAUSE_CONTRACT_NAME)


def contract_views(work) -> list[TransactionForContract]:
    """Each move of a notary workload (its input, the issue's output) as
    the view a contract verifies."""
    issued = {s.id: s for s in work.issues}
    views = []
    for stx in work.moves:
        tx = stx.tx
        inputs = tuple(issued[ref.txhash].tx.outputs[ref.index].data
                       for ref in tx.inputs)
        views.append(TransactionForContract(
            inputs=inputs, outputs=tuple(o.data for o in tx.outputs),
            attachments=(), commands=tuple(
                AuthenticatedObject(c.signers, (), c.value)
                for c in tx.commands),
            id=stx.id, notary=tx.notary))
    return views


def verdicts(contract, views, sandbox=None) -> list[bool]:
    """Accept (True) or RequirementFailed (False) for each view, run
    directly or, with a sandbox, under ``sandbox.run``."""
    out = []
    for view in views:
        try:
            if sandbox is None:
                contract.verify(view)
            else:
                sandbox.run(type(contract).verify, contract, view)
            out.append(True)
        except RequirementFailed:
            out.append(False)
    return out
