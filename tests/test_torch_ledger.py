"""The port's transactions/ledger.py, filtered.py and graph_search.py against
the JAX package's, on the same transactions built in each package.

LedgerTransaction.verify must accept and refuse alike (the exception type
and its cause's message), through ``WireTransaction.to_ledger_transaction``
and on ledger transactions built directly for the platform rules; tear-off
FilteredTransactions must encode to the same bytes and verify alike; and
TransactionGraphSearch must return the same ids. Tolerance: exact.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import pytest

MODULES = {
    "keys": "crypto.keys", "party": "crypto.party", "hashes": "crypto.hashes",
    "merkle": "crypto.merkle", "structures": "contracts.structures",
    "verification": "contracts.verification",
    "codec": "serialization.codec", "dummies": "testing.dummies",
    "builder": "transactions.builder", "ledger": "transactions.ledger",
    "filtered": "transactions.filtered",
    "graph_search": "transactions.graph_search",
}


def _package(root):
    p = SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                           for k, v in MODULES.items()})

    class RejectContract(p.structures.Contract):
        """Refuses any transaction with an output of odd magic."""

        def verify(self, tx):
            if any(s.magic % 2 for s in tx.outputs):
                raise ValueError("odd magic is refused")

        @property
        def legal_contract_reference(self):
            return p.hashes.SecureHash.sha256(b"reject")

    @dataclasses.dataclass(frozen=True)
    class RejectState(p.structures.ContractState):
        magic: int = 0
        owner: object = None

        @property
        def contract(self):
            return RejectContract()

        @property
        def participants(self):
            return [self.owner]

    p.RejectState = RejectState
    return p


JAX = _package("corda_tpu")
PORT = _package("corda_tpu_torch")
REJECT_WIRE_NAME = "test_torch_ledger.RejectState"


@pytest.fixture(autouse=True, scope="module")
def _reject_state_registered():
    """RejectState is in each codec's whitelist only while this module's
    tests run: other test modules read the port's registry as the set of
    its own classes."""
    for p in (JAX, PORT):
        p.codec.register_class(p.RejectState, name=REJECT_WIRE_NAME)
    yield
    for p in (JAX, PORT):
        p.codec._BY_NAME.pop(REJECT_WIRE_NAME)
        p.codec._BY_TYPE.pop(p.RejectState)


class FakeServices:
    """Just enough ServiceHub for to_ledger_transaction."""

    def __init__(self, txs=()):
        self._txs = {t.id: t for t in txs}
        self.storage_service = SimpleNamespace(
            validated_transactions=SimpleNamespace(
                get_transaction=self._txs.get),
            attachments=SimpleNamespace(open_attachment=lambda _id: None))
        self.identity_service = SimpleNamespace(party_from_key=lambda _k: None)

    def load_state(self, ref):
        stx = self._txs.get(ref.txhash)
        return None if stx is None else stx.tx.outputs[ref.index]


def _ids(p):
    alice_key = p.keys.KeyPair.generate(b"\x51" * 32)
    alice = p.party.Party.of("Alice", alice_key.public)
    bob = p.party.Party.of("Bob", p.keys.KeyPair.generate(b"\x53" * 32).public)
    notary = p.party.Party.of("Notary",
                              p.keys.KeyPair.generate(b"\x52" * 32).public)
    other = p.party.Party.of("Other",
                             p.keys.KeyPair.generate(b"\x54" * 32).public)
    return alice_key, alice, bob, notary, other


def _issue(p, owner, owner_key, notary, magic):
    b = p.dummies.DummyContract.generate_initial(
        owner.ref(bytes([magic % 256])), magic, notary)
    b.sign_with(owner_key)
    return b.to_signed_transaction()


def _reject_tx(p, owner, notary, magic):
    b = p.builder.TransactionBuilder(notary=notary)
    b.add_output_state(p.RejectState(magic, owner.owning_key))
    b.add_command(p.structures.Command(p.dummies.DummyCreate(),
                                       (owner.owning_key,)))
    return b.to_wire_transaction()


def _via_wire(p, case):
    """(wire transaction, services) for the cases that go through
    to_ledger_transaction."""
    alice_key, alice, bob, notary, _ = _ids(p)
    issue = _issue(p, alice, alice_key, notary, 7)
    if case == "issue":
        return issue.tx, FakeServices()
    if case == "move":
        m = p.dummies.DummyContract.move(issue.tx.out_ref(0), bob.owning_key)
        return m.to_wire_transaction(), FakeServices([issue])
    if case == "unresolved-input":
        m = p.dummies.DummyContract.move(issue.tx.out_ref(0), bob.owning_key)
        return m.to_wire_transaction(), FakeServices()
    if case == "contract-accepts":
        return _reject_tx(p, alice, notary, 8), FakeServices()
    if case == "contract-rejects":
        return _reject_tx(p, alice, notary, 9), FakeServices()
    raise AssertionError(case)


def _direct(p, case):
    """LedgerTransactions built field by field for the platform rules."""
    alice_key, alice, bob, notary, other = _ids(p)
    s = p.structures
    issue = _issue(p, alice, alice_key, notary, 11)
    issue2 = _issue(p, alice, alice_key, other, 12)
    wtx = p.dummies.DummyContract.move(issue.tx.out_ref(0),
                                       bob.owning_key).to_wire_transaction()
    inputs = (s.StateAndRef(issue.tx.outputs[0], wtx.inputs[0]),)
    outputs = wtx.outputs
    must_sign = wtx.signers
    if case == "signers-missing":
        must_sign = ()
    elif case == "two-notaries":
        inputs += (s.StateAndRef(issue2.tx.outputs[0],
                                 issue2.tx.out_ref(0).ref),)
    elif case == "notary-change-in-general":
        outputs = (s.TransactionState(outputs[0].data, other),)
    elif case != "valid":
        raise AssertionError(case)
    return p.ledger.LedgerTransaction(
        inputs=inputs, outputs=outputs,
        commands=tuple(s.AuthenticatedObject(signers=c.signers,
                                             signing_parties=(), value=c.value)
                       for c in wtx.commands),
        attachments=(), id=wtx.id, notary=notary, must_sign=must_sign,
        timestamp=None, type=wtx.type)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        cause = e.__cause__
        return (type(e).__name__, type(cause).__name__ if cause else None,
                str(cause) if cause else None)
    return ("accepted",)


WIRE_CASES = ["issue", "move", "unresolved-input", "contract-accepts",
              "contract-rejects"]
WIRE_EXPECT = {"issue": "accepted", "move": "accepted",
               "unresolved-input": "TransactionResolutionException",
               "contract-accepts": "accepted",
               "contract-rejects": "ContractRejection"}


@pytest.mark.parametrize("case", WIRE_CASES)
def test_to_ledger_transaction_verify_equals_jax(case):
    outs = []
    for p in (JAX, PORT):
        wtx, services = _via_wire(p, case)
        outs.append((bytes(wtx.id.bytes),
                     _outcome(lambda: wtx.to_ledger_transaction(
                         services).verify())))
    assert outs[0] == outs[1]
    assert outs[1][1][0] == WIRE_EXPECT[case]


DIRECT_EXPECT = {"valid": "accepted", "signers-missing": "SignersMissing",
                 "two-notaries": "MoreThanOneNotary",
                 "notary-change-in-general":
                     "NotaryChangeInWrongTransactionType"}


@pytest.mark.parametrize("case", sorted(DIRECT_EXPECT))
def test_ledger_transaction_platform_rules_equal_jax(case):
    outs = []
    for p in (JAX, PORT):
        ltx = _direct(p, case)
        outs.append((bytes(ltx.id.bytes), _outcome(ltx.verify),
                     p.codec.serialize(ltx.to_transaction_for_contract()
                                       .outputs).bytes))
    assert outs[0] == outs[1]
    assert outs[1][1][0] == DIRECT_EXPECT[case]


FILTERS = {
    "commands": lambda p: p.filtered.FilterFuns(
        filter_commands=lambda c: isinstance(c.value, p.dummies.DummyMove)),
    "outputs": lambda p: p.filtered.FilterFuns(filter_outputs=lambda o: True),
    "inputs-and-commands": lambda p: p.filtered.FilterFuns(
        filter_inputs=lambda i: True, filter_commands=lambda c: True),
    "everything": lambda p: p.filtered.FilterFuns(
        filter_inputs=lambda i: True, filter_outputs=lambda o: True,
        filter_commands=lambda c: True),
}


def _moves(p):
    alice_key, alice, bob, notary, _ = _ids(p)
    out = []
    for magic in (21, 22, 23):
        issue = _issue(p, alice, alice_key, notary, magic)
        m = p.dummies.DummyContract.move(issue.tx.out_ref(0), bob.owning_key)
        out.append(m.to_wire_transaction())
    return out


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filtered_transaction_equals_jax(name):
    rows = []
    for p in (JAX, PORT):
        wtxs = _moves(p)
        row = []
        for k, wtx in enumerate(wtxs):
            ftx = wtx.build_filtered_transaction(FILTERS[name](p))
            other = wtxs[(k + 1) % len(wtxs)]
            restored = p.codec.deserialize(p.codec.serialize(ftx).bytes)
            row.append((bytes(wtx.id.bytes),
                        p.codec.serialize(ftx).bytes,
                        ftx.verify(wtx.id), ftx.verify(other.id),
                        restored.verify(wtx.id),
                        [bytes(h.bytes) for h in
                         ftx.filtered_leaves.filtered_hashes()]))
        rows.append(row)
    assert rows[0] == rows[1]
    assert all(r[2] and not r[3] and r[4] for r in rows[1])


def test_filtered_transaction_without_leaves_refused_like_jax():
    for p in (JAX, PORT):
        wtx = _moves(p)[0]
        ftx = wtx.build_filtered_transaction(p.filtered.FilterFuns())
        with pytest.raises(p.merkle.MerkleTreeException):
            ftx.verify(wtx.id)


class _Storage:
    def __init__(self):
        self.txs = {}

    def add(self, stx):
        self.txs[stx.id] = stx

    def get_transaction(self, h):
        return self.txs.get(h)


def _chain(p, storage, length):
    alice_key, alice, _, notary, _ = _ids(p)
    stx = _issue(p, alice, alice_key, notary, 31)
    storage.add(stx)
    for _ in range(length):
        m = p.dummies.DummyContract.move(stx.tx.out_ref(0), alice.owning_key)
        m.sign_with(alice_key)
        stx = m.to_signed_transaction(check_sufficient_signatures=False)
        storage.add(stx)
    return stx


@pytest.mark.parametrize("command", ["DummyCreate", "DummyMove", None])
def test_graph_search_equals_jax(command):
    found = []
    for p in (JAX, PORT):
        storage = _Storage()
        tip = _chain(p, storage, 4)
        query = p.graph_search.Query(
            with_command_of_type=(getattr(p.dummies, command)
                                  if command else None))
        found.append([bytes(w.id.bytes) for w in
                      p.graph_search.TransactionGraphSearch(
                          storage, [tip.tx]).run(query)])
    assert found[0] == found[1]
    assert len(found[1]) == {"DummyCreate": 1, "DummyMove": 3, None: 4}[command]
