"""The ledger/transaction test DSL — contract unit testing without a node.

The port's own copy of ``corda_tpu/testing/ledger_dsl.py``.

Capability match for the reference's test DSL (reference:
test-utils/src/main/kotlin/net/corda/testing/TestDSL.kt:19-50,
LedgerDSLInterpreter.kt, TransactionDSLInterpreter.kt — the `ledger {
transaction { input/output/command; verifies() / "fails with" } tweak {...}
}` pattern every contract test in the reference is written in).

Python form:

    l = ledger(notary=NOTARY)
    with l.transaction() as tx:
        tx.output("alice's cash", CashState(...))
        tx.command(CashIssue(1), issuer_key)
        tx.verifies()
    with l.transaction() as tx:
        tx.input("alice's cash")
        tx.output("bob's cash", CashState(...))
        tx.command(CashMove(), alice_key)
        with tx.tweak() as tw:          # scoped what-if, parent unchanged
            tw.output("extra", CashState(...))
            tw.fails_with("amounts balance")
        tx.verifies()

verifies() runs every referenced contract's verify() against a
TransactionForContract exactly as platform verification does; labeled outputs
become resolvable inputs for later transactions in the same ledger.
"""

from __future__ import annotations

from contextlib import contextmanager

from ..contracts.structures import (
    AuthenticatedObject,
    Command,
    ContractState,
    StateRef,
    Timestamp,
)
from ..contracts.verification import TransactionForContract
from ..crypto.hashes import SecureHash
from ..crypto.party import Party


class DslError(AssertionError):
    pass


class TransactionDsl:
    def __init__(self, ledger: "Ledger", base: "TransactionDsl | None" = None):
        self._ledger = ledger
        if base is not None:  # tweak: start from a snapshot of the parent
            self.inputs = list(base.inputs)
            self.outputs = list(base.outputs)
            self.commands = list(base.commands)
            self._timestamp = base._timestamp
        else:
            self.inputs: list[tuple[StateRef, ContractState]] = []
            self.outputs: list[tuple[str | None, ContractState]] = []
            self.commands: list[Command] = []
            self._timestamp: Timestamp | None = None
        self._verified = False

    # -- building ----------------------------------------------------------

    def input(self, label_or_state) -> None:
        if isinstance(label_or_state, str):
            ref, state = self._ledger.resolve(label_or_state)
        else:
            ref = StateRef(SecureHash.random(), 0)  # unlabeled ad-hoc input
            state = label_or_state
        self.inputs.append((ref, state))

    def output(self, label: str | None, state: ContractState = None) -> None:
        if state is None:
            label, state = None, label  # output(state) shorthand
        self.outputs.append((label, state))

    def command(self, value, *signers) -> None:
        self.commands.append(Command(value, tuple(signers)))

    def timestamp(self, ts: Timestamp) -> None:
        self._timestamp = ts

    # -- verification ------------------------------------------------------

    def _tx_for_contract(self) -> TransactionForContract:
        return TransactionForContract(
            inputs=tuple(s for _, s in self.inputs),
            outputs=tuple(s for _, s in self.outputs),
            attachments=(),
            commands=tuple(
                AuthenticatedObject(c.signers, (), c.value)
                for c in self.commands),
            id=SecureHash.random(),
            notary=self._ledger.notary,
            timestamp=self._timestamp,
        )

    def _run_contracts(self) -> None:
        tx = self._tx_for_contract()
        contracts = {s.contract for s in tx.inputs} | {
            s.contract for s in tx.outputs}
        for contract in contracts:
            contract.verify(tx)

    def verifies(self) -> None:
        """Every referenced contract accepts (TestDSL verifies())."""
        self._run_contracts()
        self._verified = True

    def fails_with(self, fragment: str) -> None:
        """Verification fails AND the message mentions `fragment`
        (TestDSL `fails with`)."""
        try:
            self._run_contracts()
        except Exception as e:
            if fragment.lower() not in str(e).lower():
                raise DslError(
                    f"failed, but with {e!r}; expected {fragment!r}") from e
            self._verified = True
            return
        raise DslError(f"expected failure mentioning {fragment!r}, "
                       "but the transaction verified")

    @contextmanager
    def tweak(self):
        """A scoped copy: changes inside don't affect this transaction
        (TestDSL tweak)."""
        yield TransactionDsl(self._ledger, base=self)


class Ledger:
    def __init__(self, notary: Party):
        self.notary = notary
        self._labeled: dict[str, tuple[StateRef, ContractState]] = {}
        self._tx_count = 0

    def resolve(self, label: str):
        if label not in self._labeled:
            raise DslError(f"no output labeled {label!r}")
        return self._labeled[label]

    @contextmanager
    def transaction(self):
        tx = TransactionDsl(self)
        yield tx
        if not tx._verified:
            raise DslError(
                "transaction block ended without verifies()/fails_with()")
        # Register labeled outputs for later transactions.
        self._tx_count += 1
        fake_id = SecureHash.sha256(b"ledger-dsl-tx-%d" % self._tx_count)
        for index, (label, state) in enumerate(tx.outputs):
            if label is not None:
                self._labeled[label] = (StateRef(fake_id, index), state)


def ledger(notary: Party) -> Ledger:
    return Ledger(notary)
