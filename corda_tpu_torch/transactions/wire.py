"""WireTransaction: the signable, serializable transaction payload.

The port's own copy of ``corda_tpu/transactions/wire.py``.
``to_ledger_transaction`` and ``build_filtered_transaction`` import
``ledger.py`` and ``filtered.py`` lazily, as the original does.

Capability match for the reference's WireTransaction + BaseTransaction
(reference: core/src/main/kotlin/net/corda/core/transactions/WireTransaction.kt,
BaseTransaction.kt). The transaction id is the root of a Merkle tree over the
canonical serialization of each component (inputs, outputs, attachments,
commands — reference: MerkleTransaction.kt:26-38, WireTransaction.kt:45-52),
so signatures live *outside* the id and verify in parallel — the property the
whitepaper singles out (corda-technical-whitepaper.tex:1597-1604) and the
batched verify kernel exploits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from ..contracts.structures import (
    AuthenticatedObject,
    Command,
    StateAndRef,
    StateRef,
    Timestamp,
    TransactionState,
)
from ..contracts.verification import (
    AttachmentResolutionException,
    TransactionResolutionException,
)
from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..crypto.merkle import MerkleTree, PartialMerkleTree
from ..crypto.party import Party
from ..serialization.codec import register, serialize, serialized_hash
from .types import GeneralTransactionType, TransactionType

if TYPE_CHECKING:
    from .ledger import LedgerTransaction


@register
@dataclass(frozen=True)
class WireTransaction:
    """Immutable transaction payload; id = Merkle root of component hashes."""

    inputs: tuple[StateRef, ...] = ()
    attachments: tuple[SecureHash, ...] = ()
    outputs: tuple[TransactionState, ...] = ()
    commands: tuple[Command, ...] = ()
    notary: Party | None = None
    signers: tuple[CompositeKey, ...] = ()
    type: TransactionType = field(default_factory=GeneralTransactionType)
    timestamp: Timestamp | None = None

    def __post_init__(self):
        for name in ("inputs", "attachments", "outputs", "commands", "signers"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        # Invariants from BaseTransaction.checkInvariants (BaseTransaction.kt:42-45).
        if self.notary is None and self.inputs:
            raise ValueError("The notary must be specified explicitly for any transaction that has inputs.")
        if self.timestamp is not None and self.notary is None:
            raise ValueError("If a timestamp is provided, there must be a notary.")

    # -- identity ----------------------------------------------------------

    @property
    def all_leaves_hashes(self) -> list[SecureHash]:
        """Per-component canonical-serialization hashes, in the fixed
        component-group order (MerkleTransaction.kt:26-31).

        KNOWN MALLEABILITY (inherited, reference parity): the id covers only
        inputs/outputs/attachments/commands — exactly the reference snapshot's
        calculateLeavesHashes — so notary, signers, type and timestamp can be
        re-encoded by a relayer without changing the id or invalidating
        signatures. Later upstream versions add those fields as extra leaves;
        here we keep bit-parity with the snapshot. The id cross-check in
        SignedTransaction.tx catches component tampering only; altered
        notary/signers/type/timestamp must be caught by the verification
        rules that read them (timestamp window, notary match, must_sign
        fulfilment), which run on the payload the verifier received."""
        cached = getattr(self, "_leaves", None)
        if cached is None:
            cached = [
                serialized_hash(x)
                for group in (self.inputs, self.outputs, self.attachments, self.commands)
                for x in group
            ]
            object.__setattr__(self, "_leaves", cached)
        return cached

    @property
    def merkle_tree(self) -> MerkleTree:
        cached = getattr(self, "_tree", None)
        if cached is None:
            cached = MerkleTree.build(self.all_leaves_hashes)
            object.__setattr__(self, "_tree", cached)
        return cached

    @property
    def id(self) -> SecureHash:
        return self.merkle_tree.hash

    @property
    def serialized(self):
        cached = getattr(self, "_bytes", None)
        if cached is None:
            cached = serialize(self)
            object.__setattr__(self, "_bytes", cached)
        return cached

    @property
    def must_sign(self) -> tuple[CompositeKey, ...]:
        return self.signers

    # -- derived views -----------------------------------------------------

    def out_ref(self, index: int) -> StateAndRef:
        if not 0 <= index < len(self.outputs):
            raise IndexError(index)
        return StateAndRef(self.outputs[index], StateRef(self.id, index))

    def out_ref_of(self, state) -> StateAndRef:
        for i, out in enumerate(self.outputs):
            if out.data == state:
                return self.out_ref(i)
        raise ValueError("state not found among outputs")

    def to_ledger_transaction(self, services) -> "LedgerTransaction":
        """Resolve inputs/attachments/parties from services
        (WireTransaction.kt:79-96). Requires dependencies already resolved
        (ResolveTransactionsFlow)."""
        from .ledger import LedgerTransaction

        authenticated = tuple(
            AuthenticatedObject(
                signers=cmd.signers,
                signing_parties=tuple(
                    p
                    for p in (
                        services.identity_service.party_from_key(k) for k in cmd.signers
                    )
                    if p is not None
                ),
                value=cmd.value,
            )
            for cmd in self.commands
        )
        attachments = []
        for att_id in self.attachments:
            att = services.storage_service.attachments.open_attachment(att_id)
            if att is None:
                raise AttachmentResolutionException(att_id)
            attachments.append(att)
        resolved = []
        for ref in self.inputs:
            state = services.load_state(ref)
            if state is None:
                raise TransactionResolutionException(ref.txhash)
            resolved.append(StateAndRef(state, ref))
        return LedgerTransaction(
            inputs=tuple(resolved),
            outputs=self.outputs,
            commands=authenticated,
            attachments=tuple(attachments),
            id=self.id,
            notary=self.notary,
            must_sign=self.signers,
            timestamp=self.timestamp,
            type=self.type,
        )

    def build_filtered_transaction(self, filter_funs) -> "FilteredTransaction":
        from .filtered import FilteredTransaction

        return FilteredTransaction.build_merkle_transaction(self, filter_funs)

    def partial_merkle_tree(self, include: list[SecureHash]) -> PartialMerkleTree:
        return PartialMerkleTree.build(self.merkle_tree, include)

    def __str__(self) -> str:
        lines = [f"Transaction {self.id}:"]
        lines += [f"  INPUT:   {i}" for i in self.inputs]
        lines += [f"  OUTPUT:  {o}" for o in self.outputs]
        lines += [f"  COMMAND: {c}" for c in self.commands]
        lines += [f"  ATTACH:  {a}" for a in self.attachments]
        return "\n".join(lines)
