"""Finalising and broadcasting transactions.

The port's own copy of ``corda_tpu/flows/finality.py``.

Capability match for the reference's FinalityFlow (reference:
core/src/main/kotlin/net/corda/flows/FinalityFlow.kt:17-51) and
BroadcastTransactionFlow (core/.../flows/BroadcastTransactionFlow.kt):
notarise if needed, record locally, then notify every participant, whose
data-vending NotifyTransactionHandler resolves and records it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.party import Party
from ..serialization.codec import register
from ..transactions.signed import SignedTransaction
from ..utils.progress import ProgressTracker, Step
from .api import FlowLogic, register_flow
from .notary import notarise_with_retry


@register
@dataclass(frozen=True)
class NotifyTxRequest:
    tx: SignedTransaction


@register_flow
class BroadcastTransactionFlow(FlowLogic):
    """Record locally and notify participants (BroadcastTransactionFlow.kt)."""

    def __init__(self, notarised_transaction: SignedTransaction, participants: tuple):
        self.notarised_transaction = notarised_transaction
        self.participants = tuple(participants)

    def call(self):
        self.record_transactions([self.notarised_transaction])
        msg = NotifyTxRequest(self.notarised_transaction)
        me = self.service_hub.my_identity
        for participant in self.participants:
            if participant != me:
                yield self.send(participant, msg)
        return None


@register_flow
class FinalityFlow(FlowLogic):
    """Notarise (if needed) then broadcast (FinalityFlow.kt:27-51).

    Progress mirrors the reference's NOTARISING/BROADCASTING tracker, with
    the notary sub-flow's own steps spliced beneath NOTARISING."""

    def __init__(self, transaction: SignedTransaction, participants: tuple):
        self.transaction = transaction
        self.participants = tuple(participants)
        self.NOTARISING = Step("Requesting signature by notary service")
        self.BROADCASTING = Step("Broadcasting transaction to participants")
        self.progress_tracker = ProgressTracker(
            self.NOTARISING, self.BROADCASTING)

    def call(self):
        stx = self.transaction
        if self._needs_notary_signature(stx):
            self.progress_tracker.current_step = self.NOTARISING
            notary_sig = yield from notarise_with_retry(
                self, stx,
                on_attempt=lambda nf: self.progress_tracker.set_child_tracker(
                    self.NOTARISING, nf.progress_tracker))
            stx = stx.with_additional_signature(notary_sig)
        self.progress_tracker.current_step = self.BROADCASTING
        yield from self.sub_flow(
            BroadcastTransactionFlow(stx, self.participants),
            share_parent_sessions=True,
        )
        return stx  # the framework marks the tracker Done on completion

    @staticmethod
    def _needs_notary_signature(stx: SignedTransaction) -> bool:
        notary = stx.tx.notary
        if notary is None:
            return False
        signers = {sig.by for sig in stx.sigs}
        return not notary.owning_key.is_fulfilled_by(signers)
