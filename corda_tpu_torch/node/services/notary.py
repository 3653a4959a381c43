"""Notary services: node-side assembly of the uniqueness-consensus service.

The port's own copy of ``corda_tpu/node/services/notary.py``.

Capability match for the reference's notary service classes (reference:
node/src/main/kotlin/net/corda/node/services/transactions/NotaryService.kt:17-26,
SimpleNotaryService.kt, ValidatingNotaryService.kt): each registers a flow
factory so that a client's NotaryClientFlow session spawns the right service
flow, wired to this node's TimestampChecker and UniquenessProvider.

The service object is a checkpoint token (SerializeAsToken equivalent), so
in-flight notarisation flows survive node restarts.

Pipeline parallelism on the validating path: the service flow suspends at
two pump seams — verify_signatures_batched (the verify micro-batch, served
by the async feeder thread when batch.async_verify is on) and the Raft
commit ServiceRequest (commit_async). The node round drains completed
verifies BEFORE flushing AppendEntries, so tx N's replication overlaps
tx N+1's device verify without this module doing anything special; keep
new service-side work behind those same seams or it re-serialises the
round (see ARCHITECTURE.md "Async verify pipeline").

The commit seam is also the group-commit seam (ARCHITECTURE.md "Commit
pipeline"): every notary flow whose commit_async submits during one
poll_services pass rides ONE PutAllBatch log entry on the raft leader —
conflict isolation stays per-request (a double-spend in the batch rejects
alone, its siblings commit), so nothing here needs to sort or segregate
requests before committing. Keep commits going through commit_async one
request at a time; batching is the consensus layer's job.
"""

from __future__ import annotations

from ...contracts.structures import DEFAULT_TIMESTAMP_TOLERANCE_MICROS
from ...crypto.keys import DigitalSignature, KeyPair
from ...crypto.party import Party
from ...flows.notary import NotaryServiceFlow, ValidatingNotaryFlow
from ...serialization.tokens import SerializeAsToken
from ...utils.clock import Clock
from ..statemachine import StateMachineManager
from .api import ServiceHub, UniquenessProvider


class TimestampChecker:
    """Validity window check for transaction timestamps (reference:
    core/.../node/services/TimestampChecker.kt:12-26)."""

    def __init__(self, clock: Clock | None = None,
                 tolerance_micros: int | None = None):
        if tolerance_micros is None:
            tolerance_micros = DEFAULT_TIMESTAMP_TOLERANCE_MICROS
        self.clock = clock or Clock()
        self.tolerance_micros = tolerance_micros

    def is_valid(self, timestamp) -> bool:
        now = self.clock.now_micros()
        if timestamp.before is not None and now - timestamp.before > self.tolerance_micros:
            return False
        if timestamp.after is not None and timestamp.after - now > self.tolerance_micros:
            return False
        return True


class NotaryServiceBase(SerializeAsToken):
    """Common wiring: flow factory registration + signing."""

    flow_class = NotaryServiceFlow

    def __init__(
        self,
        smm: StateMachineManager,
        services: ServiceHub,
        notary_identity: Party,
        notary_key: KeyPair,
        uniqueness_provider: UniquenessProvider,
        timestamp_checker: TimestampChecker | None = None,
    ):
        self.services = services
        self.notary_identity = notary_identity
        self._notary_key = notary_key
        self.uniqueness_provider = uniqueness_provider
        self.timestamp_checker = timestamp_checker or TimestampChecker(
            getattr(services, "clock", None) or Clock()
        )
        smm.token_context.register(self)
        smm.register_flow_initiator(
            "NotaryClientFlow", lambda party: self.flow_class(party, self)
        )

    @property
    def token_name(self) -> str:
        return f"notary:{self.notary_identity.name}"

    def sign(self, data: bytes) -> DigitalSignature.WithKey:
        return self._notary_key.sign(data)


class SimpleNotaryService(NotaryServiceBase):
    """Non-validating (reference: SimpleNotaryService.kt:11-21)."""

    flow_class = NotaryServiceFlow


class ValidatingNotaryService(NotaryServiceBase):
    """Fully validating (reference: ValidatingNotaryService.kt:11-21)."""

    flow_class = ValidatingNotaryFlow


def rebuild_notary_service(old: NotaryServiceBase, node) -> NotaryServiceBase:
    """Re-wire a notary service onto a restarted node, keeping the durable
    uniqueness provider (MockNode.restart support)."""
    return type(old)(
        node.smm,
        node.services,
        node.identity,
        node.key,
        old.uniqueness_provider,
        old.timestamp_checker,
    )
