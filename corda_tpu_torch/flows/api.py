"""The flow programming model.

The port's own copy of ``corda_tpu/flows/api.py``.

Capability match for the reference's FlowLogic (reference:
core/src/main/kotlin/net/corda/core/flows/FlowLogic.kt:28-131) and
FlowStateMachine (core/.../flows/FlowStateMachine.kt), re-designed for
checkpointability without continuation serialization (SURVEY.md §7 stage 3):

The reference suspends Quasar fibers and Kryo-serializes their stacks
(node/.../statemachine/FlowStateMachineImpl.kt:238-261). Here a flow's
`call()` is a Python *generator* that yields effect requests; the state
machine manager (node/statemachine.py) executes effects and feeds
results back in. Checkpoints record the ordered results of completed
suspensions, so crash-recovery is deterministic replay: re-run the generator,
feed the recorded results, suppress re-execution of effects. The requirement
this places on flow code — determinism between suspension points — is the
standard durable-execution contract.

Usage:

    @register_flow
    class PingFlow(FlowLogic):
        def __init__(self, other: Party):
            self.other = other

        def call(self):
            answer = yield self.send_and_receive(self.other, "ping")
            result = yield from self.sub_flow(OtherFlow(answer.unwrap()))
            return result

All four effect kinds suspend via `yield`:
  self.send(party, payload)                (resolves to None)
  self.receive(party, cls)                 (resolves to UntrustworthyData)
  self.send_and_receive(party, p, cls)     (resolves to UntrustworthyData)
  self.verify_signatures_batched(stx, ...) (resolves when the micro-batched
                                            device verify completes — the seam
                                            the reference lacks)
Sub-flows compose with `yield from self.sub_flow(flow)` (reference:
FlowLogic.kt:98-109).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Generator, TYPE_CHECKING

from ..crypto.composite import CompositeKey
from ..crypto.party import Party
from ..serialization.codec import register as register_codec
from ..utils.excheckpoint import register_flow_exception

if TYPE_CHECKING:
    from ..transactions.signed import SignedTransaction


@register_flow_exception
class FlowException(Exception):
    """Base error for flow failures."""


@register_flow_exception
class FlowSessionException(FlowException):
    """The counterparty session failed: rejected init, unexpected end, or a
    type mismatch on receive."""


@register_codec
@dataclass(frozen=True)
class UntrustworthyData:
    """Wrapper forcing acknowledgement that peer data is unvalidated
    (reference: core/.../utilities/UntrustworthyData.kt). Codec-registered
    because recorded receive results appear in checkpoints."""

    payload: Any

    def unwrap(self, validator: Callable[[Any], Any] | None = None) -> Any:
        if validator is not None:
            return validator(self.payload)
        return self.payload


# ---------------------------------------------------------------------------
# Effect requests (what flows yield) — the analogue of ProtocolIORequest
# (reference: node/.../statemachine/StateMachineManager.kt IO request types)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SendRequest:
    party: Party
    payload: Any
    scope: str = ""  # which (sub-)flow's session namespace to use
    flow_name: str = ""  # initiating flow for SessionInit


@dataclass(frozen=True)
class ReceiveRequest:
    party: Party
    expected_type: type = object
    scope: str = ""
    flow_name: str = ""


@dataclass(frozen=True)
class SendAndReceiveRequest:
    party: Party
    payload: Any
    expected_type: type = object
    scope: str = ""
    flow_name: str = ""


@dataclass(frozen=True)
class VerifyTxRequest:
    """Check a SignedTransaction's signatures through the node's micro-batched
    verifier; suspends so the manager can aggregate across concurrent flows
    (the notary hot-path seam; reference hot loop at
    core/.../transactions/SignedTransaction.kt:83-87)."""

    stx: "SignedTransaction"
    allowed_to_be_missing: tuple[CompositeKey, ...] = ()


@dataclass(frozen=True)
class VerifySigRequest:
    """Check ONE raw signature through the same micro-batched verifier — the
    single-signature sibling of VerifyTxRequest. Used where a flow validates
    a counterparty's or notary's signature over known content (reference:
    NotaryFlow.kt:58-80 validateSignature); riding the pump means N
    concurrent flows validate their responses in one kernel call instead of
    N sequential host-oracle scalar multiplications."""

    pubkey: bytes
    message: bytes
    sig_bytes: bytes
    description: str = ""


@dataclass(frozen=True)
class ServiceRequest:
    """Suspend on an asynchronous node service (e.g. the Raft commit log):
    `start()` launches the operation and returns a poll callable; the node's
    run loop polls it each round — poll() returns None while pending, a value
    when done, or raises. The single-threaded cooperative design forbids a
    flow from blocking in-place (that would starve the very message pump the
    service needs), so this is the async seam.

    Not serialized: a flow restored from a checkpoint re-reaches the yield
    and re-launches the operation, so start() must be idempotent (as the
    replicated first-committer-wins commit is)."""

    start: Callable[[], Callable[[], Any]]


# ---------------------------------------------------------------------------
# Flow whitelist registry — the analogue of FlowLogicRefFactory
# (reference: core/.../flows/FlowLogicRef.kt:25-172)
# ---------------------------------------------------------------------------


class FlowRegistry:
    """Whitelisted reflective flow construction: checkpoints and RPC refer to
    flows by registered name, never by arbitrary class path."""

    def __init__(self):
        self._by_name: dict[str, type] = {}

    def register(self, cls: type, name: str | None = None) -> type:
        flow_name = name or cls.__qualname__
        existing = self._by_name.get(flow_name)
        if existing is not None and existing is not cls:
            raise ValueError(f"flow name {flow_name!r} already registered")
        self._by_name[flow_name] = cls
        cls.flow_name = flow_name
        return cls

    def create(self, name: str, args: tuple) -> "FlowLogic":
        cls = self._by_name.get(name)
        if cls is None:
            raise FlowException(f"flow {name!r} is not whitelisted")
        return cls(*args)

    def get(self, name: str) -> type | None:
        return self._by_name.get(name)


flow_registry = FlowRegistry()


def register_flow(cls: type | None = None, *, name: str | None = None):
    """Decorator: whitelist a FlowLogic subclass for checkpoint/RPC creation."""
    if cls is None:
        return lambda c: flow_registry.register(c, name)
    return flow_registry.register(cls)


# ---------------------------------------------------------------------------
# FlowLogic
# ---------------------------------------------------------------------------


class FlowLogic:
    """Base class for multi-party protocols (reference: FlowLogic.kt:28).

    Subclasses implement call() as a generator (or a plain method for flows
    with no suspensions). Constructor parameters must be stored as same-named
    attributes — checkpoints capture them via the constructor signature
    (checkpoint_args) and rebuild the flow with cls(*args).
    """

    flow_name: str = ""  # set by @register_flow

    # Injected by the state machine manager before the first step:
    service_hub = None
    state_machine = None  # the FlowStateMachine driving this logic
    progress_tracker = None
    # Session namespace: "" for a top-level flow; sub-flows get a fresh scope
    # unless they share the parent's sessions (reference: subFlow
    # shareParentSessions, DataVendingService.kt NotifyTransactionHandler).
    _session_scope: str = ""

    def call(self):
        raise NotImplementedError

    def _my_flow_name(self) -> str:
        return type(self).flow_name or type(self).__qualname__

    # -- effect constructors (yield these) --------------------------------

    def send(self, party: Party, payload: Any) -> SendRequest:
        return SendRequest(party, payload, self._session_scope, self._my_flow_name())

    def receive(self, party: Party, expected_type: type = object) -> ReceiveRequest:
        return ReceiveRequest(
            party, expected_type, self._session_scope, self._my_flow_name()
        )

    def send_and_receive(
        self, party: Party, payload: Any, expected_type: type = object
    ) -> SendAndReceiveRequest:
        return SendAndReceiveRequest(
            party, payload, expected_type, self._session_scope, self._my_flow_name()
        )

    def verify_signatures_batched(
        self, stx: "SignedTransaction", *allowed_to_be_missing: CompositeKey
    ) -> VerifyTxRequest:
        return VerifyTxRequest(stx, tuple(allowed_to_be_missing))

    def verify_signature_batched(self, sig, content: bytes) -> VerifySigRequest:
        """Validate one signature over `content` via the verify pump
        (`yield` it; raises SignatureError on mismatch when resumed)."""
        return VerifySigRequest(
            bytes(sig.by.encoded), bytes(content), bytes(sig.bytes),
            description=f"by {sig.by}")

    def service_request(self, start: Callable) -> ServiceRequest:
        """Suspend on an async node service; see ServiceRequest."""
        return ServiceRequest(start)

    @staticmethod
    def check_counterparty_signature(sig, content: bytes, counterparty: Party):
        """Shared validator for a returned co-signature: it must be a real
        signature, BY the counterparty's key, over `content` — any other
        valid signature would only fail much later (post-notarisation) as
        missing signatures."""
        from ..crypto.keys import DigitalSignature

        if not isinstance(sig, DigitalSignature.WithKey):
            raise FlowException("expected the counterparty's signature")
        if sig.by not in counterparty.owning_key.keys:
            raise FlowException(
                f"signature is not by the counterparty {counterparty}")
        sig.verify(content)
        return sig

    def sub_flow(
        self, flow: "FlowLogic", share_parent_sessions: bool = False
    ) -> Generator:
        """Run a child flow inline (reference: FlowLogic.kt:98-109). Use
        `yield from`. By default the child opens its own sessions (so e.g. a
        notary's fetch sub-flow talks to the counterparty's data-vending
        responder, not its pending notarisation session); pass
        share_parent_sessions=True to reuse this flow's sessions."""
        flow.service_hub = self.service_hub
        flow.state_machine = self.state_machine
        if share_parent_sessions:
            flow._session_scope = self._session_scope
        else:
            flow._session_scope = self.state_machine.allocate_subflow_scope()
        result = flow.call()
        if inspect.isgenerator(result):
            result = yield from result
        return result

    # -- checkpoint support ------------------------------------------------

    _ckpt_params_cache: dict = {}  # flow class -> constructor param names

    def checkpoint_args(self) -> tuple:
        """The constructor arguments, recovered by signature convention."""
        cls = type(self)
        pnames = FlowLogic._ckpt_params_cache.get(cls)
        if pnames is None:
            sig = inspect.signature(cls.__init__)
            pnames = []
            for pname, param in list(sig.parameters.items())[1:]:  # skip self
                if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
                    raise FlowException(
                        f"{cls.__name__}: *args/**kwargs constructors are not "
                        "checkpointable; use explicit parameters"
                    )
                pnames.append(pname)
            pnames = FlowLogic._ckpt_params_cache[cls] = tuple(pnames)
        args = []
        for pname in pnames:
            if not hasattr(self, pname):
                raise FlowException(
                    f"{cls.__name__}: constructor parameter {pname!r} must be "
                    "stored as attribute self.{pname} for checkpointing"
                )
            args.append(getattr(self, pname))
        return tuple(args)

    @property
    def run_id(self):
        return self.state_machine.run_id if self.state_machine else None

    def record_transactions(self, txs) -> None:
        """Store transactions WITH provenance: in addition to
        ServiceHub.record_transactions, each tx is mapped to this flow's
        run id in the provenance log (reference: ServiceHubInternal
        recording into StateMachineRecordedTransactionMappingStorage.kt) —
        flows should record through this, not the hub directly, so the
        explorer can attribute ledger activity to protocol runs."""
        self.service_hub.record_transactions(txs, run_id=self.run_id)
