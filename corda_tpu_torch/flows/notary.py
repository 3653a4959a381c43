"""Notary flows: the uniqueness-consensus round trip — the north-star path.

The port's own copy of ``corda_tpu/flows/notary.py``.

Capability match for the reference's NotaryFlow (reference:
core/src/main/kotlin/net/corda/flows/NotaryFlow.kt) and ValidatingNotaryFlow
(core/.../flows/ValidatingNotaryFlow.kt). Protocol (NotaryFlow.kt:96-147):

  client: verify own signatures → sendAndReceive(SignRequest) → validate reply
  notary: receive → validate timestamp → beforeCommit (validating variant:
          check signatures + resolve dependencies + run contracts) → commit
          inputs to the uniqueness provider → sign tx id → reply

The batched difference: every signature check suspends into the node's
micro-batched verifier (VerifyTxRequest) so concurrent notarisation requests
verify as ONE kernel batch — the reference's sequential hot loop
(SignedTransaction.kt:83-87) becomes the batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.composite import CompositeKey
from ..crypto.hashes import SecureHash
from ..obs import trace as _obs
from ..crypto.keys import DigitalSignature, SignatureError
from ..crypto.party import Party
from ..crypto.signed_data import SignedData
from ..serialization.codec import register
from ..transactions.signed import SignaturesMissingException, SignedTransaction
from ..utils.progress import ProgressTracker, Step
from .api import FlowException, FlowLogic, FlowSessionException, register_flow


# ---------------------------------------------------------------------------
# Wire types (reference: NotaryFlow.kt:150-158) and errors (:163-183)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class SignRequest:
    tx: SignedTransaction
    caller_identity: Party


@register
@dataclass(frozen=True)
class NotarySuccess:
    sig: DigitalSignature.WithKey


@register
@dataclass(frozen=True)
class NotaryFailure:
    error: "NotaryError"


class NotaryError:
    """Marker base (reference: NotaryError sealed class)."""


@register
@dataclass(frozen=True)
class NotaryConflict(NotaryError):
    """Input(s) already consumed; conflict evidence signed by the notary."""

    tx_id: SecureHash
    signed_conflict: SignedData

    def __str__(self):
        return (
            f"One or more input states for transaction {self.tx_id} have been "
            "used in another transaction"
        )


@register
@dataclass(frozen=True)
class NotaryTimestampInvalid(NotaryError):
    pass


@register
@dataclass(frozen=True)
class NotaryTransactionInvalid(NotaryError):
    pass


@register
@dataclass(frozen=True)
class NotaryUnavailable(NotaryError):
    """The notary could not decide in time (e.g. a Raft leadership episode
    outlasted the commit window). RETRYABLE: unlike the other errors this
    says nothing about the transaction — resubmitting the same tx later is
    safe and expected (commit is idempotent, first-committer-wins).

    leader_hint: the legal name of the cluster member the service believes
    is the current Raft leader (None when unknown) — a retrying client can
    re-send straight to the leader instead of waiting out another redirect
    round trip."""

    reason: str = ""
    leader_hint: str | None = None

    def __str__(self):
        return f"Notary service temporarily unavailable: {self.reason}"


@register
@dataclass(frozen=True)
class OverloadedError(NotaryError):
    """Admission control shed the request at the notarise entry point
    before any verification or consensus work was done. RETRYABLE like
    NotaryUnavailable: says nothing about the transaction — only that the
    service chose to shed THIS lane's load right now. retry_after_ms is
    the server's backoff suggestion (token-bucket refill estimate, capped);
    notarise_with_retry uses it as the floor for its next park."""

    lane: str = ""
    retry_after_ms: float = 0.0

    def __str__(self):
        return (f"Notary admission control shed {self.lane or 'request'} "
                f"load (retry after {self.retry_after_ms:.0f} ms)")


@register
@dataclass(frozen=True)
class WrongShardEpoch(NotaryError):
    """The shard group that received the request does not own (some of) the
    touched states under the shard-map epoch it currently enforces — a
    reshard landed between the client deriving its directory and the
    commit applying. RETRYABLE like NotaryUnavailable, with one extra
    obligation: re-sending to the SAME member can never succeed, so
    notarise_with_retry re-derives the shard directory from the network
    map before its next attempt."""

    reason: str = ""

    def __str__(self):
        return (f"Notary shard map changed underneath the request "
                f"(re-derive the directory): {self.reason}")


@register
@dataclass(frozen=True)
class NotarySignaturesMissing(NotaryError):
    missing: frozenset

    def __str__(self):
        return f"Missing signatures from: {sorted(self.missing, key=repr)}"


from ..utils.excheckpoint import register_flow_exception


@register_flow_exception
class NotaryException(FlowException):
    """Carries the structured NotaryError through checkpoint replay so
    restored flows can branch on error kind exactly as live ones do."""

    def __init__(self, error: NotaryError):
        super().__init__(f"Error response from Notary - {error}")
        self.error = error

    def __checkpoint_payload__(self):
        return self.error

    @classmethod
    def __from_checkpoint__(cls, message, payload):
        return cls(payload)


# ---------------------------------------------------------------------------
# Client (reference: NotaryFlow.kt:24-81)
# ---------------------------------------------------------------------------


@register_flow
class NotaryClientFlow(FlowLogic):
    """Obtain the notary's uniqueness signature over a transaction.

    Progress steps mirror the reference's NotaryFlow tracker
    (NotaryFlow.kt REQUESTING/VALIDATING)."""

    def __init__(self, stx: SignedTransaction, via: Party | None = None):
        self.stx = stx
        # Optional override of WHICH cluster member receives the request
        # (leader redirect): the tx's notary identity still governs state
        # checks, but the wire request goes to `via`. Cluster members are
        # mutually trusted replicas of one service, so a signature by the
        # via-member's service key is accepted.
        self.via = via
        self.VERIFYING = Step("Verifying our signatures")
        self.REQUESTING = Step("Requesting signature by notary service")
        self.VALIDATING = Step("Validating response from notary service")
        self.progress_tracker = ProgressTracker(
            self.VERIFYING, self.REQUESTING, self.VALIDATING)

    def call(self):
        wtx = self.stx.tx
        notary_party = wtx.notary
        if notary_party is None:
            raise FlowException("Transaction does not specify a Notary")
        for ref in wtx.inputs:
            state = self.service_hub.load_state(ref)
            if state is not None and state.notary != notary_party:
                raise FlowException("Input states must have the same Notary")
        # Check our own signature set (batched with everything else pending
        # on this node); the notary's signature is the one allowed missing.
        self.progress_tracker.current_step = self.VERIFYING
        try:
            yield self.verify_signatures_batched(self.stx, notary_party.owning_key)
        except SignatureError as e:
            raise NotaryException(
                NotarySignaturesMissing(frozenset(self.stx.get_missing_signatures()))
            ) from e

        self.progress_tracker.current_step = self.REQUESTING
        target = self.via if self.via is not None else notary_party
        request = SignRequest(self.stx, self.service_hub.my_identity)
        response = yield self.send_and_receive(target, request)
        self.progress_tracker.current_step = self.VALIDATING
        result = response.unwrap()

        if isinstance(result, NotarySuccess):
            sig = result.sig
            if sig.by not in target.owning_key.keys:
                raise FlowException("Invalid signer for the notary result")
            # Validate through the verify pump: N concurrent clients share
            # one kernel call instead of N host-oracle verifications
            # (reference: NotaryFlow.kt:58-80 validateSignature, sequential).
            yield self.verify_signature_batched(sig, self.stx.id.bytes)
            return sig
        if isinstance(result, NotaryFailure):
            if isinstance(result.error, NotaryConflict):
                result.error.signed_conflict.verified()  # authenticates evidence
            raise NotaryException(result.error)
        raise FlowSessionException(
            f"Received invalid result from Notary service {notary_party}"
        )


def _resolve_member(flow: FlowLogic, legal_name: str) -> Party | None:
    """Map a leader_hint legal name to a Party via the network map."""
    try:
        cache = flow.service_hub.network_map_cache
        for info in cache.party_nodes:
            if info.legal_identity.name == legal_name:
                return info.legal_identity
    except AttributeError:
        # leader_hint is an optimisation: a hub without a network-map cache
        # (minimal test fixtures) just means no hint, not a failure. Any
        # other exception propagates — a broken map must surface.
        return None
    return None


def _shard_directory(flow: FlowLogic):
    """Discover the sharded-notary topology from the network map: members
    of shard group g advertise "corda.notary.shard.<g>of<n>[@epoch]", so
    the map every party already syncs doubles as the shard directory.
    Returns (count, {group: [Party, ...]}) or None when unsharded.

    Epoch-aware: mid-reshard the map mixes advertisements from two epochs
    (members re-register as their fences activate). Prefer the highest
    COMPLETE epoch — one with all of its `count` groups present — so the
    client only adopts a new map once it can actually route everywhere;
    when no epoch is complete (a refresh raced the re-registrations), fall
    back to the epoch with the greatest group coverage, ties to the newer.
    A wrong pick is never a correctness problem: the group's fence bounces
    WrongShardEpoch and the retry re-derives."""
    from ..node.services.sharding import parse_shard_service_full

    # epoch -> (count, {group: [Party, ...]})
    epochs: dict[int, tuple[int, dict[int, list[Party]]]] = {}
    try:
        for info in flow.service_hub.network_map_cache.party_nodes:
            for svc in info.advertised_services:
                parsed = parse_shard_service_full(str(svc.type))
                if parsed is not None:
                    g, n, e = parsed
                    count, groups = epochs.setdefault(e, (n, {}))
                    if n > count:
                        epochs[e] = (n, groups)
                    groups.setdefault(g, []).append(info.legal_identity)
    except Exception:
        return None
    best = None
    for e, (count, groups) in epochs.items():
        complete = len(groups) >= count
        key = (1 if complete else 0, len(groups) if not complete else 0, e)
        if best is None or key > best[0]:
            best = (key, count, groups)
    if best is None:
        return None
    _, count, groups = best
    if count <= 1 or not groups:
        return None
    for members in groups.values():
        members.sort(key=lambda p: p.name)
    return count, groups


def _route_group(stx: SignedTransaction, directory) -> int | None:
    """Owning group for routing: the first input's shard (for a
    single-shard tx that IS the owning group — the fast path; for a
    cross-shard tx it picks the coordinator deterministically). None when
    unsharded or the tx has no inputs (an issuance commits anywhere)."""
    if directory is None:
        return None
    inputs = stx.tx.inputs
    if not inputs:
        return None
    from ..node.services.sharding import shard_of

    return shard_of(inputs[0], directory[0])


def _timer_poll(wake_at: float):
    """Non-blocking in-flow backoff: a ServiceRequest poll that stays
    pending until `wake_at` (time.monotonic). Sleeping in place would
    starve the run loop the retry depends on."""
    import time as _time

    return lambda: (True if _time.monotonic() >= wake_at else None)


def notarise_with_retry(flow: FlowLogic, stx: SignedTransaction,
                        retries: int = 2, on_attempt=None,
                        deadline_s: float | None = None,
                        backoff_s: float = 0.1,
                        max_backoff_s: float = 2.0):
    """yield-from helper: notarise `stx` via a fresh NotaryClientFlow per
    attempt, retrying ONLY the RETRYABLE NotaryUnavailable error (a
    consensus window elapsing says nothing about the tx, and commit is
    idempotent first-committer-wins). A fresh sub-flow per attempt matters:
    each one opens its own session, because the service flow ends after
    replying. `on_attempt(notary_flow)` lets callers hook up progress
    trackers.

    The retry budget is bounded two ways: `retries` counts attempts, and
    `deadline_s` (when set) REPLACES the count with a wall-clock budget —
    retry until the deadline, however many attempts that is. Between
    attempts the flow parks on a ServiceRequest timer (exponential backoff
    from `backoff_s` up to `max_backoff_s`) instead of hammering a cluster
    mid-election. When the failure carries a `leader_hint` (the Raft
    provider knows who leads now), the next attempt is sent straight to
    that member via NotaryClientFlow(via=...) instead of re-traversing a
    redirect.

    Leader hints are keyed PER GROUP: with a sharded notary there are N
    independent Raft clusters, and a hint from one shard's deposed leader
    names a member of THAT group only — applying it to a request routed at
    another group would aim the retry at a node that is not even a member
    of the deciding cluster. Sharded topologies are discovered from the
    network map (see _shard_directory) and requests route to the owning
    group of the tx's first input, so single-shard traffic lands on its
    group's coordinator directly (the fast path).

    The load/bench tools (loadgen, loadtest, demo_cordapp) deliberately
    call NotaryClientFlow raw — retries there would mask the availability
    behaviour they exist to measure."""
    import time as _time

    deadline = None if deadline_s is None else _time.monotonic() + deadline_s
    attempt = 0
    backoff = backoff_s

    def derive():
        directory = _shard_directory(flow)
        group = _route_group(stx, directory)
        members = (frozenset(p.name for p in directory[1].get(group, ()))
                   if directory is not None and group is not None else None)
        return directory, group, members

    directory, group, group_members = derive()
    # group id -> preferred member; None key = the unsharded single cluster.
    hints: dict = {}
    while True:
        via: Party | None = hints.get(group)
        if via is None and group is not None:
            members = directory[1].get(group)
            if members:
                via = members[0]
        notary_flow = NotaryClientFlow(stx, via=via)
        if on_attempt is not None:
            on_attempt(notary_flow)
        try:
            return (yield from flow.sub_flow(notary_flow))
        except NotaryException as e:
            # OverloadedError is the admission-control shed: retryable for
            # the same reason NotaryUnavailable is — nothing was decided
            # about the transaction, the service just declined the work.
            # WrongShardEpoch is retryable too (a fence bounce decides
            # nothing), but ONLY after re-deriving the shard directory:
            # the member that bounced will bounce forever.
            if not isinstance(e.error, (NotaryUnavailable, OverloadedError,
                                        WrongShardEpoch)):
                raise
            attempt += 1
            now = _time.monotonic()
            if (deadline is None and attempt > retries) or \
                    (deadline is not None and now >= deadline):
                raise
            shed = isinstance(e.error, OverloadedError)
            epoch_bump = isinstance(e.error, WrongShardEpoch)
            if epoch_bump:
                # The map moved underneath us: rebuild directory, routing
                # group and the hint filter from the refreshed network map,
                # and drop the stale group's preferred-member hint (it
                # belongs to the old topology).
                hints.pop(group, None)
                directory, group, group_members = derive()
            if shed and e.error.retry_after_ms > 0:
                # The server's refill estimate floors the park: retrying
                # sooner would just be shed again at the same bucket.
                backoff = max(backoff, e.error.retry_after_ms / 1e3)
            hint = getattr(e.error, "leader_hint", None)
            if hint:
                resolved = _resolve_member(flow, hint)
                # The hint redirects only the group THIS attempt was
                # routed at; with a shard directory in hand, drop hints
                # naming non-members of that group outright.
                if resolved is not None and (
                        group_members is None
                        or resolved.name in group_members):
                    hints[group] = resolved
            if backoff > 0:
                wake_at = now + min(backoff, max_backoff_s)
                if deadline is not None:
                    wake_at = min(wake_at, deadline)
                pctx = (_obs.get_context()
                        if (shed or epoch_bump) and _obs.ACTIVE is not None
                        else None)
                t_park = _obs.now() if pctx is not None else 0.0
                yield flow.service_request(
                    lambda wake_at=wake_at: _timer_poll(wake_at))
                if pctx is not None and _obs.ACTIVE is not None:
                    # Client-side cost of the shed (admission_wait) or of a
                    # reshard racing this request (epoch_wait): the backoff
                    # park shows up in the stage breakdown either way.
                    if epoch_bump:
                        _obs.record("epoch_wait", t_park, _obs.now(),
                                    trace_id=pctx[0], parent=pctx[1],
                                    attrs={"attempt": attempt})
                    else:
                        _obs.record("admission_wait", t_park, _obs.now(),
                                    trace_id=pctx[0], parent=pctx[1],
                                    attrs={"lane": e.error.lane,
                                           "attempt": attempt})
                backoff = min(backoff * 2, max_backoff_s)


# ---------------------------------------------------------------------------
# Service (reference: NotaryFlow.kt:96-147)
# ---------------------------------------------------------------------------


@register_flow
class NotaryServiceFlow(FlowLogic):
    """The non-validating notary: commits inputs without seeing history.

    `service` is the node's NotaryServiceBase (a checkpoint token) exposing
    timestamp_checker, uniqueness_provider and signing.
    """

    def __init__(self, other_side: Party, service):
        self.other_side = other_side
        self.service = service

    def call(self):
        req = yield self.receive(self.other_side, SignRequest)
        t0 = _obs.now() if _obs.ACTIVE is not None else 0.0
        try:
            request = req.unwrap(self._validate_request)
            self._admit_or_shed()
            stx = request.tx
            req_identity = request.caller_identity
            wtx = stx.tx
            self._validate_timestamp(wtx)
            yield from self.before_commit(stx, req_identity)
            yield from self._commit_input_states(wtx, req_identity)
            sig = self.service.sign(stx.id.bytes)
            result = NotarySuccess(sig)
        except NotaryException as e:
            result = NotaryFailure(e.error)
        except Exception:
            # Malformed request payloads (tx_bits/id mismatch, wrong-shaped
            # message) and unexpected internal errors must produce a
            # diagnosable notary error, not a generic session death
            # (reference gap noted at NotaryFlow.kt:96-113). If the primary
            # session itself is dead, the send below fails and ends the flow.
            # Logged: an internal error (e.g. a failing commit-log write)
            # reported to the client as "invalid" needs an operator trail.
            import logging

            logging.getLogger(__name__).exception(
                "notary service flow error; replying NotaryTransactionInvalid"
            )
            result = NotaryFailure(NotaryTransactionInvalid())
        if _obs.ACTIVE is not None:
            sm = self.state_machine
            if sm.trace_id is not None and not sm.replaying:
                # request received -> reply queued, stitched into the
                # client's trace (the service fsm joined it at SessionInit).
                # Skipped on checkpoint replay: the live run already
                # recorded it.
                _obs.record("notary_process", t0, _obs.now(),
                            trace_id=sm.trace_id, parent=sm.trace_span,
                            attrs={"ok": isinstance(result, NotarySuccess)})
        yield self.send(self.other_side, result)
        return None

    @staticmethod
    def _validate_request(request):
        if not isinstance(request, SignRequest):
            raise ValueError(f"Expected SignRequest, got {type(request).__name__}")
        return request

    def _admit_or_shed(self) -> None:
        """QoS admission control at the notarise entry point: consult the
        node's AdmissionController (attached to the service token when
        [qos] enabled; absent otherwise — zero work on the disabled path)
        BEFORE any verify/consensus work. A shed raises the retryable
        OverloadedError, which rides the ordinary NotaryFailure reply."""
        admission = getattr(self.service, "admission", None)
        if admission is None:
            return
        from ..qos.context import LANE_INTERACTIVE

        sm = self.state_machine
        qctx = getattr(sm, "qos", None)
        # Unlabelled traffic admits through the interactive bucket: legacy
        # clients must never be out-prioritised by labelled bulk load.
        lane = qctx.lane if qctx is not None else LANE_INTERACTIVE
        depth = sm.manager.qos_queue_depth()
        retry_after_s = admission.admit(lane, depth)
        if retry_after_s is not None:
            raise NotaryException(
                OverloadedError(lane, retry_after_s * 1e3))

    def _validate_timestamp(self, wtx) -> None:
        if wtx.timestamp is not None and not self.service.timestamp_checker.is_valid(
            wtx.timestamp
        ):
            raise NotaryException(NotaryTimestampInvalid())

    def before_commit(self, stx: SignedTransaction, req_identity: Party):
        """Non-validating: no history check (NotaryFlow.kt:121-130)."""
        return
        yield  # pragma: no cover — makes this a generator for yield-from

    def _commit_input_states(self, wtx, req_identity: Party):
        """Commit via the uniqueness provider. Async providers (the Raft
        cluster) expose commit_async -> poll; the flow suspends on it so the
        node keeps pumping consensus traffic (blocking in-place would starve
        the very message loop the quorum round needs). Generator either way
        (yield-from'd by call())."""
        from ..node.services.api import (
            UniquenessException,
            UniquenessUnavailableException,
        )
        from ..node.services.raft import (
            CommitQueueFullException,
            WrongShardEpochException,
        )
        from ..serialization.codec import serialize

        provider = self.service.uniqueness_provider
        try:
            if hasattr(provider, "commit_async"):
                yield self.service_request(
                    lambda: provider.commit_async(
                        wtx.inputs, wtx.id, req_identity))
            else:
                provider.commit(wtx.inputs, wtx.id, req_identity)
        except UniquenessException as e:
            conflict_data = serialize(e.error)
            signed = SignedData(conflict_data, self.service.sign(conflict_data.bytes))
            raise NotaryException(NotaryConflict(wtx.id, signed)) from e
        except CommitQueueFullException as e:
            # Must precede the generic unavailability mapping (subclass):
            # a full commit queue is the pipelined apply executor's
            # admission shed — surface it as the SAME retryable overload
            # error the QoS admission plane uses, so notarise_with_retry's
            # shed-backoff handling covers both layers.
            raise NotaryException(OverloadedError(
                "commit", CommitQueueFullException.RETRY_AFTER_MS)) from e
        except WrongShardEpochException as e:
            # Must precede the generic unavailability mapping (it is a
            # subclass): a fence bounce is retryable but the client has to
            # re-derive the shard directory first — a leader hint for the
            # OLD routing would aim the retry at the same fence.
            raise NotaryException(WrongShardEpoch(str(e))) from e
        except UniquenessUnavailableException as e:
            # A consensus window elapsing says NOTHING about the tx: reply
            # with the RETRYABLE unavailability error, never "transaction
            # invalid" (which would mislead a client into abandoning a
            # perfectly good transaction). Attach the provider's current
            # leader hint so the client's retry can go straight there.
            hint = getattr(provider, "leader_hint", None)
            if callable(hint):
                try:
                    hint = hint()
                except Exception:
                    hint = None
            raise NotaryException(NotaryUnavailable(str(e), hint)) from e


@register_flow
class ValidatingNotaryFlow(NotaryServiceFlow):
    """Fully validates the transaction (signatures, dependency resolution,
    contract code) before committing (reference: ValidatingNotaryFlow.kt:23-50).
    The caller reveals its transaction history in exchange for stronger
    notarisation guarantees."""

    def before_commit(self, stx: SignedTransaction, req_identity: Party):
        from ..contracts.verification import TransactionVerificationException
        from .resolve import ResolveTransactionsFlow

        try:
            # THE hot spot: micro-batched across all concurrent requests.
            try:
                yield self.verify_signatures_batched(
                    stx, self.service.notary_identity.owning_key
                )
            except SignaturesMissingException as e:
                # Typed distinction, preserved across checkpoint replay
                # (reference branches on the exception type the same way,
                # ValidatingNotaryFlow.kt:39-45).
                raise NotaryException(
                    NotarySignaturesMissing(frozenset(e.missing))
                ) from e
            wtx = stx.tx
            yield from self.sub_flow(ResolveTransactionsFlow(wtx, self.other_side))
            wtx.to_ledger_transaction(self.service_hub).verify()
        except NotaryException:
            raise
        except (TransactionVerificationException, SignatureError) as e:
            raise NotaryException(NotaryTransactionInvalid()) from e
