"""The Raft uniqueness provider's typed retry exceptions.

The port's own copy of the two exceptions of ``corda_tpu/node/services/
raft.py`` that the notary service flow maps to retryable client errors
(flows/notary.py ``_commit_input_states``). The rest of the module -- the
Raft member, its log and the uniqueness provider over it -- waits for the
raft/sharding slice (ROADMAP.md); until then the in-memory uniqueness
provider never raises these.
"""

from __future__ import annotations

from ...utils.excheckpoint import register_flow_exception
from .api import UniquenessUnavailableException


@register_flow_exception
class CommitQueueFullException(UniquenessUnavailableException):
    """The leader's bounded commit queue (the pipelined apply executor's
    admission point, [raft] apply_queue_depth) is full: NEW submissions
    shed instead of growing an unbounded committed-but-unapplied backlog.
    Retryable after a short backoff — says nothing about the transaction
    itself. The notary flow surfaces it as OverloadedError("commit") so
    clients reuse the QoS plane's shed-retry handling."""

    RETRY_AFTER_MS = 50.0


@register_flow_exception
class WrongShardEpochException(UniquenessUnavailableException):
    """The group bounced the command off a reshard fence: under the shard
    map the group currently enforces, it does not own (some of) the touched
    StateRefs. Retryable — but unlike a leaderless bounce, resubmitting to
    the SAME group can never succeed. The caller must re-derive the shard
    directory (network map) and route to the owning group at the new epoch.
    Subclasses UniquenessUnavailableException so catch sites that predate
    resharding still treat it as a retriable non-conflict."""
