"""The span-name registry: every stage name the tracing subsystem records.

``collect.stage_breakdown`` attributes latency by matching span names
against fixed tuples; a span recorded under a name missing from those
tuples is silently invisible in the breakdown — the failure mode is not an
error but a stage that never shows up in the bench report. This module is
the single source of truth both sides key on:

  * ``collect.py`` builds its attribution tables from these tuples, so the
    breakdown can never drift from the registry;
  * the static invariant analyzer (``corda_tpu.analysis``, rule
    ``trace-stage-registry``) checks every literal span name passed to
    ``_obs.record(...)`` anywhere in the tree against ``SPAN_NAMES`` /
    ``SPAN_NAME_PREFIXES``, so an instrumentation site with a typo'd or
    unregistered name fails tier-1 instead of silently dropping out of
    ``stage_breakdown``.

Adding a stage is therefore a two-line change HERE (name + ordering slot),
after which the analyzer permits the recording site and the breakdown
reports it.

Stdlib-only like the rest of ``obs`` — the analyzer imports this module
from a bare CLI process.

The port's own copy of ``corda_tpu/obs/stages.py``: the same stage and
span names, so a breakdown or trace from either package reads the same,
and beyond them the port's own ``PROVIDER_SPANS``.
"""

from __future__ import annotations

__all__ = [
    "BATCH_STAGES",
    "DIRECT_STAGES",
    "DERIVED_STAGES",
    "STAGES",
    "MARKER_SPANS",
    "PROVIDER_SPANS",
    "SPAN_NAME_PREFIXES",
    "SPAN_NAMES",
]

# Batch-level stages: recorded once per batch, attributed to every trace in
# attrs["member_traces"]. sidecar_wait/sidecar_verify DECOMPOSE
# device_verify for sidecar-routed batches (crypto/sidecar.py);
# federation_route/remote_verify decompose it one level further for
# federation-routed batches (crypto/federation.py): the routing decision
# and the winning host's full round trip, which CONTAINS that host's
# sidecar_wait/sidecar_verify.
BATCH_STAGES = ("queue_wait", "device_verify", "federation_route",
                "remote_verify", "sidecar_wait",
                "sidecar_verify", "raft_append", "fsync", "replication")

# Per-trace measured stage spans. shard_reserve/shard_commit are the two
# phases of the cross-shard 2PC coordinator (node/services/sharding.py).
# admission_wait is the client-side backoff park after an OverloadedError
# shed (flows/notary.py); epoch_wait is the same park when the request
# bounced off a reshard fence (WrongShardEpoch) and the client re-derives
# the shard directory; lane_queue_wait is time spent runnable behind
# the QoS lane scheduler before the pump picked the flow (statemachine).
# scrub is one online-scrubber / fsck verification pass over a store's
# integrity-framed tables (node/services/integrity.py); repair is one
# self-healing action — a raft-log truncate/compact or a checkpoint
# quarantine (raft._heal_corrupt_entry, persistence.quarantine).
# vault_query is one vault read — a VaultQuery page or a select_coins
# walk (node/services/vault.py, attrs["op"] names which); when it
# dominates a flow's breakdown the doctor's vault_scan rule suggests
# arming the indexed engine.
DIRECT_STAGES = ("verify_wait", "admission_wait", "epoch_wait",
                 "lane_queue_wait", "shard_reserve", "shard_commit",
                 "scrub", "repair", "vault_query")

# Derived by stage_breakdown, never recorded: the reply tail is
# root_end - max(attributed stage end).
DERIVED_STAGES = ("reply",)

# Full breakdown order the bench report presents.
STAGES = ("admission_wait", "epoch_wait", "queue_wait", "lane_queue_wait",
          "vault_query", "verify_wait",
          "device_verify", "federation_route", "remote_verify",
          "sidecar_wait", "sidecar_verify",
          "shard_reserve", "shard_commit",
          "raft_append", "fsync", "replication",
          "scrub", "repair", "reply")

# Stitch markers: recorded per trace to bound the derived reply tail and
# anchor cross-node correlation, but not themselves breakdown stages.
# qos_flush marks a deadline-triggered early flush/seal at one of the
# three QoS queueing points (attrs["point"] names which); shard_handoff
# is recorded once per completed reshard handoff by the source-group
# coordinator (attrs carry epoch/from/to/frames); election is recorded
# by the NEW leader once per won election, spanning candidacy start to
# the win (attrs carry term/prevote — partition plane, round 20).
MARKER_SPANS = ("raft_commit", "notary_process", "qos_flush",
                "shard_handoff", "election")

# The port's own, recorded into obs/trace.py's VERIFY ring by the device
# verify provider (crypto/provider.py TorchVerifier) while the torch
# profiler collects, one trace a batch:
# provider_verify over the whole verify_batch call (its time outside the
# other three is the dispatch), and under it provider_pack (the host
# packing), provider_copy_in (the words to the device) and
# provider_device_wait (the launches and the host blocked on the results).
# Not breakdown stages: they split a batch, not a transaction.
PROVIDER_SPANS = ("provider_verify", "provider_pack", "provider_copy_in",
                  "provider_device_wait")

# Dynamic span families: a recorded name may start with one of these
# prefixes (the root flow span is f"flow:{FlowClassName}").
SPAN_NAME_PREFIXES = ("flow:",)

# Every literal name a recording site may pass to SpanRecorder.record().
SPAN_NAMES = frozenset(BATCH_STAGES) | frozenset(DIRECT_STAGES) \
    | frozenset(MARKER_SPANS) | frozenset(PROVIDER_SPANS)
