"""Time-triggered flow scheduling from SchedulableStates.

Capability match for the reference's NodeSchedulerService +
ScheduledActivityObserver (reference: node/src/main/kotlin/net/corda/node/
services/events/NodeSchedulerService.kt:45-70, ScheduledActivityObserver.kt):
states on the ledger can request a flow run at a future time (e.g. an
interest-rate fixing); the scheduler watches vault updates, tracks the
earliest activity per state, and launches the whitelisted flow when due.

Differences by design: the reference persists ScheduledStateRefs and runs a
dedicated timer thread; here the schedule rebuilds from the vault on startup
(the vault itself rebuilds from durable transaction storage) and `tick()` is
driven by the node's single-threaded run loop — same capability, no timer
thread, no duplicate persistence.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...contracts.structures import SchedulableState, StateRef, now_micros
from ...flows.api import flow_registry
from ...serialization.codec import register


@register
@dataclass(frozen=True)
class ScheduledActivity:
    """What to run and when (reference: Structures.kt ScheduledActivity)."""

    flow_name: str
    flow_args: tuple
    at_micros: int


class NodeSchedulerService:
    def __init__(self, smm, vault_service):
        self._smm = smm
        self._scheduled: dict[StateRef, ScheduledActivity] = {}
        vault_service.subscribe(self._on_vault_update)
        # Startup: scan the vault for schedulable states — through the
        # paginated iterator, never a full snapshot copy.
        for sar in vault_service.iter_unconsumed():
            self._consider(sar)

    def _on_vault_update(self, update) -> None:
        for sar in update.consumed:
            self._scheduled.pop(sar.ref, None)
        for sar in update.produced:
            self._consider(sar)

    def _consider(self, sar) -> None:
        state = sar.state.data
        if not isinstance(state, SchedulableState):
            return
        activity = state.next_scheduled_activity(sar.ref, flow_registry.get)
        if activity is not None:
            self._scheduled[sar.ref] = activity

    @property
    def next_scheduled(self) -> tuple[StateRef, ScheduledActivity] | None:
        if not self._scheduled:
            return None
        return min(self._scheduled.items(), key=lambda kv: kv[1].at_micros)

    def tick(self, now: int | None = None) -> int:
        """Launch every due activity; returns how many started. Called from
        the node's run loop (NodeSchedulerService.kt:45-70 capability)."""
        now = now if now is not None else now_micros()
        started = 0
        for ref, activity in list(self._scheduled.items()):
            if activity.at_micros <= now:
                del self._scheduled[ref]
                logic = flow_registry.create(
                    activity.flow_name, tuple(activity.flow_args))
                self._smm.add(logic)
                started += 1
        return started
