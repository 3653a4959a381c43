"""Hierarchical progress tracking for flows.

The port's own copy of ``corda_tpu/utils/progress.py``.

Capability match for the reference's ProgressTracker (reference:
core/src/main/kotlin/net/corda/core/utilities/ProgressTracker.kt:35): a flow
declares its steps up front, moves a cursor through them, and can splice a
child tracker under a step (sub-flow progress). Observers receive a flat
change stream (the reference exposes an rx Observable; here a subscription
list — the client RPC layer forwards it the same way,
reference: node/.../messaging/CordaRPCOps.kt:66-67).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Step:
    label: str


DONE = Step("Done")
UNSTARTED = Step("Unstarted")


@dataclass(frozen=True)
class Change:
    """One progress event: the tracker's path to the current step."""

    path: tuple[str, ...]


class ProgressTracker:
    def __init__(self, *steps: Step):
        self.steps: tuple[Step, ...] = tuple(steps)
        self._index = -1  # UNSTARTED
        self._children: dict[Step, "ProgressTracker"] = {}
        self._observers: list[Callable[[Change], None]] = []
        self._parent: "ProgressTracker | None" = None

    # -- structure ---------------------------------------------------------

    def set_child_tracker(self, step: Step, child: "ProgressTracker") -> None:
        """Attach a sub-flow's tracker beneath one of our steps
        (ProgressTracker.kt childrenFor)."""
        self._children[step] = child
        child._parent = self

    def get_child_tracker(self, step: Step) -> "ProgressTracker | None":
        return self._children.get(step)

    # -- state -------------------------------------------------------------

    @property
    def current_step(self) -> Step:
        if self._index < 0:
            return UNSTARTED
        if self._index >= len(self.steps):
            return DONE
        return self.steps[self._index]

    @current_step.setter
    def current_step(self, step: Step) -> None:
        if step == DONE:
            self._index = len(self.steps)
        else:
            self._index = self.steps.index(step)
        self._emit()

    def next_step(self) -> Step:
        self._index += 1
        self._emit()
        return self.current_step

    # -- change stream -----------------------------------------------------

    def subscribe(self, observer: Callable[[Change], None]) -> None:
        self._observers.append(observer)

    def _path(self) -> tuple[str, ...]:
        parts: list[str] = [self.current_step.label]
        node = self
        while node._parent is not None:
            parent = node._parent
            for step, child in parent._children.items():
                if child is node:
                    parts.insert(0, step.label)
                    break
            node = parent
        return tuple(parts)

    def _emit(self) -> None:
        change = Change(self._path())
        node: ProgressTracker | None = self
        while node is not None:  # bubble to the root's observers too
            for obs in list(node._observers):
                obs(change)
            node = node._parent
