"""Console rendering of flow progress.

Capability match for the reference's ANSIProgressRenderer (reference:
node/src/main/kotlin/net/corda/node/utilities/ANSIProgressRenderer.kt:27 —
live console display of a flow's hierarchical progress). Follows the state
machine manager's bounded event feed: call poll() from any loop to print
(and get back) the lines for new events; `in_flight` snapshots the current
step path per live flow.

The port's own copy of ``corda_tpu/utils/progress_render.py``.
"""

from __future__ import annotations

import sys


class ProgressRenderer:
    def __init__(self, smm, out=None):
        self._smm = smm
        self._out = out or sys.stderr
        self._cursor = 0
        self._live: dict[bytes, tuple[str, ...]] = {}

    def poll(self) -> list[str]:
        """Consume new events; returns the lines that were rendered."""
        self._cursor, events = self._smm.changes.since(self._cursor)
        lines = []
        for event in events:
            kind = event[0]
            if kind == "add":
                self._live[event[1]] = ("started",)
                lines.append(f"[{event[1].hex()[:8]}] started")
            elif kind == "remove":
                self._live.pop(event[1], None)
                lines.append(f"[{event[1].hex()[:8]}] finished")
            elif kind == "progress":
                _, run_id, path = event
                self._live[run_id] = path
                lines.append(f"[{run_id.hex()[:8]}] " + " / ".join(path))
        for line in lines:
            print(line, file=self._out)
        return lines

    @property
    def in_flight(self) -> dict[bytes, tuple[str, ...]]:
        return dict(self._live)
