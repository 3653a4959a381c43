"""History-based consistency auditor (partition plane, round 20).

A chaos/partition harness records what every CLIENT observed — one
``invoke`` event per submitted transaction plus exactly one outcome
event (``ok`` acked, ``fail`` final rejection, ``timeout`` gave up
undecided) — into a bounded :class:`History`.  After the run, the
harness reads the LEDGER side (the union of every member's
``committed_states`` rows: which tx consumed which state ref) and
:func:`check_history` replays the client history against it, proving
the first-committer-wins contract held through the faults:

  * **no lost ack** — every tx a client was told committed IS in the
    committed set (an ok ack followed by an absent tx means a leader
    acknowledged before quorum and the cut ate the commit);
  * **no double-spend** — no state ref is consumed by two different
    txs anywhere in the union (members on opposite sides of a
    split-brain committing different spenders shows up HERE);
  * **no lying rejection** — a tx a client was told *conflicted* must
    not itself appear committed (the reject and the commit cannot both
    be true);
  * **every timeout resolves** — a timed-out op is allowed either
    outcome, but exactly one: its tx is either in the committed set or
    absent, and its refs were not meanwhile split between spenders
    (covered by the double-spend scan over the same union);
  * **no minority commit** — the harness samples the minority side's
    committed rows while the cut holds and feeds the delta in; any
    advance means a leader without quorum applied state.

The checker is pure data-in/verdict-out (no node imports), so auditor
fixtures in the test suite construct histories and committed sets by
hand to prove each failure mode is actually caught.

The port's own copy of ``corda_tpu/testing/history.py`` (the partition
harness's linearizability audit).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

__all__ = ["HistoryEvent", "History", "check_history"]

#: Outcome kinds a client may record for an invocation.
OUTCOMES = ("ok", "fail", "timeout")


@dataclass(frozen=True)
class HistoryEvent:
    """One client-side observation.

    ``kind`` is ``invoke`` or one of :data:`OUTCOMES`; ``request_id``
    ties the outcome back to its invoke; ``tx_id`` / ``refs`` describe
    the transaction (hex/str keys — the checker never decodes them,
    it only compares); ``t`` is seconds on the harness clock;
    ``during_cut`` marks invocations submitted while a partition held.
    """

    kind: str
    client: str
    request_id: str
    tx_id: str = ""
    refs: tuple = ()
    t: float = 0.0
    during_cut: bool = False


class History:
    """Bounded append-only event log, one per harness run.

    The bound protects long soaks (a dropped oldest event can only make
    the checker MISS a violation, never invent one — and the default
    cap comfortably holds every bench/test workload)."""

    def __init__(self, cap: int = 100_000):
        self._events: deque[HistoryEvent] = deque(maxlen=cap)

    def record_invoke(self, client: str, request_id: str, tx_id: str,
                      refs=(), t: float = 0.0,
                      during_cut: bool = False) -> None:
        self._events.append(HistoryEvent(
            "invoke", client, request_id, tx_id, tuple(refs), t,
            during_cut))

    def record_outcome(self, client: str, request_id: str, kind: str,
                       t: float = 0.0) -> None:
        if kind not in OUTCOMES:
            raise ValueError(f"unknown outcome kind {kind!r}")
        self._events.append(HistoryEvent(kind, client, request_id, t=t))

    def events(self) -> list[HistoryEvent]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)


def check_history(history, committed_tx_ids, consumed=(),
                  minority_commits: int = 0) -> dict:
    """Replay *history* against the ledger; return the audit verdict.

    ``history`` is a :class:`History` or a plain iterable of
    :class:`HistoryEvent`; ``committed_tx_ids`` is the union of tx ids
    the ledger committed (any member); ``consumed`` is an iterable of
    ``(ref, tx_id)`` pairs drawn from EVERY member's committed rows —
    duplicates across members are expected (replication), two
    *different* tx ids for one ref are the split-brain smoking gun.

    The verdict dict is JSON-ready; ``history_linearizable`` is the
    single gate bit (True = every check passed)."""
    events = history.events() if isinstance(history, History) else \
        list(history)
    committed = set(committed_tx_ids)

    invokes: dict[str, HistoryEvent] = {}
    outcomes: dict[str, str] = {}
    duplicate_outcomes: list[str] = []
    for ev in events:
        if ev.kind == "invoke":
            invokes[ev.request_id] = ev
        elif ev.kind in OUTCOMES:
            if ev.request_id in outcomes:
                duplicate_outcomes.append(ev.request_id)
            outcomes[ev.request_id] = ev.kind

    # Ledger-side scan: one consumer per ref, ever.
    consumers: dict = {}
    double_spends: list = []
    for ref, tx_id in consumed:
        prior = consumers.setdefault(ref, tx_id)
        if prior != tx_id:
            double_spends.append(
                {"ref": str(ref), "txs": sorted((str(prior), str(tx_id)))})

    lost_acks: list[str] = []
    fail_conflicts: list[str] = []
    unresolved: list[str] = []
    timeouts_committed = timeouts_aborted = 0
    for rid, inv in invokes.items():
        outcome = outcomes.get(rid)
        if outcome is None:
            # The harness records a timeout for every op it abandons;
            # a hole here means the history itself is broken — fail
            # loudly rather than under-checking.
            unresolved.append(rid)
        elif outcome == "ok" and inv.tx_id not in committed:
            lost_acks.append(rid)
        elif outcome == "fail" and inv.tx_id in committed:
            fail_conflicts.append(rid)
        elif outcome == "timeout":
            if inv.tx_id in committed:
                timeouts_committed += 1
            else:
                timeouts_aborted += 1

    ok = not (lost_acks or double_spends or fail_conflicts or unresolved
              or duplicate_outcomes) and minority_commits == 0
    return {
        "history_linearizable": ok,
        "events": len(events),
        "invoked": len(invokes),
        "acked_ok": sum(1 for k in outcomes.values() if k == "ok"),
        "acked_fail": sum(1 for k in outcomes.values() if k == "fail"),
        "timeouts": sum(1 for k in outcomes.values() if k == "timeout"),
        "timeouts_resolved_committed": timeouts_committed,
        "timeouts_resolved_aborted": timeouts_aborted,
        "lost_acks": lost_acks,
        "double_spends": double_spends,
        "fail_conflicts": fail_conflicts,
        "unresolved": unresolved,
        "duplicate_outcomes": duplicate_outcomes,
        "minority_commits": int(minority_commits),
    }
