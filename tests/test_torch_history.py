"""The port's history auditor (corda_tpu_torch/testing/history.py, which
run_partition_loadtest audits with): the cases of tests/test_history.py on
the port, then one seeded history through both packages' check_history
with equal verdicts. Tolerance: exact equality.
"""

from corda_tpu_torch.testing.history import History, HistoryEvent, check_history

import pytest


def _history(*ops):
    """ops: (request_id, tx_id, refs, outcome) tuples."""
    h = History()
    for rid, tx, refs, outcome in ops:
        h.record_invoke("c1", rid, tx, refs=refs)
        if outcome is not None:
            h.record_outcome("c1", rid, outcome)
    return h


def test_clean_run_is_linearizable():
    h = _history(("r1", "tx1", ("ref1",), "ok"),
                 ("r2", "tx2", ("ref2",), "fail"),
                 ("r3", "tx3", ("ref3",), "timeout"))
    # tx2 rejected (absent), tx3 timed out and resolved committed.
    v = check_history(h, {"tx1", "tx3"},
                      consumed=[("ref1", "tx1"), ("ref3", "tx3"),
                                # replication duplicates are expected
                                ("ref1", "tx1")])
    assert v["history_linearizable"] is True
    assert v["invoked"] == 3
    assert v["acked_ok"] == 1
    assert v["acked_fail"] == 1
    assert v["timeouts"] == 1
    assert v["timeouts_resolved_committed"] == 1
    assert v["timeouts_resolved_aborted"] == 0
    assert not v["lost_acks"] and not v["double_spends"]


def test_lost_ack_caught():
    # Client was told tx1 committed; the ledger never heard of it — a
    # leader acked before quorum and the cut ate the commit.
    h = _history(("r1", "tx1", ("ref1",), "ok"))
    v = check_history(h, set())
    assert v["history_linearizable"] is False
    assert v["lost_acks"] == ["r1"]


def test_double_spend_caught():
    # Two members on opposite sides of a split each committed a
    # different spender of ref1 — the smoking gun lives in the union.
    h = _history(("r1", "tx1", ("ref1",), "ok"),
                 ("r2", "tx2", ("ref1",), "ok"))
    v = check_history(h, {"tx1", "tx2"},
                      consumed=[("ref1", "tx1"), ("ref1", "tx2")])
    assert v["history_linearizable"] is False
    assert v["double_spends"] == [{"ref": "ref1",
                                   "txs": ["tx1", "tx2"]}]


def test_fail_conflict_caught():
    # Client got a FINAL rejection yet the tx sits committed — the
    # reject and the commit cannot both be true.
    h = _history(("r1", "tx1", ("ref1",), "fail"))
    v = check_history(h, {"tx1"}, consumed=[("ref1", "tx1")])
    assert v["history_linearizable"] is False
    assert v["fail_conflicts"] == ["r1"]


def test_minority_commit_fails_the_gate():
    # A perfectly clean history still fails if the minority side's
    # committed rows advanced while the cut held.
    h = _history(("r1", "tx1", ("ref1",), "ok"))
    v = check_history(h, {"tx1"}, consumed=[("ref1", "tx1")],
                      minority_commits=2)
    assert v["history_linearizable"] is False
    assert v["minority_commits"] == 2


def test_unresolved_invoke_fails_loudly():
    # The harness records a timeout for every op it abandons; a hole
    # means the history itself is broken — under-checking is failure.
    h = _history(("r1", "tx1", ("ref1",), None))
    v = check_history(h, {"tx1"})
    assert v["history_linearizable"] is False
    assert v["unresolved"] == ["r1"]


def test_duplicate_outcomes_flagged():
    h = History()
    h.record_invoke("c1", "r1", "tx1", refs=("ref1",))
    h.record_outcome("c1", "r1", "ok")
    h.record_outcome("c1", "r1", "fail")
    v = check_history(h, {"tx1"}, consumed=[("ref1", "tx1")])
    assert v["history_linearizable"] is False
    assert v["duplicate_outcomes"] == ["r1"]


def test_timeout_may_resolve_either_way():
    h = _history(("r1", "tx1", ("ref1",), "timeout"),
                 ("r2", "tx2", ("ref2",), "timeout"))
    v = check_history(h, {"tx1"}, consumed=[("ref1", "tx1")])
    assert v["history_linearizable"] is True
    assert v["timeouts_resolved_committed"] == 1
    assert v["timeouts_resolved_aborted"] == 1


def test_unknown_outcome_kind_rejected():
    h = History()
    with pytest.raises(ValueError):
        h.record_outcome("c1", "r1", "maybe")


def test_plain_event_iterable_accepted():
    events = [HistoryEvent("invoke", "c1", "r1", "tx1", ("ref1",)),
              HistoryEvent("ok", "c1", "r1")]
    v = check_history(events, {"tx1"})
    assert v["history_linearizable"] is True
    assert v["events"] == 2


def test_history_cap_bounds_memory():
    h = History(cap=10)
    for i in range(25):
        h.record_invoke("c1", f"r{i}", f"tx{i}")
    assert len(h) == 10


def _seeded_history(mod, seed: int):
    """A seeded client history over a few refs: acks, rejections and
    timeouts, some acked transactions missing from the ledger."""
    import random

    rng = random.Random(seed)
    h = mod.History()
    committed, consumed = [], []
    for rid in range(60):
        tx, ref = f"tx{rid}", f"ref{rid % 25}"
        h.record_invoke(f"c{rid % 3}", rid, tx, refs=(ref,))
        kind = rng.choice(("ok", "ok", "ok", "fail", "timeout"))
        h.record_outcome(f"c{rid % 3}", rid, kind)
        if (kind == "ok" and rng.random() < 0.95) or (
                kind == "timeout" and rng.random() < 0.5):
            committed.append(tx)
            consumed.append((ref, tx))
    return h, committed, consumed


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_verdicts_equal_jax(seed):
    import json

    from corda_tpu.testing import history as jhistory
    from corda_tpu_torch.testing import history

    h, committed, consumed = _seeded_history(history, seed)
    jh, jcommitted, jconsumed = _seeded_history(jhistory, seed)
    mine = history.check_history(h, committed, consumed=consumed)
    theirs = jhistory.check_history(jh, jcommitted, consumed=jconsumed)
    assert json.dumps(mine, sort_keys=True, default=str) == \
        json.dumps(theirs, sort_keys=True, default=str)
