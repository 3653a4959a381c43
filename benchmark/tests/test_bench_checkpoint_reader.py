"""The ``node.checkpoint_ms_per_move.fh32`` reader on synthetic layers: the
members' summed Δ``round_stage_s["checkpoint"]`` in ms a window move, and
nothing to read without a move or without the stage. That it reads a number
in a tiny whole run is held by ``test_bench_raft_cluster.py``, which hands
that run's layer to every reader the cell names."""

from __future__ import annotations

import pytest

from benchmark.harness import core

READER = core.load_reader("node.checkpoint_ms_per_move.fh32")


def _view(checkpoint=None, **stages) -> dict:
    stage = dict(stages, pump=1.0, rounds=10)
    if checkpoint is not None:
        stage["checkpoint"] = checkpoint
    return {"round_stage_s": stage, "raft": {}}


def _layer(moves, members) -> dict:
    return {"moves_in_window": moves, "leader": "Raft1",
            "members": {name: [_view(b), _view(a)]
                        for name, (b, a) in members.items()}}


@pytest.mark.parametrize("moves, members, want", [
    # Raft0 runs the flows; the others book next to nothing.
    (40, {"Raft0": (1.0, 1.6), "Raft1": (0.2, 0.2), "Raft2": (0.1, 0.12)},
     1e3 * (0.6 + 0.0 + 0.02) / 40),
    (1, {"Raft0": (0.0, 0.003)}, 3.0),
    # No move in the window, no members, a member without the stage.
    (0, {"Raft0": (1.0, 1.6)}, None),
    (None, {"Raft0": (1.0, 1.6)}, None),
    (40, {}, None),
    (40, {"Raft0": (1.0, 1.6), "Raft1": (None, None)}, None),
], ids=["three-members", "one-member", "no-moves", "moves-unknown",
        "no-members", "stage-missing"])
def test_checkpoint_reader(moves, members, want):
    got = READER.read(_layer(moves, members))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_checkpoint_reader_is_named_for_the_fh32_cell():
    names = [m["name"] for m in core.cell_metrics(core.load_spec(),
                                                  "raft.fh32", "per_layer")]
    assert "node.checkpoint_ms_per_move.fh32" in names
