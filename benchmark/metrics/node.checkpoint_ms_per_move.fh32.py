"""Milliseconds the three members' run loops spent in their ``checkpoint``
stage (serialising each round's dirty flows and writing their checksummed
rows) per move whose outcome reached its client in the window: the summed
delta of ``round_stage_s`` ``checkpoint`` over the members. Only the member
the clients send to runs flows, so the sum names no member. A run with no
move in the window, or a member that books no ``checkpoint``, reads
nothing."""


def read(layer: dict):
    moves = layer.get("moves_in_window")
    members = layer.get("members")
    if not moves or not members:
        return None
    total = 0.0
    for before, after in members.values():
        b, a = before["round_stage_s"], after["round_stage_s"]
        if "checkpoint" not in a or "checkpoint" not in b:
            return None
        total += a["checkpoint"] - b["checkpoint"]
    return 1e3 * total / moves
