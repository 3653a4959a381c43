"""Milliseconds of the raft leader's run loop spent in its pump's work (the
message handlers, outside the blocking wait) per move whose outcome reached
its client in the window: the delta of ``round_stage_s`` ``pump`` less
``pump_wait``. A program whose run loop books no ``pump_wait`` reads
nothing."""


def read(layer: dict):
    leader = layer.get("leader")
    moves = layer.get("moves_in_window")
    if leader is None or not moves or leader not in layer.get("members", {}):
        return None
    before, after = (m["round_stage_s"] for m in layer["members"][leader])
    if "pump_wait" not in after or "pump_wait" not in before:
        return None
    work = ((after["pump"] - after["pump_wait"])
            - (before["pump"] - before["pump_wait"]))
    return 1e3 * work / moves
