"""Commit commands a sealed raft log entry carried on the leader over the
window (group commit's amortisation), from the raft stamp's group entries,
their commands and the single-command entries (``solo_commits``); None on a
program whose stamp lacks the last."""

KEYS = ("group_commits", "group_commands", "solo_commits")


def read(layer: dict):
    leader = layer.get("leader")
    if leader is None or leader not in layer.get("members", {}):
        return None
    before, after = (v["raft"] for v in layer["members"][leader])
    if any(after.get(k) is None or before.get(k) is None for k in KEYS):
        return None
    groups, commands, solo = (after[k] - before[k] for k in KEYS)
    if groups + solo <= 0:
        return None
    return (commands + solo) / (groups + solo)
