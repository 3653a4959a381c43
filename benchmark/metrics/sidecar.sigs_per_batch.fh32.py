"""Signatures a batch the card sidecar verified over the window: its
``stats()`` counters' deltas, sigs over batches (how far the three members'
micro-batches coalesce in it)."""


def read(layer: dict):
    side = layer.get("sidecar")
    if not side:
        return None
    before, after = side
    batches = after["batches"] - before["batches"]
    if batches <= 0:
        return None
    return (after["sigs"] - before["sigs"]) / batches
