"""Milliseconds a verify request waited in the card sidecar before its batch
ran, over the window: the delta of ``stats()``'s ``wait_s_total`` (each
request's time from arrival to its batch's start) over that of
``requests``."""


def read(layer: dict):
    side = layer.get("sidecar")
    if not side:
        return None
    before, after = side
    requests = after["requests"] - before["requests"]
    if requests <= 0:
        return None
    return 1e3 * (after["wait_s_total"] - before["wait_s_total"]) / requests
