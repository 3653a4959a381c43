"""Milliseconds of host-to-device copies per verify_batch call, from the
device trace (the packed words the provider sends to the card)."""

from benchmark.harness.devtrace import seconds_of


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or not layer.get("calls"):
        return None
    sec, n = seconds_of(trace, "HtoD")
    if n == 0:
        return None
    return 1e3 * sec / layer["calls"]
