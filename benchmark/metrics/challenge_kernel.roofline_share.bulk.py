"""Share of its roofline the SHA-512 challenge kernel reaches: the least
time of the window's lanes (roofline/kernels.py) over the kernel's time in
the device trace."""

from benchmark.harness.devtrace import seconds_of
from benchmark.roofline import kernels


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or "lanes" not in layer:
        return None
    sec, launches = seconds_of(trace, kernels.CHALLENGE_KERNEL)
    if sec <= 0 or launches != layer["calls"]:
        return None
    least, _ = kernels.challenge_least_seconds(layer["lanes"])
    return 100.0 * least / sec
