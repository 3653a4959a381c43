"""Share of its roofline the verify kernel reaches: the least time the
window's inputs need (roofline/kernels.py, counted from each lane's own S
and h) over the verify kernel's time in the device trace."""

from benchmark.harness.devtrace import seconds_of
from benchmark.roofline import kernels


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or "verify_least_ops" not in layer:
        return None
    sec, launches = seconds_of(trace, kernels.VERIFY_KERNEL)
    if sec <= 0 or launches != layer["calls"]:
        return None
    least, _ = kernels.verify_least_seconds(layer["verify_least_ops"],
                                            layer["lanes"])
    return 100.0 * least / sec
