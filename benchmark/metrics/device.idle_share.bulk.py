"""Share of the traced window in which the card ran nothing: one minus the
union of all device activity (kernels, copies, sets) over the window."""


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
