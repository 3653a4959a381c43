"""Milliseconds a window call of `verify_batch` spent with the host blocked
on the card: its `provider_device_wait` span (both kernels' launches and
the read-back of the answers)."""

from benchmark.provider_spans import ms_per_batch


def read(layer: dict):
    return ms_per_batch(layer, "provider_device_wait")
