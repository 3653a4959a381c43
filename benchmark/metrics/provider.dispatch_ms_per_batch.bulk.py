"""Milliseconds a window call of `verify_batch` spent in the provider's
dispatch: the self time of its `provider_verify` span, outside its pack,
copy-in and device-wait stages (the scheme split, the routing, the
answers put back in order)."""

from benchmark.provider_spans import ms_per_batch


def read(layer: dict):
    return ms_per_batch(layer, "dispatch")
