"""Milliseconds a window call of `verify_batch` spent packing on the host:
its `provider_pack` span (the `good` filter, the key, message and
signature lists, the native pack)."""

from benchmark.provider_spans import ms_per_batch


def read(layer: dict):
    return ms_per_batch(layer, "provider_pack")
