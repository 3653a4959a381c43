"""Milliseconds a window call of `verify_batch` spent on the host copying
the packed words to the card: its `provider_copy_in` span, on the host's
clock (the device trace's own copy time is `provider.h2d_ms_per_batch`)."""

from benchmark.provider_spans import ms_per_batch


def read(layer: dict):
    return ms_per_batch(layer, "provider_copy_in")
