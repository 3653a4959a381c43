"""Share of the traced window in which the card ran nothing, read as
``device.idle_share.bulk`` reads it, from the trace taken in the sidecar's
process (the one that holds the card)."""

from benchmark.harness import core

read = core.load_reader("device.idle_share.bulk").read
