"""Tiny sizes of each cell for the CPU rehearsals."""

from __future__ import annotations

TINY = {
    "firehose.bulk": dict(batch=48, pool=2, keys=8, flipped=3, malleated=2,
                          sample_plain=4),
}
SECONDS = {"firehose.bulk": 5}
SEED = 2**31 + 77


def tiny(workload: str, then=None):
    """A prepare hook shrinking the cell's traffic, then running ``then``."""
    def prepare(ctx):
        ctx.traffic = dict(ctx.traffic, **TINY[workload])
        if then is not None:
            then(ctx)
    return prepare


def run_tiny(workload: str, then=None, trace: bool = False,
             seed: int = SEED) -> dict:
    from benchmark.harness import core

    return core.run_cell(workload, seed, SECONDS[workload], trace,
                         device="cpu", prepare=tiny(workload, then))
