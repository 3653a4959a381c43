"""The planted faults that `correct` must catch in the cluster cells, each
planted in the card sidecar (``cluster/sidecar_host.py``), where every
member's signature checks are answered:

  flip   one accepted lane of every sidecar batch refused: an honest move
         refused
  half   the second half of every sidecar batch accepted unchecked: about
         half of the tampered moves acknowledged
  stale  every lane of every batch accepted, nothing checked: every
         tampered move acknowledged

    python -m benchmark.controls_raft --workload raft.fh32 --kind <kind> \\
        --seeds 1,2,3 --seconds 30

runs the cell once a seed on the card and prints each run's result line.
The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys

from .cluster.sidecar_host import FAULTS as KINDS


def prepare_for(kind: str):
    """The ``prepare(ctx)`` hook that plants ``kind`` in a run's sidecar."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: expected one of {KINDS}")

    def prepare(ctx) -> None:
        ctx.overrides["sidecar_fault"] = kind

    return prepare


def main(argv=None) -> int:
    from .harness import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="raft.fh32")
    p.add_argument("--kind", choices=KINDS, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    core.cache_env()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = core.run_cell(args.workload, seed, args.seconds, False,
                          prepare=prepare_for(args.kind))
        print(json.dumps({"seed": seed, "kind": args.kind, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
