"""The controls and planted faults that `correct` must catch.

Each runs a whole cell with one thing changed underneath and must come out
``correct: false``:

  control  the configuration's guarantee broken on purpose, at the cell's
           own size: a strict verifier (OpenSSL through `cryptography`,
           which checks S < L) in the program's place: the lanes carrying
           S + L, which the oracle's semantics accept, come out rejected.
  flip     an answer altered where it is produced: one verdict of every
           verify batch inverted.
  half     half of each batch left out: the verifier checks the first half
           and accepts the rest unchecked.
  stale    a step that returns its state unchanged: the verifier answers
           every batch with its initial state, every lane accepted, and
           checks nothing.

    python -m benchmark.controls --workload <cell> --kind <kind> \
        --seeds 1,2,3 --seconds 30

runs the cell once a seed on the card and prints each run's result line.
The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

KINDS = ("control", "flip", "half", "stale")


class StrictVerifier:
    """Ed25519 through OpenSSL (`cryptography`): RFC 8032's strict checks,
    S < L among them."""

    def verify_batch(self, jobs) -> np.ndarray:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PublicKey)

        out = np.zeros(len(jobs), bool)
        for i, j in enumerate(jobs):
            try:
                Ed25519PublicKey.from_public_bytes(j.pubkey).verify(
                    j.sig, j.message)
                out[i] = True
            except (InvalidSignature, ValueError):
                pass
        return out


class Broken:
    """The program's verifier with one fault planted in what it returns."""

    def __init__(self, inner, kind: str):
        self.inner = inner
        self.kind = kind

    def verify_batch(self, jobs) -> np.ndarray:
        if self.kind == "stale":
            return np.ones(len(jobs), bool)
        if self.kind == "half":
            keep = len(jobs) // 2
            out = np.ones(len(jobs), bool)
            out[:keep] = self.inner.verify_batch(list(jobs[:keep]))
            return out
        out = self.inner.verify_batch(jobs)
        if self.kind == "flip":
            out = out.copy()
            out[0] = not out[0]
        return out


def prepare_for(kind: str, device: str):
    """The ``prepare(ctx)`` hook that plants ``kind`` in a run."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: expected one of {KINDS}")

    def prepare(ctx) -> None:
        if kind == "control":
            ctx.overrides["verifier"] = StrictVerifier()
        else:
            from corda_tpu_torch.crypto.provider import TorchVerifier

            ctx.overrides["verifier"] = Broken(TorchVerifier(device), kind)

    return prepare


def main(argv=None) -> int:
    from .harness import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", choices=KINDS, default="control")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    core.cache_env()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = core.run_cell(args.workload, seed, args.seconds, False,
                          prepare=prepare_for(args.kind, "cuda"))
        print(json.dumps({"seed": seed, "kind": args.kind, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
