"""autotune — the closed-loop tuner's CLI.

Consume a perf-doctor verdict, sweep the knobs it implicates, gate every
candidate against the hand-tuned incumbent, commit the winner::

    python -m corda_tpu_torch.tools.autotune artifacts/INGEST_r15_local.json \\
        --budget 4 --seed 7 --out artifacts/AUTOTUNE_r21_local.json

The positional argument is any artifact ``perfdoctor`` can diagnose (a
bench report, ingest sweep, flagship capture) OR an already-rendered
verdict (a JSON object carrying ``bottlenecks``). The controller maps
the top bottleneck's structured experiment spec (obs/doctor.RULE_SPECS)
to a sweep, runs each candidate through the real multiprocess ingest
harness (or a deterministic mock surface with ``--mock``), and prints
the full provenance record as one JSON line. Unless ``--no-append``,
the run's ``autotune`` record is appended to the trajectory store, so
``perfdoctor --gate`` bands the loop's own output from then on.

Replay: the search is deterministic — same seed, same runner responses,
identical ``decision_sequence``. ``--mock monotone|noisy|regressing|
cliff`` swaps in the pure response surfaces (no cluster) for demos and
replay checks.

``--validate`` runs the knob-registry drift check (every registry entry
must resolve to a live config key / harness kwarg / env read) and exits
non-zero on any violation — the analyzer-style CI hook.

The port's own copy of ``corda_tpu/tools/autotune.py``; the candidates run
the port's harnesses. The default trajectory is the reference's; pass
``--trajectory`` to write anywhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..autotune import controller, space
from ..obs import doctor

DEFAULT_TRAJECTORY = os.path.join("artifacts", "TRAJECTORY.jsonl")


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        loaded = json.load(f)
    if not isinstance(loaded, dict):
        raise ValueError(f"{path}: expected a JSON object at top level")
    return loaded


def _verdict_of(artifact: dict) -> dict:
    """The artifact as a verdict: pass through an already-rendered one
    (it carries ``bottlenecks``), diagnose anything else."""
    if "bottlenecks" in artifact:
        return artifact
    return doctor.diagnose(doctor.extract_signals(artifact))


def cmd_validate() -> int:
    errors = space.validate_registry()
    print(json.dumps({"ok": not errors, "knobs": len(space.KNOBS),
                      "errors": errors}, sort_keys=True))
    return 0 if not errors else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m corda_tpu_torch.tools.autotune",
        description="Closed-loop autotuner: doctor verdict -> gated "
                    "parameter sweep -> committed config overlay.")
    parser.add_argument("verdict", nargs="?",
                        help="artifact or verdict JSON to consume")
    parser.add_argument("--validate", action="store_true",
                        help="check the knob registry against the live "
                             "config/harness/env surface and exit")
    parser.add_argument("--mock", metavar="CURVE",
                        choices=("monotone", "noisy", "regressing",
                                 "cliff"),
                        help="deterministic mock response surface "
                             "instead of the real harness")
    parser.add_argument("--budget", type=int, default=4,
                        help="candidates to evaluate beyond the "
                             "incumbent (default 4)")
    parser.add_argument("--seed", type=int, default=0,
                        help="search seed: same seed replays the same "
                             "decision sequence (default 0)")
    parser.add_argument("--metric", help="swept metric override")
    parser.add_argument("--explore", action="store_true",
                        help="fall back to the default exploratory sweep "
                             "when the verdict abstains or implicates "
                             "no sweepable knob")
    parser.add_argument("--rate", type=float, default=2400.0,
                        help="offered tx/s for real candidates")
    parser.add_argument("--n-tx", type=int, default=400,
                        help="corpus size per real candidate")
    parser.add_argument("--workers", type=int, default=2,
                        help="replay workers per real candidate")
    parser.add_argument("--out", metavar="PATH",
                        help="also write the provenance record to PATH")
    parser.add_argument("--overlay-out", metavar="PATH",
                        help="write the committed TOML overlay to PATH "
                             "(only when the loop improved)")
    parser.add_argument("--trajectory", metavar="PATH",
                        help=f"trajectory store to append the autotune "
                             f"record to (default {DEFAULT_TRAJECTORY})")
    parser.add_argument("--no-append", action="store_true",
                        help="do not append to the trajectory store")
    args = parser.parse_args(argv)

    if args.validate:
        return cmd_validate()
    if not args.verdict:
        print("autotune: no verdict artifact given (or use --validate)",
              file=sys.stderr)
        return 2
    try:
        artifact = _load_json(args.verdict)
    except (OSError, ValueError) as exc:
        print(f"autotune: {args.verdict}: {exc}", file=sys.stderr)
        return 2
    verdict = _verdict_of(artifact)
    try:
        spec = controller.spec_from_verdict(verdict, metric=args.metric)
    except ValueError as exc:
        if not args.explore:
            print(f"autotune: {exc} (pass --explore to sweep the "
                  f"default knobs anyway)", file=sys.stderr)
            return 2
        spec = controller.exploratory_spec(metric=args.metric)

    if args.mock:
        runner = controller.make_mock_runner(spec, args.mock)
    else:
        runner = controller.make_ingest_runner(
            rates=(args.rate,), n_tx=args.n_tx, workers=args.workers)

    result = controller.run_autotune(
        spec, runner, budget=args.budget, seed=args.seed,
        verdict_consumed={
            "source": os.path.basename(args.verdict),
            "first_bottleneck": verdict.get("first_bottleneck"),
            "experiment_id": spec.experiment_id,
        })
    if args.mock:
        result["runner"] = {"mock": args.mock}
    else:
        result["runner"] = {"harness": "run_ingest_sweep",
                            "rates": [args.rate], "n_tx": args.n_tx,
                            "workers": args.workers}

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.overlay_out and result["overlay"]:
        with open(args.overlay_out, "w", encoding="utf-8") as f:
            f.write(result["overlay"]["toml"])
    if not args.no_append:
        store = args.trajectory or os.environ.get(
            "CORDA_TPU_TRAJECTORY", DEFAULT_TRAJECTORY)
        source = args.out or "autotune-run.json"
        doctor.append_trajectory(
            store, doctor.normalize_record(result, source=source))
        result["trajectory"] = store
    print(json.dumps(result, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
