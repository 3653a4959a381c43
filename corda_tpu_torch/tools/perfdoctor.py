"""perfdoctor — the performance doctor's CLI.

Three modes, all stdlib-only (obs/doctor.py does the work):

  diagnose (default)::

      python -m corda_tpu_torch.tools.perfdoctor artifacts/BENCH_r05_local_e.json

  One ``PerfVerdict`` JSON per artifact on stdout: the roofline
  (measured ceiling vs committed/e2e rates, gap factored per layer) and
  the evidence-ranked ``bottlenecks`` list with a suggested next
  experiment per entry.

  backfill::

      python -m corda_tpu_torch.tools.perfdoctor --backfill artifacts/

  Ingest every checked-in bench artifact (``*.json``, minus flight
  recordings and the trajectory itself) into
  ``artifacts/TRAJECTORY.jsonl`` in deterministic chronological order —
  (round, filename) — rewriting the store so re-runs are idempotent.

  gate::

      python -m corda_tpu_torch.tools.perfdoctor --gate \\
          [--trajectory artifacts/TRAJECTORY.jsonl] [--policy policy.json]

  Compare each kind's newest trajectory record against its predecessor
  under the tolerance policy (per-metric direction + percent band;
  ``doctor.DEFAULT_POLICY`` unless ``--policy`` overrides specific
  metrics). Exit 1 on any regression — the CI hook perf PRs are judged
  with.

The port's own copy of ``corda_tpu/tools/perfdoctor.py``. The default
trajectory is the reference's (``artifacts/TRAJECTORY.jsonl``); pass
``--trajectory`` to write anywhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..obs import doctor

DEFAULT_TRAJECTORY = os.path.join("artifacts", "TRAJECTORY.jsonl")

# Never ingested by --backfill: the store itself, and flight recordings
# (breach captures are diagnostics, not bench runs).
_SKIP_PREFIXES = ("flight-",)
_SKIP_NAMES = ("TRAJECTORY.jsonl",)


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        loaded = json.load(f)
    if not isinstance(loaded, dict):
        raise ValueError(f"{path}: expected a JSON object at top level")
    return loaded


def _backfill_paths(directory: str) -> list[str]:
    names = [n for n in os.listdir(directory)
             if n.endswith(".json")
             and n not in _SKIP_NAMES
             and not n.startswith(_SKIP_PREFIXES)]

    def order(name: str):
        artifact_round = doctor._round_of({}, name)
        return (artifact_round if artifact_round is not None else 1 << 30,
                name)

    return [os.path.join(directory, n) for n in sorted(names, key=order)]


def cmd_diagnose(paths: list[str]) -> int:
    if not paths:
        print("perfdoctor: no artifacts given (pass paths, or --backfill/"
              "--gate)", file=sys.stderr)
        return 2
    exit_code = 0
    for path in paths:
        try:
            artifact = _load_json(path)
        except (OSError, ValueError) as exc:
            print(f"perfdoctor: {path}: {exc}", file=sys.stderr)
            exit_code = 2
            continue
        verdict = doctor.diagnose(doctor.extract_signals(artifact))
        verdict["source"] = os.path.basename(path)
        print(json.dumps(verdict, sort_keys=True))
    return exit_code


def cmd_backfill(directory: str, trajectory: str | None) -> int:
    if not os.path.isdir(directory):
        print(f"perfdoctor: --backfill: not a directory: {directory}",
              file=sys.stderr)
        return 2
    store = trajectory or os.path.join(directory, "TRAJECTORY.jsonl")
    records = []
    skipped = []
    for path in _backfill_paths(directory):
        try:
            artifact = _load_json(path)
        except (OSError, ValueError) as exc:
            skipped.append({"source": os.path.basename(path),
                            "error": str(exc)})
            continue
        record = doctor.normalize_record(artifact, source=path)
        if record["kind"] == "unknown":
            skipped.append({"source": os.path.basename(path),
                            "error": "unrecognized artifact shape"})
            continue
        records.append(record)
    # Rewrite, don't append: backfill is a full rebuild of history and
    # must be idempotent across re-runs.
    parent = os.path.dirname(os.path.abspath(store))
    os.makedirs(parent, exist_ok=True)
    tmp = store + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record, sort_keys=True) + "\n")
    os.replace(tmp, store)
    print(json.dumps({
        "trajectory": store,
        "records": len(records),
        "kinds": sorted({r["kind"] for r in records}),
        "verdicts": [{"source": r["source"],
                      "first_bottleneck": r["verdict"]["first_bottleneck"]}
                     for r in records],
        "skipped": skipped,
    }, sort_keys=True))
    return 0


def cmd_gate(trajectory: str, policy_path: str | None) -> int:
    policy = dict(doctor.DEFAULT_POLICY)
    if policy_path:
        try:
            override = _load_json(policy_path)
        except (OSError, ValueError) as exc:
            print(f"perfdoctor: --policy: {exc}", file=sys.stderr)
            return 2
        policy.update(override)
    try:
        records = doctor.load_trajectory(trajectory)
    except ValueError as exc:
        print(f"perfdoctor: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"perfdoctor: --gate: no trajectory at {trajectory} "
              "(run --backfill first, or point --trajectory at the store)",
              file=sys.stderr)
        return 2
    verdict = doctor.gate(records, policy)
    verdict["trajectory"] = trajectory
    print(json.dumps(verdict, sort_keys=True))
    return 0 if verdict["ok"] else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m corda_tpu_torch.tools.perfdoctor",
        description="Bottleneck attribution, bench trajectory store, and "
                    "regression gating over corda_tpu perf artifacts.")
    parser.add_argument("artifacts", nargs="*",
                        help="artifact JSON files to diagnose")
    parser.add_argument("--backfill", metavar="DIR",
                        help="rebuild the trajectory store from every "
                             "bench artifact in DIR")
    parser.add_argument("--gate", action="store_true",
                        help="compare newest trajectory records against "
                             "their predecessors; exit 1 on regression")
    parser.add_argument("--trajectory", metavar="PATH",
                        help=f"trajectory store (default: "
                             f"{DEFAULT_TRAJECTORY}, or DIR/TRAJECTORY."
                             f"jsonl under --backfill)")
    parser.add_argument("--policy", metavar="JSON",
                        help="JSON file of per-metric overrides merged "
                             "over the default gate policy")
    args = parser.parse_args(argv)

    if args.backfill and args.gate:
        # Backfill-then-gate in one invocation is a supported CI shape.
        code = cmd_backfill(args.backfill, args.trajectory)
        if code:
            return code
        store = args.trajectory or os.path.join(
            args.backfill, "TRAJECTORY.jsonl")
        return cmd_gate(store, args.policy)
    if args.backfill:
        return cmd_backfill(args.backfill, args.trajectory)
    if args.gate:
        return cmd_gate(args.trajectory or DEFAULT_TRAJECTORY, args.policy)
    return cmd_diagnose(args.artifacts)


if __name__ == "__main__":
    sys.exit(main())
