"""The registry and one run of one cell.

Everything is found by name: the cell in BENCHMARK.json names its
configuration (``configs[].file``) and its traffic
(``benchmark/traffic/<traffic>.json``); the traffic file names its driver
(``benchmark/drivers/<driver>.py``); each per-layer metric is read by
``benchmark/metrics/<metric name>.py``. Adding a cell, a configuration or a
metric adds files and entries, never an edit here.

A driver is a module with ``run(ctx) -> dict``. It builds its inputs from
``ctx.seed``, calls ``ctx.open_window()`` when the measured window starts,
and returns:

  e2e       {end-to-end metric name: value} (what it measured)
  attempted / failed   operations due in the window, and those that failed
  checks    {name: (number, limit)}: every number compared with the
            reference; the run is correct when each number <= its limit
  device    {"kind", "memory_peak_bytes", and with --trace 1 "busy_s",
            "window_s"}
  layer     raw readings (counters, snapshots, trace sums) that the
            per-layer readers take their metrics from
  breakdown optional, with --trace 1: {"device_ops", "idle_gaps"}
  detail    optional plain numbers printed beside the result (a latency's
            quantiles, counts), for the record
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# Top-level module names that may not be loaded in a run, compared whole:
# the port's own name starts with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "corda_tpu")


class CellError(RuntimeError):
    """A run that cannot produce a result (no card, a bad cell); the
    command exits non-zero and prints no result."""


def process_start_epoch() -> float:
    """Wall-clock time at which this process started (from /proc), so that
    set-up counts the interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf(os.sysconf_names["SC_CLK_TCK"])
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError, KeyError):
        return time.time()


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_reader(name: str):
    """The module ``benchmark/metrics/<name>.py`` (names hold dots, so it
    is loaded from its path, not imported by name)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    if spec is None:
        raise CellError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seed, the window's length, whether to trace, a private temporary
    directory, and the clock of set-up."""

    def __init__(self, spec: dict, cell: dict, seed: int, seconds: float,
                 trace: bool, device: str, t_process: float):
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.config = load_json(ROOT / find(spec["configs"], cell["config"],
                                            "configuration")["file"])
        self.traffic = load_json(traffic_path(cell["traffic"]))
        self.t_process = t_process
        self.setup_s: float | None = None
        self.tmp = Path(tempfile.mkdtemp(prefix="bench-"))
        # Test hook: a replacement verifier (fault tests run the rest of a
        # run over a broken timed path).
        self.overrides: dict = {}
        self.marks: list = []

    def mark(self, what: str) -> None:
        """Notes how far into set-up a step ended (seconds since process
        start), printed beside the result."""
        self.marks.append((what, round(time.time() - self.t_process, 3)))

    def open_window(self) -> None:
        """Marks the end of set-up (process start to here)."""
        self.setup_s = time.time() - self.t_process

    def cleanup(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only the first run of a cell there builds. The port's kernels and
    native cores build under build/corda_tpu_torch/ (fixed in the program);
    the toolchain's own caches go beside them."""
    base = ROOT / "build" / "benchmark"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[key] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded() -> list[str]:
    """Modules whose top-level name is forbidden, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is False: this benchmark "
                        "measures the card and has no CPU result")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell needs {chips} card(s); "
                        f"torch.cuda.device_count() is "
                        f"{torch.cuda.device_count()}")


def _number(x: float) -> float:
    if x is None or not math.isfinite(float(x)):
        raise CellError(f"metric value {x!r} is not a finite number")
    return float(x)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             prepare=None) -> dict:
    """One run of one cell -> the result object (not yet printed).
    ``device`` "cpu" runs the plain versions (tests only; the command line
    always asks for the card). ``prepare(ctx)`` lets a test plant a fault
    before the driver runs."""
    spec = load_spec()
    cell = find(spec["workloads"], workload, "workload")
    if device == "cuda":
        require_card(int(cell["chips"]))
    ctx = Context(spec, cell, seed, seconds, trace, device,
                  t_process if t_process is not None else time.time())
    try:
        if prepare is not None:
            prepare(ctx)
        out = load_driver(ctx.traffic["driver"]).run(ctx)
    finally:
        ctx.cleanup()
    if ctx.setup_s is None:
        raise CellError("the driver never opened its window")
    checks = out["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if trace:
        for m in cell_metrics(spec, workload, "per_layer"):
            value = load_reader(m["name"]).read(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": _number(value),
                                      "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell_metrics(spec, workload, "end_to_end"):
            if m["name"] not in e2e:
                raise CellError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": _number(e2e[m["name"]]),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "count": int(cell["chips"])}
    device_info.update(out["device"])
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    if out.get("detail"):
        result["detail"] = out["detail"]
    result["setup_marks"] = ctx.marks
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv: list[str] | None = None, t_process: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once "
                                "and print one JSON result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process=t_process)
    except CellError as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_loaded()
    if found:
        print("benchmark: forbidden modules loaded in the measuring "
              f"process: {found}", file=sys.stderr, flush=True)
        return 3
    print("setup: " + ", ".join(f"{w} {t} s" for w, t in
                                  result.pop("setup_marks")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
