"""A tiny run of ``raft.fh32`` on the CPU, in a process of its own with a
time limit: 3 members, 2 clients and the sidecar (on the host tier), 200
moves a client in blocks of 20, unpinned, a 2 s window."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

from benchmark.harness import core

TINY = dict(moves_per_client=200, inflight=8, warm=8, block=20, cores=None)
SECONDS = 2.0
SEED = 2**31 + 177
LIMIT_S = 600

_CODE = """
import json, sys
sys.path[0] = %(root)r
from benchmark.controls_raft import prepare_for
from benchmark.drivers import raft_cluster
from benchmark.harness import core

box = {}
run = raft_cluster.run

def keep(ctx):
    out = run(ctx)
    box["layer"] = out["layer"]
    return out

raft_cluster.run = keep

def prepare(ctx):
    ctx.traffic = dict(ctx.traffic, **%(tiny)r)
    if %(fault)r:
        prepare_for(%(fault)r)(ctx)

if __name__ == "__main__":
    r = core.run_cell("raft.fh32", %(seed)d, %(seconds)r, %(trace)r,
                      device="cpu", prepare=prepare)
    r.pop("setup_marks", None)
    print("RESULT " + json.dumps({"result": r, "layer": box["layer"]}))
"""


def run_tiny(trace: bool = False, fault: str | None = None,
             seed: int = SEED) -> dict:
    """{"result": the run's result, "layer": what its driver returned for
    the readers}; the run's whole process group is killed at the limit."""
    code = _CODE % {"root": str(core.ROOT), "tiny": TINY, "fault": fault,
                    "seed": seed, "seconds": SECONDS, "trace": trace}
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"the tiny run passed {LIMIT_S} s: {err[-2000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, err[-3000:]
    return json.loads(lines[-1][len("RESULT "):])
