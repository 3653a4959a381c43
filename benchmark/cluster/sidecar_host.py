"""The verification sidecar started through the benchmark: the program's own
``corda_tpu_torch.crypto.sidecar.main`` in this process, with the device
trace of the window taken from inside it, or a fault planted in it.

    python -m benchmark.cluster.sidecar_host --control DIR [--trace]
        [--fault flip|half|stale] -- <the sidecar's own arguments>

``--trace``: once ``DIR/trace_start`` appears, the torch profiler runs in
this process (the one that holds the card) until ``DIR/trace_stop``
appears; it writes ``DIR/trace_started`` when it is collecting and the
window's summary (``harness/devtrace.py``) to ``DIR/trace.json``.

``--fault``: the server's verifier answers wrongly, as ``controls_raft.py``
describes; the benchmark's own runs never plant one.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

POLL_S = 0.005
FAULTS = ("flip", "half", "stale")


def _wait_for(path: str) -> None:
    while not os.path.exists(path):
        time.sleep(POLL_S)


def _write(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def trace_window(control: str) -> None:
    """Profiles this process from ``trace_start`` to ``trace_stop``."""
    from benchmark.harness import devtrace

    _wait_for(os.path.join(control, "trace_start"))
    with devtrace.profiled(True) as holder:
        _write(os.path.join(control, "trace_started"), str(time.time()))
        _wait_for(os.path.join(control, "trace_stop"))
    _write(os.path.join(control, "trace.json"), json.dumps(holder["summary"]))


def broken(out: np.ndarray, kind: str) -> np.ndarray:
    """A batch's verdicts with ``kind`` planted: ``flip`` refuses one
    accepted lane, ``half`` accepts the second half unchecked, ``stale``
    accepts every lane."""
    out = np.array(out, bool)
    if kind == "flip":
        accepted = np.flatnonzero(out)
        if len(accepted):
            out[accepted[0]] = False
    elif kind == "half":
        out[len(out) // 2:] = True
    else:
        out[:] = True
    return out


class Broken:
    """The server's verifier with ``kind`` planted in its answers; every
    other attribute is the verifier's own."""

    def __init__(self, inner, kind: str):
        self._inner = inner
        self._kind = kind

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_packed(self, packed):
        return broken(self._inner.verify_packed(packed), self._kind)

    def verify_batch(self, jobs):
        return broken(self._inner.verify_batch(jobs), self._kind)


def plant(kind: str) -> None:
    """Every SidecarServer of this process serves through Broken."""
    from corda_tpu_torch.crypto import sidecar

    start = sidecar.SidecarServer.start

    def start_broken(self, warm: bool = True):
        self.verifier = Broken(self.verifier, kind)
        return start(self, warm)

    sidecar.SidecarServer.start = start_broken


def main(argv: list[str]) -> int:
    split = argv.index("--")
    own, rest = argv[:split], argv[split + 1:]
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--control", required=True)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--fault", choices=FAULTS)
    args = p.parse_args(own)
    if args.fault:
        plant(args.fault)
    if args.trace:
        threading.Thread(target=trace_window, args=(args.control,),
                         daemon=True, name="bench-trace").start()
    from corda_tpu_torch.crypto import sidecar

    return sidecar.main(rest)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
