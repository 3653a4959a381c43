"""Reading a torch.profiler trace: device busy time, kernel and copy time
by name, the top device operations, and the idle gaps named by what the
host was doing.

The union of the device activities over the traced window is the method
the chip phases of the program's own smoke run use for the idle share.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def profiled(on: bool):
    """torch.profiler (host and device activity) over the block when
    ``on``; yields a holder whose ``summary`` is filled on exit."""
    holder = {"summary": None}
    if not on:
        yield holder
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield holder
        window = time.perf_counter() - t0
    holder["summary"] = summarize(prof, window)


def _merge(spans):
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def _annotation(e) -> bool:
    """A ``record_function`` range the profiler mirrors onto the device's
    timeline: it spans a host call's device work and the gaps inside it,
    and is no operation that ran on the device."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def summarize(prof, window_s: float) -> dict:
    """Plain numbers from a finished profiler: busy seconds (the union of
    device operations: kernels, copies, sets), per-name device seconds and counts, the ten longest
    device operations by total and the ten longest idle gaps between
    device activities, each named by the innermost host event over it."""
    import torch

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(span)
        elif not _annotation(e):
            dev.append(span)
    by_name: dict[str, list] = {}
    for s, t, name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (t - s) / 1e9
        rec[1] += 1
    merged = _merge([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged) / 1e9
    gaps = []
    for (s0, t0), (s1, _t1) in zip(merged, merged[1:]):
        if s1 > t0:
            gaps.append((t0, s1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [(t - s, name) for s, t, name in host if s <= mid <= t]
        label = min(over)[1] if over else "host: no traced operation"
        named.append([label, (b - a) / 1e9])
    top = sorted(([k, v[0]] for k, v in by_name.items()),
                 key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy, "window_s": window_s,
            "by_name": {k: {"seconds": v[0], "count": v[1]}
                        for k, v in by_name.items()},
            "device_ops": top, "idle_gaps": named}


def seconds_of(summary: dict, needle: str) -> tuple[float, int]:
    """Total device seconds and count of the activities whose name holds
    ``needle``."""
    sec, n = 0.0, 0
    for name, rec in summary["by_name"].items():
        if needle in name:
            sec += rec["seconds"]
            n += rec["count"]
    return sec, n
