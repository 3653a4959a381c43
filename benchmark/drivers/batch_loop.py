"""Closed loop of one caller: back-to-back ``TorchVerifier.verify_batch``
calls on batches cycled from a pool signed at set-up.

Traffic keys: ``batch`` lanes a call, ``pool`` batches, ``keys`` signers a
batch, ``flipped`` and ``malleated`` lanes a batch (signing.py),
``sample_plain`` honest lanes a batch that the oracle also judges.

The window runs from the first call until the last call that started
before ``--seconds`` had passed returns: every verdict counted reached the
caller inside it. ``verified_sigs_per_s`` = lanes of those calls / window.

Correct: every lane of every call against its label (what the oracle's
semantics say of it by construction), and every lane of a sample drawn
from the seed -- all flipped and malleated lanes and ``sample_plain``
others a batch -- against the frozen oracle's own verdict.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from ..harness import card, devtrace, signing

# Cores the caller's thread is pinned to for the window: a caller that the
# scheduler moves between all of a host's cores runs its calls at a pace
# that differs far more from run to run.
CALLER_CORES = 5


def _jobs(VerifyJob, lanes: dict) -> list:
    pk, msg, sig = (lanes[k].tobytes() for k in ("pk", "msg", "sig"))
    return [VerifyJob(pk[32 * i:32 * i + 32], msg[32 * i:32 * i + 32],
                      sig[64 * i:64 * i + 64])
            for i in range(len(lanes["pk"]))]


def sample_of(seed: int, b: int, lanes: dict, plain: int) -> np.ndarray:
    """The lanes of batch ``b`` the oracle judges: every flipped and
    malleated one and ``plain`` honest ones drawn from the seed."""
    special = np.flatnonzero(lanes["kind"] != signing.HONEST)
    honest = np.flatnonzero(lanes["kind"] == signing.HONEST)
    rng = signing.rng_for(seed, "sample", b)
    pick = rng.choice(honest, min(plain, len(honest)), replace=False)
    return np.sort(np.concatenate([special, pick]))


def pin_caller(n: int) -> list[int]:
    """Pins the calling thread (and the threads it starts later) to ``n``
    of the cores this process may use, the lowest one left out; returns
    them."""
    cores = sorted(os.sched_getaffinity(0))
    pick = cores[1:1 + n] or cores
    os.sched_setaffinity(0, pick)
    return pick


def run(ctx) -> dict:
    import torch

    from corda_tpu_torch.crypto.provider import TorchVerifier, VerifyJob

    t = ctx.traffic
    n, n_pool = int(t["batch"]), int(t["pool"])
    ctx.mark("imports")
    with signing.pool() as workers:
        pool = [signing.sign_lanes(ctx.seed, f"batch{b}", n, int(t["keys"]),
                                   int(t["flipped"]), int(t["malleated"]),
                                   pool=workers)
                for b in range(n_pool)]
        ctx.mark("signed")
        batches = [_jobs(VerifyJob, lanes) for lanes in pool]
        # The pool's 400,000 jobs live for the whole run: keep the cyclic
        # collector from rescanning them in the window (a caller streaming
        # fresh batches would hold none of them).
        gc.collect()
        gc.freeze()
        ctx.mark("jobs")
        verifier = ctx.overrides.get("verifier") or TorchVerifier(ctx.device)
        # Warm-up: the kernels build (first run in a checkout only) and run
        # once at this cell's batch size before the window.
        verifier.verify_batch(batches[0])
        ctx.mark("warm")
        if ctx.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cores = pin_caller(CALLER_CORES)
        masks, ends = [], []
        ctx.open_window()
        with devtrace.profiled(ctx.trace) as prof:
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            while time.perf_counter() < deadline:
                b = len(masks) % n_pool
                # Names the host's time in the trace, so the idle gaps
                # say whose call the card was waiting on.
                with torch.profiler.record_function("verify_batch"):
                    masks.append(verifier.verify_batch(batches[b]))
                ends.append(time.perf_counter())
            window = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
                else 0)
        calls = len(masks)
        # Judge, once the window has closed.
        wrong_labels = sum(int(np.count_nonzero(
            m != pool[i % n_pool]["label"])) for i, m in enumerate(masks))
        samples = [sample_of(ctx.seed, b, pool[b], int(t["sample_plain"]))
                   for b in range(n_pool)]
        lanes = [(pool[b]["pk"][i].tobytes(), pool[b]["msg"][i].tobytes(),
                  pool[b]["sig"][i].tobytes())
                 for b in range(n_pool) for i in samples[b]]
        verdicts = np.array(signing.oracle_verdicts(lanes, pool=workers))
        want, off = [], 0
        for b in range(n_pool):
            want.append(verdicts[off:off + len(samples[b])])
            off += len(samples[b])
        wrong_oracle = sum(int(np.count_nonzero(
            m[samples[i % n_pool]] != want[i % n_pool]))
            for i, m in enumerate(masks))
        layer = {"calls": calls, "lanes_per_call": n, "window_s": window}
        if ctx.trace:
            from ..roofline import kernels as roof

            s = prof["summary"]
            layer["trace"] = s
            # The least work of the window: each call's pool batch.
            ops = [roof.verify_least_ops(p["pk"], p["msg"], p["sig"],
                                         pool=workers) for p in pool]
            layer["verify_least_ops"] = sum(ops[i % n_pool]
                                            for i in range(calls))
            layer["lanes"] = calls * n
    failed = sum(1 for i, m in enumerate(masks)
                 if np.any(m != pool[i % n_pool]["label"]))
    device = {"kind": (torch.cuda.get_device_name(0)
                       if ctx.device == "cuda" else "cpu"),
              "memory_peak_bytes": int(peak)}
    out = {"e2e": {"verified_sigs_per_s": calls * n / window},
           "attempted": calls, "failed": failed,
           "checks": {"lanes_wrong_vs_oracle": (wrong_oracle, 0),
                      "lanes_wrong_vs_labels": (wrong_labels, 0)},
           "device": device, "layer": layer}
    out["detail"] = {"calls": calls, "window_s": window,
                     "ms_per_call": 1e3 * window / calls,
                     # Whether the pace drifts inside a run or is set per
                     # process: a call's mean time in each third.
                     "ms_per_call_thirds": [
                         1e3 * float(x.mean()) for x in np.array_split(
                             np.diff([t0] + ends), 3) if len(x)],
                     "build_s": card.build_seconds(),
                     "caller_cores": cores}
    if ctx.trace:
        s = layer["trace"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    if ctx.device == "cuda":
        device.update(card.smi())
    return out
