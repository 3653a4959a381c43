"""The roofline arithmetic on tiny inputs."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import signing
from benchmark.roofline import kernels


def _digits(x: int) -> list[int]:
    """ref10's slide() recoding of x, by the textbook loop."""
    out, i = [], 0
    while x:
        if x & 1:
            d = x & 31
            d = d - 32 if d > 16 else d
            out.append((i, d))
            x -= d
        x >>= 1
        i += 1
    return out


@pytest.mark.parametrize("x", [1, 2, 31, 32, 255, 2**252 + 12345,
                               2**256 - 1, 0x1F1F1F1F])
def test_wnaf5_counts_the_recoding(x):
    digits = _digits(x)
    assert sum(d << i for i, d in digits) == x
    assert all(abs(d) <= 15 and d % 2 for _, d in digits)
    assert kernels.wnaf5(x) == (len(digits), digits[-1][0])


def test_wnaf5_of_zero():
    assert kernels.wnaf5(0) == (0, -1)


def test_verify_lane_ops_by_hand():
    # S = 1, h = 1: one nonzero digit each at bit 0, so one doubling row.
    muls = 20 + 13 + 68 + 3 * 1 + 8 + 7
    sqs = 255 + 254 + 4 + 4 * 1
    assert kernels.verify_lane_ops(1, 1) == (muls * kernels.MUL_INT_OPS
                                             + sqs * kernels.SQ_INT_OPS)


def test_batch_least_ops_is_the_sum_of_its_lanes():
    lanes = signing.sign_lanes(3, "r", 6, 2, 1, 1)
    total = kernels.verify_least_ops(lanes["pk"], lanes["msg"], lanes["sig"])
    by_lane = sum(kernels.verify_lane_ops(
        int.from_bytes(lanes["sig"][i, 32:].tobytes(), "little"),
        kernels.challenge(lanes["pk"][i].tobytes(), lanes["msg"][i].tobytes(),
                          lanes["sig"][i].tobytes())) for i in range(6))
    assert total == by_lane


def test_bounds_and_peaks():
    assert kernels.CHALLENGE_INT_OPS == 3492
    assert kernels.PEAK_INT32_OPS_S == 132 * 64 * 1.98e9
    t, bound = kernels.challenge_least_seconds(100_000)
    assert bound == "operations"
    assert t == pytest.approx(100_000 * 3492 / kernels.PEAK_INT32_OPS_S)
    t, bound = kernels.least_seconds(0, 3.35e12)
    assert (t, bound) == (1.0, "bytes")


def test_roofline_readers_on_a_made_up_trace():
    from benchmark.harness import core

    trace = {"busy_s": 0.004, "window_s": 0.1, "by_name": {
        kernels.VERIFY_KERNEL: {"seconds": 0.01, "count": 2},
        kernels.CHALLENGE_KERNEL: {"seconds": 0.0001, "count": 2},
        "Memcpy HtoD (Pageable -> Device)": {"seconds": 0.002, "count": 8}}}
    layer = {"trace": trace, "calls": 2, "lanes": 200_000,
             "verify_least_ops": 2 * 10**12}
    share = core.load_reader("verify_kernel.roofline_share.bulk").read(layer)
    assert share == pytest.approx(
        100 * 2e12 / kernels.PEAK_INT32_OPS_S / 0.01)
    assert core.load_reader("provider.h2d_ms_per_batch.bulk").read(
        layer) == pytest.approx(1.0)
    assert core.load_reader("device.idle_share.bulk").read(
        layer) == pytest.approx(96.0)
    layer["calls"] = 3  # a launch missing from the trace: no reading
    assert core.load_reader("verify_kernel.roofline_share.bulk").read(
        layer) is None
    assert np.isfinite(core.load_reader(
        "challenge_kernel.roofline_share.bulk").read(dict(layer, calls=2)))
