"""The reading of a profiler trace, on made-up events: busy time is the
union of the device's operations, and an annotation range that the
profiler mirrors onto the device's timeline is none of them."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.harness import devtrace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, start_ms, end_ms, device, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(start_ms * 1e6),
        duration_ns=lambda: int((end_ms - start_ms) * 1e6),
        device_type=lambda: device, is_user_annotation=lambda: annotation)


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_time_leaves_out_annotation_ranges():
    events = [
        _event("verify_batch", 0, 100, CPU, annotation=True),
        _event("verify_batch", 10, 90, CUDA, annotation=True),
        _event("Memcpy HtoD", 10, 12, CUDA),
        _event("kernel_a", 80, 90, CUDA),
        _event("verify_batch", 100, 200, CPU, annotation=True),
        _event("verify_batch", 110, 190, CUDA, annotation=True),
        _event("Memcpy HtoD", 110, 112, CUDA),
        _event("kernel_a", 180, 190, CUDA),
    ]
    s = devtrace.summarize(_prof(events), 0.2)
    assert s["busy_s"] == pytest.approx(0.024)
    assert "verify_batch" not in s["by_name"]
    assert [name for name, _ in s["device_ops"]] == ["kernel_a",
                                                     "Memcpy HtoD"]
    # The longest gap, from one call's kernel to the next call's copy,
    # is named by the host range over it.
    assert s["idle_gaps"][0] == ["verify_batch", pytest.approx(0.068)]
