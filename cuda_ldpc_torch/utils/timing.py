"""Timing and tracing helpers of the measuring tools (bench, --profile,
tools/profile_phases, tools/probe_oprate)."""

from __future__ import annotations

import time

import torch


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Milliseconds a call of ``fn()``: CUDA events around ``reps`` calls
    after a warm-up one on a CUDA device, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        for _ in range(reps):
            fn()
        events[1].record()
        events[1].synchronize()
        return events[0].elapsed_time(events[1]) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def profiler_activities(device: torch.device) -> list:
    """What torch.profiler records on ``device``: the CPU, and CUDA
    activity on a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
