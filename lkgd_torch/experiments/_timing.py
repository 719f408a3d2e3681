"""Timing shared by the port's microbenchmarks and ``chip_smoke.py``: CUDA events on the
card, a host clock on the CPU (where the numbers only show that the script runs), and
device traces under ``torch.profiler``."""

from __future__ import annotations

import subprocess
import time

import torch


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a CPU notice."""
    if device.type != "cuda":
        return "device: cpu (plain PyTorch versions; times are host times, not the card's)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up call."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def traced(fn, tries: int = 3):
    """``fn()`` (which ends in a synchronise) under ``torch.profiler`` with CUDA activity:
    ``(profile, fn's result)``. Now and then the card's tracer records no device operation
    at all; such a trace is no measurement, so it is taken again, up to ``tries`` times,
    and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
        if any(e.device_type == DeviceType.CUDA for e in prof.key_averages()):
            return prof, out
    raise RuntimeError(f"torch.profiler recorded no device operation in {tries} traces")
