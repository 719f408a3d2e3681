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


# what ``traced`` has taken in this process: traces, those with no device operation, and
# those that lost some calls' operations (``group_norm_ab.profiled`` counts these)
trace_counts = {"traces": 0, "empty": 0, "lost": 0}


def traced(fn, tries: int = 8, pause_s: float = 0.05):
    """``fn()`` (which ends in a synchronise) under ``torch.profiler`` with CUDA activity:
    ``(profile, fn's result)``. Now and then the card's tracer records no device operation
    at all, in runs of a few short traces in a row. Such a trace is no measurement, so it
    is taken again after a pause that doubles each time (``pause_s``, then twice that, ...:
    6.35 s in all over 8 tries), and when every try came back empty this raises. Each
    trace is counted in ``trace_counts``."""
    import sys

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
        trace_counts["traces"] += 1
        if any(e.device_type == DeviceType.CUDA for e in prof.key_averages()):
            return prof, out
        trace_counts["empty"] += 1
        if k + 1 < tries:
            print(f"[profiler] trace {k + 1} of {tries} recorded no device operation; "
                  f"tracing again in {pause_s * 2**k:.2f} s", file=sys.stderr, flush=True)
            time.sleep(pause_s * 2**k)
    raise RuntimeError(f"torch.profiler recorded no device operation in {tries} traces")
