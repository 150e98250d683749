"""Profiler traces (port of the part of ``fairfedmed_tpu/utils/profiling.py``
the trainer uses): ``profile_trace(log_dir, device)`` records the enclosed
region with ``torch.profiler`` and writes a Chrome trace (viewable in
Perfetto or chrome://tracing) into ``log_dir``."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cpu"):
    """Trace the host (and, on a CUDA device, the card) while the block runs;
    the trace is written when the block ends, also on an error."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"Wrote profiler trace to {log_dir}")
