"""Profiling utilities (port of ``fairfedmed_tpu/utils/profiling.py``).

``profile_trace(log_dir, device)`` records the enclosed region with
``torch.profiler`` and writes a Chrome trace (viewable in Perfetto or
chrome://tracing) into ``log_dir``; ``HostTimers`` are named cumulative host
timers; ``stamp`` prints a phase stamp on stderr when timing is switched on,
``PhaseTimer`` the ``FAIRFEDMED_TIMING=1`` phase lines of the client-parallel
rounds on stdout, and ``heartbeat`` / ``heartbeat_age`` record and read the
last milestone.  Over several ranks only rank 0 prints."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.distributed as dist


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


_last_stamp: List[float] = []
_heartbeat: List[float] = [time.monotonic()]


def heartbeat() -> None:
    """Record forward progress (cheap, unconditional); ``heartbeat_age``
    reads how long ago the last milestone was."""
    _heartbeat[0] = time.monotonic()


def heartbeat_age() -> float:
    return time.monotonic() - _heartbeat[0]


def _other_rank() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_rank() != 0


def stamp(label: str) -> None:
    """One-off phase stamp on stderr (stdout carries the CLI's log), with the
    time since the previous stamp.  Printed only when FAIRFEDMED_TIMING=1 or
    FAIRFEDMED_BUILD_STAMPS=1, and on rank 0; every call records a
    heartbeat."""
    heartbeat()
    if (os.environ.get("FAIRFEDMED_TIMING") != "1"
            and os.environ.get("FAIRFEDMED_BUILD_STAMPS") != "1") or _other_rank():
        return
    now = time.perf_counter()
    delta = f" +{now - _last_stamp[-1]:.1f}s" if _last_stamp else ""
    _last_stamp[:] = [now]
    print(f"[timing] {label}{delta}", file=sys.stderr, flush=True)


class PhaseTimer:
    """``[timing] <label>: <s>s`` lines on stdout, each timing the span since
    the previous line (or the timer's creation), when FAIRFEDMED_TIMING=1 at
    creation, on rank 0; otherwise every call does nothing.  ``lap(label,
    fence=True)`` first waits for ``device`` when it is a CUDA device, so
    the span covers the work enqueued in it: the fences run only with
    timing on."""

    def __init__(self, device=None):
        self.on = os.environ.get("FAIRFEDMED_TIMING") == "1" and not _other_rank()
        self.device = torch.device(device) if device is not None else None
        self.t0 = time.perf_counter()

    def lap(self, label: str, fence: bool = False) -> None:
        if not self.on:
            return
        if fence and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"[timing] {label}: {now - self.t0:.3f}s")
        self.t0 = now


class HostTimers:
    """Named cumulative host timers: ``with timers.timed('round'): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.laps: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.laps[name].append(dt)

    def summary(self) -> str:
        return "  ".join(f"{k}: {v:.2f}s/{len(self.laps[k])}x"
                         for k, v in sorted(self.totals.items()))
