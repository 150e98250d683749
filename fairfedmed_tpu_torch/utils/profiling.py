"""Profiling utilities (port of ``fairfedmed_tpu/utils/profiling.py``) and
the port's span recorder.

``profile_trace(log_dir, device)`` records the enclosed region with
``torch.profiler`` and writes a Chrome trace (viewable in Perfetto or
chrome://tracing) into ``log_dir``; ``stamp`` prints a phase stamp on stderr
when timing is switched on.

The recorder.  ``span(name, round=None, **attrs)`` marks a region of the
host's work: a phase of the round driver, a local step and its parts, the
round's one blocking fetch, the fill of a device cache.  It is off by
default, and off a span site costs one check of a module flag.  After
``enable()`` every span keeps, in memory, its name, its parent, its start
and end (``time.perf_counter`` seconds), its round (the epoch, inherited
from the enclosing span when not given: a deferred round's fetch runs after
the next round's dispatch, and the round ties them) and its attributes, and
opens ``torch.profiler.record_function("ffm:<name>")``, so that a profiler
recording at the time holds it in its Chrome trace as a ``user_annotation``
on the clock of the device's events.  ``snapshot()`` returns the finished
spans, ``HostTimers.of(spans)`` sums them per name (calls, total and self
seconds: the duration less the parts covered by child spans), ``reset()``
drops them and ``disable()`` stops recording.  No span waits for the device.
Spans are opened by the one thread that drives the rounds.

The printing exporter.  With ``FAIRFEDMED_TIMING=1`` (read by
``read_timing_env`` at the start of each round; rank 0 only) every span that
carries a ``line`` prints ``[timing] <line>: <s>s`` on stdout when it ends,
the JAX runner's phase lines; a span with a CUDA ``fence`` device first waits
for it, as the JAX runner's fenced lines do, and only then.  Over several
ranks only rank 0 prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

PREFIX = "ffm:"  # the spans' names in a profiler's trace


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cpu"):
    """Trace the host (and, on a CUDA device, the card) while the block runs;
    the trace is written when the block ends, also on an error, after the
    device has run what the block enqueued."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"Wrote profiler trace to {log_dir}")


_last_stamp: List[float] = []


def _other_rank() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_rank() != 0


def stamp(label: str) -> None:
    """One-off phase stamp on stderr (stdout carries the CLI's log), with the
    time since the previous stamp.  Printed only when FAIRFEDMED_TIMING=1 or
    FAIRFEDMED_BUILD_STAMPS=1, and on rank 0."""
    if (os.environ.get("FAIRFEDMED_TIMING") != "1"
            and os.environ.get("FAIRFEDMED_BUILD_STAMPS") != "1") or _other_rank():
        return
    now = time.perf_counter()
    delta = f" +{now - _last_stamp[-1]:.1f}s" if _last_stamp else ""
    _last_stamp[:] = [now]
    print(f"[timing] {label}{delta}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class SpanRecord:
    """A finished span; ``parent`` is the enclosing span's ``id``."""

    id: int
    name: str
    parent: Optional[int]
    round: Optional[int]
    start: float
    end: float
    self_s: float
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


class HostTimers:
    """Named cumulative host timers: per name the calls' seconds (``laps``),
    their sum (``totals``) and their self seconds (``self_totals``: each
    call's seconds less its children's).  ``with timers.timed('round'):``
    times a block; ``HostTimers.of(spans)`` sums the recorder's spans."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.self_totals: Dict[str, float] = defaultdict(float)
        self.laps: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, seconds: float, self_seconds: float = None) -> None:
        self.totals[name] += seconds
        self.self_totals[name] += seconds if self_seconds is None else self_seconds
        self.laps[name].append(seconds)

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @classmethod
    def of(cls, spans) -> "HostTimers":
        timers = cls()
        for s in spans:
            timers.add(s.name, s.seconds, s.self_s)
        return timers

    def summary(self) -> str:
        return "  ".join(f"{k}: {v:.2f}s/{len(self.laps[k])}x"
                         for k, v in sorted(self.totals.items()))

    def table(self) -> str:
        """One line per name: calls, total and self seconds."""
        rows = [f"{'span':<20} {'calls':>6} {'total_s':>10} {'self_s':>10}"]
        rows += [f"{k:<20} {len(self.laps[k]):>6} {v:>10.4f} {self.self_totals[k]:>10.4f}"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(rows)


_active = False  # recording or printing: the flag every span site checks
_recording = False
_printing = False
_spans: List[SpanRecord] = []
_open: list = []  # the open spans, innermost last
_ids = itertools.count()


class _Off:
    """What ``span`` returns while the recorder and the printer are off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def quiet(self) -> None:
        pass


_OFF = _Off()


class _Open:
    """An open span: its place in the tree, its start, its children's
    seconds and its profiler range."""

    __slots__ = ("name", "round", "attrs", "line", "fence", "id", "parent", "start",
                 "child_s", "annotation")

    def __init__(self, name, round, line, fence, attrs):
        self.name, self.round, self.line, self.fence, self.attrs = name, round, line, fence, attrs

    def quiet(self) -> None:
        """Print no ``[timing]`` line for this span (a phase that gave up)."""
        self.line = None

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.parent = outer.id if outer is not None else None
        if self.round is None and outer is not None:
            self.round = outer.round
        self.id, self.child_s, self.annotation = next(_ids), 0.0, None
        if _recording:
            self.annotation = torch.profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        _open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        line = self.line if _printing and exc_type is None else None
        if line is not None and self.fence is not None and self.fence.type == "cuda":
            torch.cuda.synchronize(self.fence)
        end = time.perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(exc_type, exc, tb)
        _open.pop()
        seconds = end - self.start
        if _open:
            _open[-1].child_s += seconds
        if self.annotation is not None:
            _spans.append(SpanRecord(self.id, self.name, self.parent, self.round, self.start,
                                     end, seconds - self.child_s, self.attrs))
        if line is not None:
            print(f"[timing] {line}: {seconds:.3f}s")
        return False


def span(name: str, round: int = None, line: str = None, fence: torch.device = None, **attrs):
    """A context manager marking ``name`` (see the module's docstring);
    ``line`` and ``fence`` are its ``[timing]`` line and that line's device
    wait."""
    if not _active:
        return _OFF
    return _Open(name, round, line, fence, attrs)


def _set(recording: bool = None, printing: bool = None) -> None:
    global _active, _recording, _printing
    if recording is not None:
        _recording = recording
    if printing is not None:
        _printing = printing
    _active = _recording or _printing


def enable() -> None:
    """Record every span from now on."""
    _set(recording=True)


def disable() -> None:
    _set(recording=False)


@contextlib.contextmanager
def recording():
    """Record the spans of the block, then go back to the previous state."""
    was = _recording
    enable()
    try:
        yield
    finally:
        _set(recording=was)


def snapshot(rounds=None) -> List[SpanRecord]:
    """The finished spans in the order they ended (of ``rounds`` only, when
    given)."""
    if rounds is None:
        return list(_spans)
    rounds = set(rounds)
    return [s for s in _spans if s.round in rounds]


def reset() -> None:
    _spans.clear()


def read_timing_env() -> None:
    """Print the ``[timing]`` lines from now on when FAIRFEDMED_TIMING=1 and
    this is rank 0."""
    _set(printing=os.environ.get("FAIRFEDMED_TIMING") == "1" and not _other_rank())
