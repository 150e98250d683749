"""Reduction of a ``torch.profiler`` chrome trace to the traced window's
device busy time, its idle gaps named by the harness span that was open,
and the device operations that took most time.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  Busy time is the union of their intervals inside the
window, so overlapping operations count once.  The window runs from the
start of the first harness span (``bench:<name>``, recorded with
``torch.profiler.record_function``) to the end of the last.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"


@dataclasses.dataclass
class TraceView:
    window_s: float
    busy_s: float
    ops: list  # (name, start_s, duration_s) of every device operation, window start = 0
    gaps: list  # (span name, seconds) of every idle gap, longest first
    device_ops: list  # (name, total seconds), most first


def _union(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce_trace(path: str) -> TraceView:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            ops.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                          e["name"][len(SPAN_PREFIX):]))
    if not spans:
        raise RuntimeError(f"the trace {path} holds no {SPAN_PREFIX}* span")
    spans.sort()
    lo, hi = spans[0][0], max(s[1] for s in spans)
    inside = [(max(s, lo), min(e, hi)) for _, s, e in ops if e > lo and s < hi]
    busy = _union(inside)
    gaps, cursor = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > cursor:
            gaps.append((_open_span(spans, cursor), (s - cursor) * 1e-6))
        cursor = max(cursor, e)
    per_name = defaultdict(float)
    for name, s, e in ops:
        if e > lo and s < hi:
            per_name[name] += (min(e, hi) - max(s, lo)) * 1e-6
    return TraceView(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        ops=[(n, (s - lo) * 1e-6, (e - s) * 1e-6) for n, s, e in ops if e > lo and s < hi],
        gaps=sorted(gaps, key=lambda g: -g[1]),
        device_ops=sorted(per_name.items(), key=lambda kv: -kv[1]))


def _open_span(spans, t):
    """The innermost harness span open at ``t`` ("between" when none is)."""
    name = "between"
    for s, e, n in spans:
        if s > t:
            break
        if t < e:
            name = n
    return name
