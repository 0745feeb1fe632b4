"""The device trace of a traced run, reduced in process and not kept.

``torch.profiler`` records the card's activity (CUPTI) and the host's
operators over a span of the window. The reduction reads the raw trace
events (building the profiler's event tree would take far longer): the
union of the device's activity intervals gives its busy seconds; device
seconds are summed by kernel name; each idle gap between device intervals
is charged to what the host was doing at its middle, named by the
program's enclosing ``superinfer.*`` range, else the innermost host
operator, else ``python`` (host code outside any operator).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from portbench.record import TraceSummary

RANGE_PREFIX = "superinfer."
NAME_CHARS = 160        # kernel names are cut to this length in a breakdown


def start():
    """Start a profiler of device activity and host operators; return it."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)
    prof.start()
    return prof


def _span(e) -> Tuple[int, int]:
    s = e.start_ns()
    return s, s + e.duration_ns()


def _innermost(spans: List[Tuple[int, int, str]], starts: List[int],
               t: int, lookback: int) -> str:
    """The name of the latest-starting span of ``spans`` (sorted by
    start) that contains ``t``, looking back at most ``lookback`` spans."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        s, e, name = spans[j]
        if s <= t < e:
            return name
    return ""


def reduce(prof, t0: float, t1: float) -> TraceSummary:
    """Reduce a stopped profiler's trace of the host span ``[t0, t1]``."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int]] = []
    kernel_s: Dict[str, float] = defaultdict(float)
    ranges: List[Tuple[int, int, str]] = []
    ops: List[Tuple[int, int, str]] = []
    n = 0
    for e in prof.profiler.kineto_results.events():
        n += 1
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(RANGE_PREFIX):      # a range's device shadow
                continue
            s, f = _span(e)
            dev.append((s, f))
            kernel_s[name] += (f - s) / 1e9
        elif name.startswith(RANGE_PREFIX):
            ranges.append(_span(e) + (name,))
        elif name.startswith("aten::"):
            ops.append(_span(e) + (name,))
    dev.sort()
    merged: List[List[int]] = []
    for s, f in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], f)
        else:
            merged.append([s, f])
    busy_s = sum(f - s for s, f in merged) / 1e9
    ranges.sort()
    ops.sort()
    rs, os_ = [r[0] for r in ranges], [o[0] for o in ops]
    idle: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        label = (_innermost(ranges, rs, mid, 4)
                 or _innermost(ops, os_, mid, 64) or "python")
        idle["host:" + label] += (b - a) / 1e9
    inner = sum(idle.values())
    idle["trace edges"] = max((t1 - t0) - busy_s - inner, 0.0)
    return TraceSummary(t0=t0, t1=t1, busy_s=busy_s, kernel_s=dict(kernel_s),
                        idle_by_host=dict(idle), events=n)


def breakdown(t: TraceSummary, top: int = 10) -> Dict[str, list]:
    """The ``breakdown`` of a result line: the device operations that took
    most time, and the idle seconds by what the host was doing."""
    ops = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(t.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps]}
