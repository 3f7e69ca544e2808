"""The reduction from a profiler trace to device numbers.

The arithmetic of the port's `tools/profile_step.py` (device time summed by
kernel, kernels per frame, the device's idle share), applied to the raw
events of one short profiled stretch rather than to `key_averages()`, whose
event tree is too slow to build for whole runs: busy time is the union of the
device's activity intervals (kernels, copies, sets) inside the stretch, so
that overlapping streams are not counted twice.  An idle gap of the device is
put down to the innermost labelled range (`record_function`: the program's
`utils.hostsync` stages and the harness's own spans) that was open on the
host at the gap's middle.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

OUTSIDE = "outside every stage"
STRETCH = "bench/stretch"  # the harness's mark around the whole stretch


class Trace(NamedTuple):
    kernels: list  # [(name, start_ns, end_ns)] device activities, by start
    ranges: list  # [(label, start_ns, end_ns)] host labelled ranges
    start_ns: int
    end_ns: int


def collect(prof, start_ns: int, end_ns: int) -> Trace:
    """The device activities and host labelled ranges of a finished
    `torch.profiler.profile`, clipped to [start_ns, end_ns] (the stretch, on
    the profiler's clock)."""
    kernels, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= start_ns or s >= end_ns:
            continue
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.is_user_annotation():
            if not on_device and e.name() != STRETCH:
                ranges.append((e.name(), s, t))
        elif on_device:
            kernels.append((e.name(), max(s, start_ns), min(t, end_ns)))
    kernels.sort(key=lambda k: k[1])
    return Trace(kernels, ranges, start_ns, end_ns)


def busy_intervals(kernels) -> list:
    """The union of the activity intervals, as sorted disjoint [s, t]."""
    merged: list = []
    for _, s, t in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_ns(trace: Trace) -> int:
    return sum(t - s for s, t in busy_intervals(trace.kernels))


def top_ops(trace: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations with the most time."""
    total: dict = {}
    for name, s, t in trace.kernels:
        total[name] = total.get(name, 0) + (t - s)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_by_stage(trace: Trace, n: int = 10) -> list:
    """[[label, seconds]]: the device's idle time inside the stretch, each gap
    put down to the innermost labelled host range open at its middle, the n
    labels with the most."""
    gaps, cursor = [], trace.start_ns
    for s, t in busy_intervals(trace.kernels):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if trace.end_ns > cursor:
        gaps.append((cursor, trace.end_ns))
    ranges = sorted(trace.ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    total: dict = {}
    for s, t in gaps:
        mid = (s + t) // 2
        label, best = OUTSIDE, None
        for name, rs, rt in ranges[: bisect.bisect_right(starts, mid)]:
            if rt >= mid and (best is None or rs >= best):
                label, best = name, rs
        total[label] = total.get(label, 0) + (t - s)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[label, ns / 1e9] for label, ns in top]


def count(trace: Trace, substring: str) -> list:
    """Durations in seconds of the device activities whose name holds
    `substring`."""
    return [(t - s) / 1e9 for name, s, t in trace.kernels if substring in name]
