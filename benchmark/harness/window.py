"""The timed window: when each frame was taken and when its result reached
the host, and the profiled stretch at the window's end.

An entry calls `take(now)` when the system takes a frame from the source and
`done(frame, now)` when that frame's result is on the host.  A frame counts
when its result reached the host before the window's end.  In a traced run
the profiler runs over a short stretch that starts at the first frame taken
in the window's last `trace_seconds` and ends at the first access after the
window's end, with a synchronisation at both ends.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness.trace import STRETCH

clock = time.perf_counter


class Tracer:
    """The profiler over the stretch, and the program's host-read counts at
    its start and end."""

    def __init__(self, seconds: float, snapshot, spans, cuda: bool):
        self.seconds = seconds
        self.snapshot = snapshot  # () -> the program's counts (utils.hostsync)
        self.spans = spans  # the harness's own spans (Spans)
        self.cuda = cuda
        self.prof = None
        self.state = "idle"  # idle -> running -> stopped

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self, frames_before: int):
        self._sync()
        self.frames_before = frames_before
        self.counts_before = self.snapshot()
        self.spans_before = self.spans.copy()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.mark = record_function(STRETCH)
        self.mark.__enter__()
        self.t0 = clock()
        self.state = "running"

    def stop(self, frames_taken: int):
        self._sync()
        self.t1 = clock()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.frames_traced = frames_taken - self.frames_before
        self.state = "stopped"


class Window:
    clock = staticmethod(clock)

    def __init__(self, seconds: float, tracer: Tracer | None = None):
        self.seconds = float(seconds)
        self.tracer = tracer
        self.takes: list = []  # take time of each frame, in order
        self.results: dict = {}  # frame -> time its result was on the host

    def start(self):
        self.t0 = clock()
        self.deadline = self.t0 + self.seconds

    def open(self, now: float | None = None) -> bool:
        """Whether the window is still open; at the first access after its
        end this also ends the profiled stretch."""
        now = clock() if now is None else now
        if now < self.deadline:
            return True
        if self.tracer is not None and self.tracer.state == "running":
            self.tracer.stop(self.taken_in_window())
        return False

    def take(self, now: float | None = None) -> int:
        """The system takes a frame: returns the frame's number."""
        now = clock() if now is None else now
        t = self.tracer
        if t is not None and t.state == "idle" and self.deadline - now <= t.seconds:
            t.start(len(self.takes))
            now = clock()
        self.takes.append(now)
        return len(self.takes) - 1

    def done(self, frame: int, now: float | None = None) -> None:
        self.results.setdefault(frame, clock() if now is None else now)

    def taken_in_window(self) -> int:
        return sum(1 for t in self.takes if t < self.deadline)

    def counted(self) -> list:
        """Frames whose result reached the host inside the window."""
        return sorted(f for f, t in self.results.items() if t <= self.deadline)

    def latencies_s(self) -> list:
        return [self.results[f] - self.takes[f] for f in self.counted()]
