"""Aggregating wall-clock profiler + torch.profiler hooks.

Replaces the reference's `ca::Profiler` (dependency/tictoc_profiler/
include/tictoc_profiler/profiler.hpp:54-84): named tictoc sections into a
global registry with aggregated stats, plus a `torch.profiler` trace of a
code region.

A section times the host.  On the card that is the time to enqueue the work
unless the code inside blocks (a host read, a synchronisation); no
synchronisation is added here.  For the card's own time use CUDA events
(`tools/cardtime.time_ms`) or `torch_trace`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class _Entry:
    total: float = 0.0
    count: int = 0
    min_t: float = float("inf")
    max_t: float = 0.0

    def add(self, dt: float) -> None:
        self.total += dt
        self.count += 1
        self.min_t = min(self.min_t, dt)
        self.max_t = max(self.max_t, dt)


@dataclass
class Profiler:
    """tictoc(name) toggles a named timer; aggregated stats on report."""

    enabled: bool = True
    _open: dict = field(default_factory=dict)
    _agg: dict = field(default_factory=lambda: defaultdict(_Entry))

    def tictoc(self, name: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        if name in self._open:
            self._agg[name].add(now - self._open.pop(name))
        else:
            self._open[name] = now

    @contextlib.contextmanager
    def section(self, name: str):
        self.tictoc(name)
        try:
            yield
        finally:
            self.tictoc(name)

    def report(self) -> str:
        rows = sorted(
            self._agg.items(), key=lambda kv: kv[1].total / max(kv[1].count, 1), reverse=True
        )
        lines = [f"{'name':<40} {'calls':>6} {'avg ms':>9} {'min ms':>9} {'max ms':>9} {'total ms':>10}"]
        for name, e in rows:
            avg = e.total / max(e.count, 1)
            lines.append(
                f"{name:<40} {e.count:>6} {avg * 1e3:>9.2f} {e.min_t * 1e3:>9.2f} "
                f"{e.max_t * 1e3:>9.2f} {e.total * 1e3:>10.1f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._open.clear()
        self._agg.clear()


GLOBAL = Profiler()
tictoc = GLOBAL.tictoc
section = GLOBAL.section


@contextlib.contextmanager
def torch_trace(logdir):
    """Capture a `torch.profiler` trace of a code region (host, and the card
    where there is one) and write it to `logdir/trace.json` in the Chrome
    trace format.  The JAX package's counterpart is `xla_trace`, a
    `jax.profiler` trace in TensorBoard's format."""
    import pathlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / "trace.json"))
