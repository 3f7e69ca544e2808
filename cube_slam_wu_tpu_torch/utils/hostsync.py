"""Counting of blocking device-to-host reads, in total and by stage.

PyTorch runs eagerly, so every place where the host needs a value that lives
on the device (a loop's convergence flag, an overflow flag, the final pull of
the results) stalls the host until the device has caught up.  The port makes
each such read through this module, so that a run loop can report honestly how
many there were per frame and how many bytes they moved.

The drivers and the detector's layers mark their stages with `stage(label)`,
which books every read, upload and download made while it is open under its
label, how many times the stage was entered (`entries`), the host's seconds
inside it (`host_s`, inner stages included; on the card that is enqueue time
plus the blocking reads) and its self time (`self_s`: `host_s` less the
seconds its direct inner stages took, so that the self times of a stage and
of everything nested in it sum to its `host_s`).  Stages nest; a count goes
to the innermost open stage only, and outside every stage to `OUTSIDE`, so
the counts by stage always sum to the totals.  `add_count` books a count of
the program's own (not a read) under a stage by name.  While the torch profiler runs,
a stage is also a `torch.profiler.record_function(label)` range (what
`tools/profile_step.py` and a device trace read); otherwise it enters none,
since the range would record nothing and costs most of an empty stage's time.

The counts are safe to make from several threads at once (the pipelined
front end runs its two stages in two): each thread has its own stack of open
stages, and every update of the shared counts holds one lock.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.profiler import record_function

COUNTS = {"syncs": 0, "d2h_bytes": 0, "h2d_bytes": 0}
OUTSIDE = "other"
BY_STAGE: dict = {}
_NO_RANGE = contextlib.nullcontext()
_lock = threading.Lock()
# .open: this thread's stack of open stages, each [label, seconds of its
# finished inner stages]
_local = threading.local()


def _open() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def reset() -> None:
    with _lock:
        for k in COUNTS:
            COUNTS[k] = 0
        BY_STAGE.clear()


def snapshot() -> dict:
    """The totals, and under `by_stage` the counts of each stage label."""
    with _lock:
        return dict(COUNTS, by_stage={k: dict(v) for k, v in BY_STAGE.items()})


def delta(before: dict, after: dict, per: float = 1.0) -> dict:
    """What happened between two snapshots, divided by `per` (e.g. frames):
    the totals and, under `by_stage`, each label that was entered or counted
    anything in between."""
    out = {k: (after[k] - before[k]) / per for k in COUNTS}
    stages = {}
    for label, c in after["by_stage"].items():
        b = before["by_stage"].get(label, {})
        d = {k: (c[k] - b.get(k, 0)) / per for k in c}
        if any(d.values()):
            stages[label] = d
    out["by_stage"] = stages
    return out


def _book(label: str) -> dict:
    """The counts of `label` (call with `_lock` held)."""
    return BY_STAGE.setdefault(
        label, dict(dict.fromkeys(COUNTS, 0), entries=0, host_s=0.0, self_s=0.0))


def _count(key: str, n: int) -> None:
    stack = _open()
    with _lock:
        COUNTS[key] += n
        _book(stack[-1][0] if stack else OUTSIDE)[key] += n


@contextlib.contextmanager
def stage(label: str):
    """A labelled stage: the reads made inside it and its host seconds booked
    under `label`, and a profiler range while the profiler runs (see the
    module docstring)."""
    with record_function(label) if torch.autograd._profiler_enabled() else _NO_RANGE:
        with _lock:
            _book(label)["entries"] += 1
        stack = _open()
        frame = [label, 0.0]
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            seconds = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1][1] += seconds
            with _lock:
                book = _book(label)
                book["host_s"] += seconds
                book["self_s"] += seconds - frame[1]


def add_count(label: str, name: str, n) -> None:
    """Add `n` to the count `name` of the stage `label`, wherever the caller
    is: a count the program read with a pull it made anyway (the LM's
    rejected iterations of a frame, say), booked beside the stage's reads."""
    with _lock:
        book = _book(label)
        book[name] = book.get(name, 0) + n


def host_bool(flag: torch.Tensor) -> bool:
    """Read a scalar flag on the host (one blocking read)."""
    _count("syncs", 1)
    _count("d2h_bytes", flag.element_size() * flag.numel())
    return bool(flag)


def pull(tensors):
    """Copy a tuple of tensors to numpy arrays as ONE counted blocking read."""
    _count("syncs", 1)
    out = []
    for t in tensors:
        _count("d2h_bytes", t.element_size() * t.numel())
        out.append(t.detach().cpu().numpy())
    return tuple(out)


def push(array, device, dtype=None) -> torch.Tensor:
    """Copy a host array to `device`, counting its bytes."""
    t = torch.as_tensor(array)
    if dtype is not None:
        t = t.to(dtype)
    _count("h2d_bytes", t.element_size() * t.numel())
    return t.to(device)
