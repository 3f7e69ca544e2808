"""The harness's own spans around calls into the program: host seconds and
entries by label, each also a `record_function` range, so that a profiled
stretch can put the device's idle gaps down to them."""

from __future__ import annotations

import contextlib
import time

from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.by_label: dict = {}

    @contextlib.contextmanager
    def span(self, label: str):
        with record_function(label):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                book = self.by_label.setdefault(label, {"entries": 0, "host_s": 0.0})
                book["entries"] += 1
                book["host_s"] += time.perf_counter() - t0

    def copy(self) -> dict:
        return {k: dict(v) for k, v in self.by_label.items()}
