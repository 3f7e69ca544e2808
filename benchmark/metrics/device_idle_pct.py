"""`device_idle_pct`: the share of the profiled stretch in which no device
activity (kernel, copy or set) ran, in percent."""

from harness.trace import busy_ns


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.end_ns <= tr.start_ns:
        return None
    return 100.0 * (1.0 - busy_ns(tr) / (tr.end_ns - tr.start_ns))
