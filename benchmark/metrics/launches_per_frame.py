"""`launches_per_frame`: device kernels per frame in the profiled stretch
(copies and sets left out)."""


def read(ctx):
    tr, frames = ctx["trace"], ctx["frames_traced"]
    if tr is None or frames <= 0:
        return None
    n = sum(1 for name, _, _ in tr.kernels if not name.startswith(("Memcpy", "Memset")))
    return n / frames
