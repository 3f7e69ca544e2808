"""`setup_s`: from the start of the benchmark's process to the window's
start: imports, the kernel build (cached after a checkout's first run), the
world's rendering and the warm-up frames."""


def read(run):
    return run.setup_s
