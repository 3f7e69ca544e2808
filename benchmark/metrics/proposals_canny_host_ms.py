"""`proposals_canny_host_ms`: self host milliseconds per frame of the program's
stage `proposals/canny`: the ROI copies and Canny
(`ops/image.py::replicate_roi`, `canny`) with the hysteresis flag reads."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/canny")
