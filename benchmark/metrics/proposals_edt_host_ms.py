"""`proposals_edt_host_ms`: self host milliseconds per frame of the program's
stage `proposals/edt`: the ROI mask and the distance transform
(`ops/image.py::distance_transform`, the `edt_row_min` launch)."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/edt")
