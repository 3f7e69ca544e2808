"""`proposals_merge_host_ms`: self host milliseconds per frame of the program's
stage `proposals/merge`: the per-ROI merge of the hypothesis grid
(`ops/lines.py::merge_break_lines`) with its flag reads."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/merge")
