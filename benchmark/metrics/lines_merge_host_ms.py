"""`lines_merge_host_ms`: self host milliseconds per frame of the program's stage
`lines/merge`: the detector's collinear merge
(`ops/lines.py::merge_break_lines`) with its one flag read a round."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "lines/merge")
