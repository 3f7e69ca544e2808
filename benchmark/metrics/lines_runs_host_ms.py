"""`lines_runs_host_ms`: self host milliseconds per frame of the program's stage
`lines/runs`: the rest of `ops/detect.py::detect_line_segments` (the raster
walk, run extraction and re-fit, duplicate removal, compactions, the final
top-K), without the Hough stage and the merge."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "lines/runs")
