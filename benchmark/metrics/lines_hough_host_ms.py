"""`lines_hough_host_ms`: self host milliseconds per frame of the program's stage
`lines/hough`: the edge pixels, the Hough vote and its peaks
(`ops/detect.py::edge_pixels`, `hough_accumulate`, `hough_peaks`)."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "lines/hough")
