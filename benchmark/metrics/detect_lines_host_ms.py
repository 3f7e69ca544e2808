"""`detect_lines_host_ms`: host milliseconds per frame in line detection
(`online/detect_lines`, `kitti/detect_lines`, or the harness's own span
`detect_cuboid/detect_lines`), over the window's frames before the profiled
stretch."""

STAGES = ("online/detect_lines", "kitti/detect_lines", "detect_cuboid/detect_lines")


def read(ctx):
    found = [ctx["stages"][s]["host_s"] for s in STAGES if s in ctx["stages"]]
    return sum(found) * 1e3 if found else None
