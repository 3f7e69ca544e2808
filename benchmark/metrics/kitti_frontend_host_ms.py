"""`kitti_frontend_host_ms`: host milliseconds per frame in the KITTI
driver's front end, the program's stages `kitti/detect_lines` and
`kitti/proposals` (the proposal stages nested in it included), over the
window's frames before the profiled stretch."""

STAGES = ("kitti/detect_lines", "kitti/proposals")


def read(ctx):
    found = [ctx["stages"][s]["host_s"] for s in STAGES if s in ctx["stages"]]
    return sum(found) * 1e3 if found else None
