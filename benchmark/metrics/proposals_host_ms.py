"""`proposals_host_ms`: host milliseconds per frame in the cuboid proposals
(`online/proposals` with `online/cap_check` and `online/proposals_caps_off`,
`kitti/proposals`, or the harness's own span `detect_cuboid/proposals`), over
the window's frames before the profiled stretch."""

STAGES = ("online/proposals", "online/cap_check", "online/proposals_caps_off",
          "kitti/proposals", "detect_cuboid/proposals")


def read(ctx):
    found = [ctx["stages"][s]["host_s"] for s in STAGES if s in ctx["stages"]]
    return sum(found) * 1e3 if found else None
