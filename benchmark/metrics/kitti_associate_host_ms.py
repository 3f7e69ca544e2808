"""`kitti_associate_host_ms`: host milliseconds per frame in the program's
stage `kitti/associate`: stale-track retirement, the IoU association, the 3D
gate, spawning and measuring, and the frame's assembly on the device."""


def read(ctx):
    found = ctx["stages"].get("kitti/associate")
    return None if found is None else found["host_s"] * 1e3
