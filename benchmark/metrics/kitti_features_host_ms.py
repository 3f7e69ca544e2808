"""`kitti_features_host_ms`: host milliseconds per frame in the program's
stage `kitti/features`: the incremental Harris + ZNCC point tracker
(`slam/features.py::IncrementalTracker.advance`) and its read."""


def read(ctx):
    found = ctx["stages"].get("kitti/features")
    return None if found is None else found["host_s"] * 1e3
