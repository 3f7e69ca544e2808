"""`kitti_absorb_replays_per_frame`: the prior's absorptions replayed from
their CUDA graph per frame, the program's count `absorb_replays` under its
stage `kitti/step` (a host count that `slam/tracker.py::
make_windowed_point_step` books per absorption replayed from its graph).
1.0 when every counted frame replayed; a program without the count gives
None."""


def read(ctx):
    found = ctx["stages"].get("kitti/step")
    return None if found is None or "absorb_replays" not in found else found["absorb_replays"]
