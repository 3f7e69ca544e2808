"""`kitti_lm_replays_per_frame`: the joint LM's CUDA-graph replays per frame,
the program's count `lm_replays` under its stage `kitti/step` (a host count
that `slam/tracker.py::make_windowed_point_step` books per LM replayed from
its graph).  1.0 when every counted frame replayed; a program without the
count gives None."""


def read(ctx):
    found = ctx["stages"].get("kitti/step")
    return None if found is None or "lm_replays" not in found else found["lm_replays"]
