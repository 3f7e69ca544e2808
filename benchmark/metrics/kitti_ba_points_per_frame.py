"""`kitti_ba_points_per_frame`: valid point landmarks per frame in the
window's joint solve, the program's count `ba_points` under its stage
`kitti/step` (read with the step's outputs in the frame's one pull)."""


def read(ctx):
    found = ctx["stages"].get("kitti/step")
    return None if found is None or "ba_points" not in found else found["ba_points"]
