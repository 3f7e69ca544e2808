"""`kitti_lm_host_ms`: host milliseconds per frame in the step's stage
`step/lm`: the joint camera-cuboid-point LM with its Schur solve
(`slam/point_ba.py::optimize`)."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "step/lm")
