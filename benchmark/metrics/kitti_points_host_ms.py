"""`kitti_points_host_ms`: host milliseconds per frame in the step's stage
`step/points`: observation bookkeeping, DLT triangulation, the ground
bootstrap, the reprojection gate and demotion."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "step/points")
