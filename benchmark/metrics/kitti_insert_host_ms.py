"""`kitti_insert_host_ms`: host milliseconds per frame in the step's stage
`step/insert`: the frame's insertion (constant-velocity pose, soft innovation
gate, edges, new vertices) and the departing frame's absorption into the
cuboid prior."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "step/insert")
