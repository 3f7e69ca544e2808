"""`kitti_lm_rejected_per_frame`: LM iterations per frame whose step was
not taken, the program's count `lm_rejected` under its stage `kitti/step`
(read with the step's outputs in the frame's one pull)."""


def read(ctx):
    found = ctx["stages"].get("kitti/step")
    return None if found is None or "lm_rejected" not in found else found["lm_rejected"]
