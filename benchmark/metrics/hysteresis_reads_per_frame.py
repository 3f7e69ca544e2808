"""`hysteresis_reads_per_frame`: blocking host reads per frame under the
program's stage `proposals/canny`, Canny's hysteresis flags (one per 16
dilations)."""

from harness.stages import reads


def read(ctx):
    return reads(ctx, ("proposals/canny",))
