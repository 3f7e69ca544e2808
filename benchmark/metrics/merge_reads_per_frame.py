"""`merge_reads_per_frame`: blocking host reads per frame under the program's
stages `lines/merge` and `proposals/merge`, the collinear merge's flags (one a
round)."""

from harness.stages import reads


def read(ctx):
    return reads(ctx, ("lines/merge", "proposals/merge"))
