"""`proposals_rank_host_ms`: self host milliseconds per frame of the program's
stage `proposals/rank`: score fusion, the top-k and the result's gathers
(`ops/proposal.py::_fuse_and_rank`)."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/rank")
