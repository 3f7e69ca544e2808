"""`proposals_grid_host_ms`: self host milliseconds per frame of the program's
stage `proposals/grid`: the sample grids and the hypothesis grid
(`ops/proposal.py::_proposal_setup`, `hypothesis_grid`) without the stages
nested in them: camera products per roll/pitch, vanishing points, broadcasts,
the ROI line compaction, `vp_support_edge_angles`."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/grid")
