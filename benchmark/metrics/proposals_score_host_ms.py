"""`proposals_score_host_ms`: self host milliseconds per frame of the program's
stage `proposals/score`: the hypothesis grid's loop over corner
configurations: corner chains, angle and distance scores, lifting, the gather
caps."""

from harness.stages import self_ms


def read(ctx):
    return self_ms(ctx, "proposals/score")
