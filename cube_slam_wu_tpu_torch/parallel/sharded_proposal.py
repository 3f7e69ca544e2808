"""Hypothesis-grid tensor parallelism for the cuboid proposal engine.

The reference's proposal loop is single-threaded C++ (SURVEY.md section 2.9:
no TP of any kind); the scale-out for "per-frame work exceeds one device" is
to split the (roll, pitch) sample axis of the hypothesis grid over the ranks
of a process group:

- the image, lines, calibration and box are replicated (small),
- each rank runs `ops.proposal.hypothesis_grid` on its roll/pitch slice —
  the corner chains, chamfer dist-map gathers, VP-angle scores and 3D
  lifting, i.e. all of the per-hypothesis work,
- the per-hypothesis arrays are gathered along the hypothesis axis — the
  only communication, a few (H,) vectors,
- score fusion + ranking (`_fuse_and_rank`) min-max-normalise over ALL
  hypotheses of a height sample, so they run on the gathered arrays, on
  every rank.

The grid's hypothesis axis is [configuration | (roll/pitch, yaw, top
sample)], roll/pitch-major within a configuration; a rank's slice is a
contiguous roll/pitch block in EACH configuration, so the gather puts every
configuration's blocks back in rank order (not the ranks' whole rows side by
side, which would interleave the configurations).  The roll/pitch axis is
padded to a multiple of the group size with `rp_valid` masking; the padded
rows are invalid hypotheses at the end of each configuration's block, which
fusion and ranking ignore, so the result is `detect_cuboid_single`'s.

`detect_cuboids_dp` is the other split: the boxes of a frame over the ranks
(data parallel), each rank running `detect_cuboids` on its rows.
"""

from __future__ import annotations

import torch

from cube_slam_wu_tpu_torch.ops import proposal as prop
from cube_slam_wu_tpu_torch.parallel import multihost

# per-hypothesis fields of `hypothesis_grid`'s block, hypothesis axis last
_HYP_KEYS = ("cx", "cy", "vp1", "valid", "dist", "angle", "cfg_id",
             "pos_x", "pos_y", "pos_z", "len_h", "wid_h", "hei_h")


def _gather_hyp(x: torch.Tensor, nC: int, group) -> torch.Tensor:
    """(..., nC*Hl) per rank -> (..., nC*W*Hl): every configuration's blocks
    concatenated in rank order."""
    lead = tuple(x.shape[:-1])
    hl = x.shape[-1] // nC
    parts = multihost.allgather(x.reshape(lead + (nC, hl))[None], group)  # (W, ..., nC, Hl)
    parts = parts.movedim(0, -2)  # (..., nC, W, Hl)
    return parts.reshape(lead + (-1,))


def detect_cuboid_sharded(gray, K, T_wc, bbox, lines, line_mask, cfg: prop.ProposalConfig,
                          group, yaw_prior=None) -> prop.ProposalResult:
    """`detect_cuboid_single` with the roll/pitch hypothesis axis split over
    the ranks of `group`; every rank returns the same result.  Setup mirrors
    detect_cuboid_single (box_proposal_detail.cpp:65-205); see the module
    docstring for the design."""
    rank, world = multihost.rank_world(group)
    dev = gray.device
    st = prop._proposal_setup(gray, K, T_wc, bbox[None], lines, cfg)

    # pad the roll/pitch axis to a multiple of the group size; the padded
    # rows are masked out through rp_valid (exactly ignored by fusion/ranking)
    RP = st.roll_flat.shape[0]
    per = -(-RP // world)
    pad = per * world - RP
    roll_pad = torch.cat([st.roll_flat, st.roll_flat[-1:].expand(pad)])
    pitch_pad = torch.cat([st.pitch_flat, st.pitch_flat[-1:].expand(pad)])
    rp_valid = torch.arange(per * world, device=dev) < RP
    mine = slice(rank * per, (rank + 1) * per)

    hb, aux = prop.hypothesis_grid(
        gray, K, T_wc, st.box, st.lines, line_mask, cfg, st.euler_raw,
        roll_pad[mine], pitch_pad[mine], rp_valid[mine], st.yaws, st.top_xs, st.top_ok,
    )
    nC = aux["nC"]
    full = {k: _gather_hyp(hb[k], nC, group) for k in _HYP_KEYS}
    # cap saturation: every rank's counts side by side (`_fuse_and_rank` sums)
    full["cap_overflow"] = multihost.allgather(hb["cap_overflow"].T.contiguous(), group).T
    aux = dict(aux, **{k: multihost.allgather(aux[k], group) for k in ("yaw_f", "roll_f", "pitch_f")})
    res = prop._fuse_and_rank(full, aux, cfg, st.euler_raw, yaw_prior)
    return prop.ProposalResult(*(t[0] if isinstance(t, torch.Tensor) and t.ndim else t for t in res))


def detect_cuboids_dp(gray, K, T_wc, bboxes, bbox_mask, lines, line_mask,
                      cfg: prop.ProposalConfig, group) -> prop.ProposalResult:
    """`detect_cuboids` with the boxes split over the ranks of `group`: the
    batch is padded to a multiple of the group size (with masked copies of
    its last box), each rank runs its contiguous block of boxes
    (`multihost.local_rows`), and every field is gathered back in box
    order; every rank returns the whole batch's result."""
    _, world = multihost.rank_world(group)
    B = bboxes.shape[0]
    pad = -(-B // world) * world - B
    bboxes = torch.cat([bboxes, bboxes[-1:].expand(pad, 4)])
    bbox_mask = torch.cat([bbox_mask, torch.zeros(pad, dtype=torch.bool, device=bbox_mask.device)])
    res = prop.detect_cuboids(
        gray, K, T_wc, multihost.local_rows(bboxes, group), multihost.local_rows(bbox_mask, group),
        lines, line_mask, cfg,
    )
    return prop.ProposalResult(*(multihost.allgather(t, group)[:B] for t in res))
