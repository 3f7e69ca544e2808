"""Vanishing-point cuboid proposal engine as one batched hypothesis grid.

Batched re-design of the reference's per-detection proposal loop
(detect_3d_cuboid/src/box_proposal_detail.cpp:65-861 and the geometry/scoring
helpers in object_3d_util.cpp).  The reference iterates
(camera roll x pitch x object yaw x top-edge sample x configuration) with ~10
early-`continue` guard points; here the whole grid is materialised as a
fixed-shape tensor program: every hypothesis's closed-form corner chain is
computed unconditionally and the guards become a validity mask, so there is
no data-dependent control flow.

Layout: all per-hypothesis quantities are STRUCTURE-OF-ARRAYS — each scalar
(corner x, corner y, score, ...) is its own array with the hypothesis axis
last.  The detection boxes of a frame are a written-out leading batch axis B:
per-hypothesis arrays are (B, Hc), per-box scalars are (B, 1) columns that
broadcast against them, and quantities that depend on the camera only (the
vanishing points) stay (Hc,).

Pipeline per 2D detection:
  1. line filtering + parallel-rounds merge (ops.lines),
  2. Canny + exact EDT distance map on the expanded ROI (ops.image),
  3. vanishing points per (roll, pitch, yaw) sample,
  4. VP-supported image-edge angles (batched over the padded line set),
  5. corner chains + validity for both configurations,
  6. chamfer distance + VP-alignment angle scoring,
  7. best-2/3 set-intersection score fusion (fuse_normalize_scores_v2
     semantics via rank arithmetic instead of partial sorts),
  8. 2D->3D lifting of every hypothesis through the ground/wall planes,
  9. skew-penalised final ranking -> best cuboid.

The host's time splits into `utils.hostsync` stages: `proposals/grid` (the
sample grids and the hypothesis grid, steps 3-4 and what the stages below
leave), `proposals/merge` (step 1's merge, one flag read a round),
`proposals/canny` and `proposals/edt` (step 2, in ops.image),
`proposals/score` (steps 5-6 and 8) and `proposals/rank` (steps 7 and 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from cube_slam_wu_tpu_torch.core import camera as cam
from cube_slam_wu_tpu_torch.core import rotations as rotu
from cube_slam_wu_tpu_torch.ops import image as image_ops
from cube_slam_wu_tpu_torch.ops import lines as line_ops
from cube_slam_wu_tpu_torch.ops.topk import first_argmax, first_argmin, stable_top_k
from cube_slam_wu_tpu_torch.utils import hostsync


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Static knobs mirroring the `detect_3d_cuboid` member flags
    (detect_3d_cuboid.h:95-117) and the constants at
    box_proposal_detail.cpp:101-110."""

    max_lines: int = 128
    max_top_samples: int = 24
    n_yaw: int = 16  # linespace(-45deg, +45deg, 6deg) inclusive
    sample_cam_roll_pitch: bool = False
    n_roll_pitch: int = 5  # linespace(-6deg, +6deg, 3deg) when sampling
    consider_config_1: bool = True
    consider_config_2: bool = True
    shorted_edge_thre: float = 20.0
    vp12_edge_angle_thre_deg: float = 15.0
    vp3_edge_angle_thre_deg: float = 10.0
    weight_vp_angle: float = 0.8
    whether_normalize_two_errors: bool = True
    reweight_edge_distance: bool = True
    nominal_skew_ratio: float = 1.0
    max_cut_skew: float = 3.0
    weight_skew_error: float = 1.5
    canny_low: float = 80.0
    canny_high: float = 200.0
    pre_merge_dist_thre: float = 20.0
    pre_merge_angle_thre_deg: float = 5.0
    edge_length_threshold: float = 30.0
    yaw_prior_weight: float = 1.0  # score penalty per rad of mod-90 yaw drift
    average_top_k: int = 1  # >1: average the k best hypotheses (see below)
    sample_bbox_height: bool = False  # 3 bbox-height samples {0, r/2, r}
    # float32-stable winner selection: among hypotheses within `rank_margin`
    # of the best final score, deterministically pick the SMALLEST flat grid
    # index.  With margin >> f32 score noise (~1e-5), the f32 and f64 paths
    # select the same hypothesis except when a candidate sits exactly on the
    # margin boundary.  0.0 = plain argmin (reference semantics,
    # box_proposal_detail.cpp:824-838).
    rank_margin: float = 0.0
    # bilinear (True) vs floor-gather (False) sampling of the chamfer map in
    # the edge-distance score.  The reference floor-gathers
    # (box_edge_sum_dists casts to int, object_3d_util.cpp:640-653), which
    # quantises: a corner jitter of 1e-3 px crossing a pixel boundary jumps
    # the score by ~3e-3.  Bilinear is smooth and strictly more accurate;
    # the online pipeline enables it, parity tests keep the reference
    # behaviour.
    bilinear_dist: bool = False
    # Compact the chamfer-score gather to the VALID hypotheses only.  Score
    # fusion and ranking never read the edge-distance of an invalid
    # hypothesis (fuse_normalized_scores masks with +inf), so gathering the
    # ~99 dist-map samples per hypothesis only for hypotheses that survived
    # the corner-chain guards is exact.  The cap is static: per config block,
    # the cap best hypotheses — valid first, then by the already-computed
    # (gather-free) VP-alignment angle score — are gathered; if MORE than the
    # cap are valid, the overflow drops the highest-angle-error ones (the
    # least likely winners) as invalid.  0 disables.  Config 2's tighter
    # corner-chain guards (fewer corners inside the box) justify its smaller
    # cap.
    dist_gather_cap: int = 4608
    dist_gather_cap2: int = 1536
    # Compact the ROI's lines to this many slots (valid-first, stable order)
    # before merge_break_lines (O(slots^2) per round).  Exact while
    # n_inside <= cap (stable compaction preserves the relative slot order
    # the merge's lexicographic pairing depends on); a binding cap is counted
    # in ProposalResult.cap_overflow and the online step's exact fallback (which
    # zeroes every cap) recomputes without it.  0 disables.
    merge_cap: int = 128
    # Return the N best-ranked proposals per box instead of only the winner
    # (the reference's ObjectSet semantics: max_cuboid_num ranked cuboids,
    # detect_3d_cuboid.h:95-96, partial-sort box_proposal_detail.cpp:801-838;
    # its drivers set 1).  >1 gives every ProposalResult field an axis of size
    # max_cuboid_num after the box axis, ranked best-first (lower grid index
    # first on equal scores), with per-rank `valid` (False when fewer than N
    # hypotheses survive).  Ranking is the plain skew-penalised final score;
    # rank_margin and average_top_k apply only to the single-winner path.
    max_cuboid_num: int = 1

    @property
    def rp_count(self) -> int:
        return self.n_roll_pitch if self.sample_cam_roll_pitch else 1


def _check_config(cfg: ProposalConfig) -> None:
    """What the SLAM drivers can take: one proposal per box."""
    if cfg.max_cuboid_num != 1:
        raise ValueError("the SLAM drivers take one proposal per box: max_cuboid_num must be 1")


class ProposalResult(NamedTuple):
    """Best cuboid proposal per 2D detection (fields mirror the reference
    `cuboid` struct, detect_3d_cuboid.h:20-42).  Shapes are given for one
    box; `detect_cuboids` adds a leading box axis."""

    valid: torch.Tensor  # () bool
    pos: torch.Tensor  # (3,)
    rotY: torch.Tensor  # ()
    scale: torch.Tensor  # (3,) half extents
    box_config_type: torch.Tensor  # (2,) [config_id, vp1_position]
    corners_2d: torch.Tensor  # (2, 8) reordered to the universal layout
    corners_3d_world: torch.Tensor  # (3, 8)
    edge_distance_error: torch.Tensor
    edge_angle_error: torch.Tensor
    normalized_error: torch.Tensor
    skew_ratio: torch.Tensor
    camera_roll_delta: torch.Tensor
    camera_pitch_delta: torch.Tensor
    # () int32: number of VALID hypotheses (or ROI lines) shed by a binding
    # cap.  0 means the compacted computation was exact; >0 means ranking may
    # differ from the full one and the caller should fall back.
    cap_overflow: torch.Tensor = ()


# ---------------------------------------------------------------------------
# SoA geometry helpers: points are (x, y) pairs of (..., H) arrays
# ---------------------------------------------------------------------------


def _dir_to(a, b, w, px, py):
    """Direction (up to positive scale w) of the line from the HOMOGENEOUS
    vanishing point (a : b : w) to image point p: w*(p - vp).

    Forming vp = (a/w, b/w) explicitly and then p - vp is catastrophically
    ill-conditioned in float32 when the VP is near infinity; the undivided
    form keeps the relative error at f32 eps."""
    return w * px - a, w * py - b


def _hit_vertical(a, b, w, px, py, x0, y_lo, y_hi):
    """Ray vp->(px,py) hitting the vertical segment x=x0, y in [y_lo, y_hi]
    (seg_hit_boundary, object_3d_util.cpp:309-353), with the VP given
    homogeneously.  lam >= 0 of the reference's (x0-vx)/(px-vx) multiplies
    through by w^2 into (w*x0 - a) * Dx >= 0."""
    Dx, Dy = _dir_to(a, b, w, px, py)
    y = py + (x0 - px) * Dy / Dx
    ok = ((w * x0 - a) * Dx >= 0) & (y_lo <= y) & (y <= y_hi)
    return x0.expand_as(y), y, ok


def _hit_horizontal(a, b, w, px, py, y0, x_lo, x_hi):
    Dx, Dy = _dir_to(a, b, w, px, py)
    x = px + (y0 - py) * Dx / Dy
    ok = ((w * y0 - b) * Dy >= 0) & (x_lo <= x) & (x <= x_hi)
    return x, y0.expand_as(x), ok


def _intersect_dirs(px, py, Dx, Dy, qx, qy, Ex, Ey):
    """Intersection of line through p with direction D and line through q
    with direction E (scale/sign of the directions is irrelevant).
    Replaces the reference's point-pair form (lineSegmentIntersect,
    object_3d_util.cpp:357-382) so VP-anchored lines never materialise the
    near-infinite VP coordinate."""
    denom = Dx * Ey - Dy * Ex
    t = ((qx - px) * Ey - (qy - py) * Ex) / denom
    return px + t * Dx, py + t * Dy


def _inside(x, y, tl_x, tl_y, br_x, br_y):
    return (tl_x <= x) & (x <= br_x) & (tl_y <= y) & (y <= br_y)


def _dist_ge(ax, ay, bx, by, thr):
    return (ax - bx) ** 2 + (ay - by) ** 2 >= thr * thr


def vanishing_points_h(KinvR: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """HOMOGENEOUS VPs of the object x/y/z axes at the sampled yaw:
    (..., 3 vps, 3) as (a, b, w) with vp = (a/w, b/w)
    (getVanishingPoints, object_3d_util.cpp:928-937, without the division —
    see _dir_to for why the division is numerically poisonous in f32)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros_like(cy)
    ones = torch.ones_like(cy)
    dirs = torch.stack(
        [
            torch.stack([cy, sy, zeros], dim=-1),
            torch.stack([-sy, cy, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return torch.einsum("...ij,...vj->...vi", KinvR, dirs)


def vanishing_points(KinvR: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Euclidean VPs (..., 3 vps, 2) — the reference's exact output form."""
    proj = vanishing_points_h(KinvR, yaw)
    return proj[..., :2] / proj[..., 2:3]


def vp_support_edge_angles(
    vps: torch.Tensor,
    mids: torch.Tensor,
    angles: torch.Tensor,
    mask: torch.Tensor,
    thr12_deg: float,
    thr3_deg: float,
):
    """For each VP find the two angular-boundary supporting image edges
    (VP_support_edge_infos, object_3d_util.cpp:548-619).

    vps: HOMOGENEOUS (*S, 3, 3) from vanishing_points_h; mids (*Bt, L, 2);
    angles (*Bt, L); mask (*Bt, L), with *Bt an optional box axis.  Returns
    (ang_a, ang_b, has): each (*Bt, *S, 3).
    """
    batch = tuple(angles.shape[:-1])
    L = angles.shape[-1]
    nb, ns = len(batch), vps.ndim - 2
    # line quantities -> (*Bt, 1.., 1, L); vp quantities -> (1.., *S, 3, 1)
    lshape = batch + (1,) * (ns + 1) + (L,)
    mx = mids[..., 0].reshape(lshape)
    my = mids[..., 1].reshape(lshape)
    ang_l = angles.reshape(lshape)
    mask_l = mask.reshape(lshape)
    vshape = (1,) * nb + tuple(vps.shape[:-1]) + (1,)
    a = vps[..., 0].reshape(vshape)
    b = vps[..., 1].reshape(vshape)
    w = vps[..., 2].reshape(vshape)
    # sign(w) keeps the orientation of (mid - vp); w == 0 (VP exactly at
    # infinity) keeps the raw direction, matching the limit
    sw = torch.where(w < 0, -1.0, 1.0).to(mids.dtype)
    raw = torch.atan2(sw * (w * my - b), sw * (w * mx - a))  # (*Bt, *S, 3, L)
    norm = rotu.normalize_to_pi_half(raw)
    diff = rotu.angle_dist_pi(ang_l, norm)
    thr = torch.deg2rad(
        torch.tensor([thr12_deg, thr12_deg, thr3_deg], dtype=diff.dtype, device=diff.device)
    )
    inlier = mask_l & (diff < thr[:, None])  # (*Bt, *S, 3, L)
    has = torch.any(inlier, dim=-1)

    first = first_argmax(inlier.to(torch.int8))  # first inlier index per vp
    base = torch.gather(raw, -1, first[..., None])[..., 0]
    # smooth_jump_angles (object_3d_util.cpp:278-302)
    shifted = raw
    shifted = torch.where(raw - base[..., None] < -math.pi, raw + 2 * math.pi, shifted)
    shifted = torch.where(raw - base[..., None] > math.pi, raw - 2 * math.pi, shifted)

    inf = float("inf")
    id_max = first_argmax(torch.where(inlier, shifted, -inf))
    id_min = first_argmin(torch.where(inlier, shifted, inf))
    ang_full = ang_l.expand(raw.shape[:-2] + (1, L))[..., 0, :]  # (*Bt, *S, L)
    ang_a = torch.gather(ang_full, -1, id_max)
    ang_b = torch.gather(ang_full, -1, id_min)
    return ang_a, ang_b, has


# ---------------------------------------------------------------------------
# corner chain (SoA over one hypothesis block)
# ---------------------------------------------------------------------------


class _BoxGeom(NamedTuple):
    """Scalars describing each detection box (all float, (B, 1) columns)."""

    left: torch.Tensor
    top: torch.Tensor
    right: torch.Tensor
    down_expan: torch.Tensor  # bottom incl. height expansion
    exp_left: torch.Tensor  # expanded (distmap) ROI
    exp_top: torch.Tensor
    exp_right: torch.Tensor
    exp_down: torch.Tensor
    diag: torch.Tensor


def _corner_chain(vp, c1x, c1y, g: _BoxGeom, config_id: int, thr: float):
    """Closed-form corners 2..8 for one configuration
    (box_proposal_detail.cpp:407-630).  `vp` is a dict of nine (H,) arrays —
    the HOMOGENEOUS VP components a{1,2,3}, b{1,2,3}, w{1,2,3} — so every
    VP-anchored line is handled by direction (see _dir_to), never by the
    near-infinite Euclidean VP coordinate.
    Returns (cx (B, 8, H), cy (B, 8, H), vp1_pos (B, H), valid (B, H))."""
    v1 = (vp["a1"], vp["b1"], vp["w1"])
    v2 = (vp["a2"], vp["b2"], vp["w2"])
    v3 = (vp["a3"], vp["b3"], vp["w3"])

    rx_r, ry_r, ok_r = _hit_vertical(*v1, c1x, c1y, g.right, g.top, g.down_expan)
    rx_l, ry_l, ok_l = _hit_vertical(*v1, c1x, c1y, g.left, g.top, g.down_expan)
    vp1_pos = torch.where(ok_r, 1, torch.where(ok_l, 2, 0))
    c2x = torch.where(ok_r, rx_r, rx_l)
    c2y = torch.where(ok_r, ry_r, ry_l)
    valid = (vp1_pos > 0) & _dist_ge(c1x, c1y, c2x, c2y, thr)

    x_opp = torch.where(vp1_pos == 1, g.left, g.right)
    if config_id == 1:
        c4x, c4y, ok4 = _hit_vertical(*v2, c1x, c1y, x_opp, g.top, g.down_expan)
        valid = valid & ok4 & _dist_ge(c1x, c1y, c4x, c4y, thr)
        c3x, c3y = _intersect_dirs(
            c2x, c2y, *_dir_to(*v2, c2x, c2y), c4x, c4y, *_dir_to(*v1, c4x, c4y)
        )
        valid = valid & _inside(c3x, c3y, g.left, g.top, g.right, g.down_expan)
        valid = valid & _dist_ge(c3x, c3y, c4x, c4y, thr) & _dist_ge(c3x, c3y, c2x, c2y, thr)
    else:
        c3x, c3y, ok3 = _hit_vertical(*v2, c2x, c2y, x_opp, g.top, g.down_expan)
        valid = valid & ok3 & _dist_ge(c2x, c2y, c3x, c3y, thr)
        c4x, c4y = _intersect_dirs(
            c3x, c3y, *_dir_to(*v1, c3x, c3y), c1x, c1y, *_dir_to(*v2, c1x, c1y)
        )
        valid = valid & _inside(c4x, c4y, g.left, g.exp_top, g.right, g.exp_down)
        valid = valid & _dist_ge(c3x, c3y, c4x, c4y, thr) & _dist_ge(c4x, c4y, c1x, c1y, thr)

    c5x, c5y, ok5 = _hit_horizontal(*v3, c3x, c3y, g.down_expan, g.left, g.right)
    valid = valid & ok5 & _dist_ge(c3x, c3y, c5x, c5y, thr)
    c6x, c6y = _intersect_dirs(
        c5x, c5y, *_dir_to(*v2, c5x, c5y), c2x, c2y, *_dir_to(*v3, c2x, c2y)
    )
    valid = valid & _inside(c6x, c6y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid = valid & _dist_ge(c6x, c6y, c2x, c2y, thr) & _dist_ge(c6x, c6y, c5x, c5y, thr)
    c7x, c7y = _intersect_dirs(
        c6x, c6y, *_dir_to(*v1, c6x, c6y), c1x, c1y, *_dir_to(*v3, c1x, c1y)
    )
    valid = valid & _inside(c7x, c7y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid = valid & _dist_ge(c7x, c7y, c1x, c1y, thr) & _dist_ge(c7x, c7y, c6x, c6y, thr)
    c8x, c8y = _intersect_dirs(
        c5x, c5y, *_dir_to(*v1, c5x, c5y), c7x, c7y, *_dir_to(*v2, c7x, c7y)
    )
    valid = valid & _inside(c8x, c8y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid = valid & (
        _dist_ge(c8x, c8y, c4x, c4y, thr)
        & _dist_ge(c8x, c8y, c5x, c5y, thr)
        & _dist_ge(c8x, c8y, c7x, c7y, thr)
    )

    cx = torch.stack([c1x, c2x, c3x, c4x, c5x, c6x, c7x, c8x], dim=-2)  # (B, 8, H)
    cy = torch.stack([c1y, c2y, c3y, c4y, c5y, c6y, c7y, c8y], dim=-2)
    # NaN hygiene: degenerate intersections produce NaN/inf coords; those
    # hypotheses always fail an _inside check, but scrub values so downstream
    # gathers stay in-range.
    cx = torch.where(torch.isfinite(cx), cx, 0.0)
    cy = torch.where(torch.isfinite(cy), cy, 0.0)
    return cx, cy, vp1_pos, valid


# visible-edge tables (box_proposal_detail.cpp:641-668), 0-based, padded to 9
_EDGES_CFG1 = ((0, 1), (1, 2), (2, 3), (3, 0), (1, 5), (2, 4), (3, 7), (4, 7), (4, 5))
_W_CFG1 = (1.0,) * 9
_EDGES_CFG2 = ((0, 1), (1, 2), (2, 3), (3, 0), (1, 5), (2, 4), (4, 5), (0, 0), (0, 0))
_W_CFG2 = (1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 2.0, 0.0, 0.0)

# VP alignment edge tables (box_proposal_detail.cpp:651,665), 0-based:
# per VP, two edges, each (corner_a, corner_b)
_VP_EDGES_CFG1 = (((0, 1), (7, 4)), ((3, 0), (4, 5)), ((3, 7), (1, 5)))
_VP_EDGES_CFG2 = (((0, 1), (2, 3)), ((3, 0), (4, 5)), ((2, 4), (1, 5)))


def _edge_dist_score(
    dist_map, cx, cy, config_id: int, reweight: bool, bilinear: bool = False
):
    """Chamfer distance of 11 samples per visible edge
    (box_edge_sum_dists, object_3d_util.cpp:622-667).  dist_map (B, h, w);
    cx/cy: (B, 8, H).  Returns (B, H).

    `bilinear` swaps the reference's int-cast lookup for bilinear
    interpolation (see ProposalConfig.bilinear_dist).  The bilinear taps read
    the distance map ROUNDED THROUGH float16, the right neighbour replicated
    at the last column: the rounding is deterministic and identical across
    float32/float64 pipelines, so rank_margin still holds."""
    edges = _EDGES_CFG1 if config_id == 1 else _EDGES_CFG2
    weights = _W_CFG1 if (config_id == 1 or not reweight) else _W_CFG2
    if config_id == 2 and not reweight:
        weights = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    if config_id == 2:
        # config 2 has 7 visible edges; slots 8-9 are (0,0) padding at zero
        # weight — dropping them statically removes 2/9 of the gathers
        edges = edges[:7]
        weights = weights[:7]
    B = dist_map.shape[0]
    h, wimg = dist_map.shape[-2:]
    dev = cx.device
    frac = torch.tensor(np.linspace(0.0, 1.0, 11), dtype=cx.dtype, device=dev)
    frac = frac[None, None, :, None]
    ia = [e[0] for e in edges]
    ib = [e[1] for e in edges]
    w = torch.tensor(weights, dtype=cx.dtype, device=dev)
    ax, ay = cx[:, ia, None, :], cy[:, ia, None, :]  # (B, E, 1, H)
    bx, by = cx[:, ib, None, :], cy[:, ib, None, :]
    # sample_pt = frac*a + (1-frac)*b  (reference orders from corner2 to 1)
    px = frac * ax + (1.0 - frac) * bx  # (B, E, 11, H)
    py = frac * ay + (1.0 - frac) * by

    def take(flat, idx):
        return torch.gather(flat, 1, idx.reshape(B, -1)).reshape(idx.shape)

    if bilinear:
        x0 = torch.clamp(torch.floor(px), 0.0, wimg - 1.0)
        y0 = torch.clamp(torch.floor(py), 0.0, h - 1.0)
        fx = torch.clamp(px - x0, 0.0, 1.0)
        fy = torch.clamp(py - y0, 0.0, 1.0)
        xi = x0.to(torch.int64)
        yi = y0.to(torch.int64)
        xi1 = torch.clamp(xi + 1, max=wimg - 1)
        yi1 = torch.clamp(yi + 1, max=h - 1)
        row = yi * wimg
        row1 = yi1 * wimg
        d16 = dist_map.to(torch.float16).to(cx.dtype).reshape(B, -1)
        d00, d01 = take(d16, row + xi), take(d16, row + xi1)
        d10, d11 = take(d16, row1 + xi), take(d16, row1 + xi1)
        d = (d00 * (1 - fx) + d01 * fx) * (1 - fy) + (
            d10 * (1 - fx) + d11 * fx
        ) * fy
    else:
        xi = torch.clamp(torch.floor(px).to(torch.int64), 0, wimg - 1)
        yi = torch.clamp(torch.floor(py).to(torch.int64), 0, h - 1)
        d = take(dist_map.reshape(B, -1), yi * wimg + xi)  # (B, E, 11, H)
    return (w[None, :, None, None] * d).sum(dim=(1, 2))


def _edge_angle_score(ang_a, ang_b, has, cx, cy, config_id: int):
    """VP alignment angle error (box_edge_alignment_angle_error,
    object_3d_util.cpp:670-723).  ang_a/ang_b/has: lists of (B, H) per vp;
    cx/cy (B, 8, H)."""
    table = _VP_EDGES_CFG1 if config_id == 1 else _VP_EDGES_CFG2
    not_found = 30.0 / 180.0 * math.pi * 2.0
    total = torch.zeros_like(cx[:, 0, :])
    for vp_id in range(3):
        per_vp = torch.zeros_like(total)
        for (a_id, b_id) in table[vp_id]:
            edge_ang = rotu.normalize_to_pi_half(
                torch.atan2(cy[:, b_id] - cy[:, a_id], cx[:, b_id] - cx[:, a_id])
            )
            d = torch.minimum(
                rotu.angle_dist_pi(edge_ang, ang_a[vp_id]),
                rotu.angle_dist_pi(edge_ang, ang_b[vp_id]),
            )
            per_vp = per_vp + d
        total = total + torch.where(has[vp_id], per_vp, not_found)
    return total


# ---------------------------------------------------------------------------
# score fusion (fuse_normalize_scores_v2, object_3d_util.cpp:726-837)
# ---------------------------------------------------------------------------


def _rank(values, valid):
    """Ascending rank among valid entries along the last axis (ties broken by
    index, matching a stable partial sort); invalid entries rank last."""
    n = values.shape[-1]
    big = torch.where(valid, values, float("inf"))
    order = torch.sort(big, dim=-1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(
        -1, order, torch.arange(n, device=values.device).expand_as(order)
    )
    return ranks


def fuse_normalized_scores(dist_err, angle_err, valid, weight_vp_angle, normalize):
    """Best-2/3 intersection + min-max fusion over the last axis; returns
    (scores, kept_mask) with +inf outside the kept set."""
    dtype = dist_err.dtype
    inf = float("inf")
    n = torch.sum(valid, dim=-1, keepdim=True)
    d = torch.where(valid, dist_err, inf)
    a = torch.where(valid, angle_err, inf)

    breaking = torch.round(n.to(dtype) / 3.0 * 2.0).to(torch.int64)
    keep_count = torch.clamp(breaking - 1, min=1)
    rd = _rank(d, valid)
    ra = _rank(a, valid)
    keep_d = rd < keep_count
    keep_a = ra < keep_count

    a_sorted = torch.sort(a, dim=-1).values
    idx_hi = torch.clamp(breaking - 1, 0, a.shape[-1] - 1)
    idx_lo = torch.clamp(breaking - 2, 0, a.shape[-1] - 1)
    use_angle = torch.gather(a_sorted, -1, idx_hi) > torch.gather(a_sorted, -1, idx_lo)

    kept_big = keep_d & torch.where(use_angle, keep_a, True)
    kept = torch.where(n > 4, kept_big, valid)

    def masked_minmax(x):
        lo = torch.amin(torch.where(kept, x, inf), dim=-1, keepdim=True)
        hi = torch.amax(torch.where(kept, x, -inf), dim=-1, keepdim=True)
        return lo, hi

    d_lo, d_hi = masked_minmax(d)
    a_lo, a_hi = masked_minmax(a)
    n_kept = torch.sum(kept, dim=-1, keepdim=True)

    d_span = torch.where(d_hi > d_lo, d_hi - d_lo, 1.0)
    a_span = torch.where(a_hi > a_lo, a_hi - a_lo, 1.0)
    d_n = (d - d_lo) / d_span
    a_n = torch.where(a_hi > a_lo, (a - a_lo) / a_span, a)
    w = weight_vp_angle
    comb_norm = (d_n + w * a_n) / (1.0 + w)
    comb_raw = (d + w * a) / (1.0 + w)
    do_norm = (n_kept > 1) & bool(normalize)
    scores = torch.where(do_norm, comb_norm, comb_raw)
    return torch.where(kept, scores, inf), kept


# ---------------------------------------------------------------------------
# 2D -> 3D lifting, SoA (change_2d_corner_to_3d_object,
# object_3d_util.cpp:941-1011)
# ---------------------------------------------------------------------------


def _lift_soa(cx, cy, Kinv, Twc, plane):
    """Lift SoA corners to 3D.  cx/cy (B, 8, H); the nine Kinv entries and
    the twelve T_wc entries come as dicts of (H,) arrays.  Returns
    (pos_x, pos_y, pos_z, len_h, wid_h, hei_h), all (B, H)."""

    def unproject_to_plane(px, py, p0, p1, p2, p3):
        """Pixel -> world point on the camera-frame plane (p0..p3)."""
        # ray = Kinv @ [px, py, 1]
        rx = Kinv["00"] * px + Kinv["01"] * py + Kinv["02"]
        ry = Kinv["10"] * px + Kinv["11"] * py + Kinv["12"]
        rz = Kinv["20"] * px + Kinv["21"] * py + Kinv["22"]
        denom = p0 * rx + p1 * ry + p2 * rz
        frac = -p3 / denom
        sx, sy, sz = frac * rx, frac * ry, frac * rz  # sensor frame
        wx = Twc["00"] * sx + Twc["01"] * sy + Twc["02"] * sz + Twc["03"]
        wy = Twc["10"] * sx + Twc["11"] * sy + Twc["12"] * sz + Twc["13"]
        wz = Twc["20"] * sx + Twc["21"] * sy + Twc["22"] * sz + Twc["23"]
        return wx, wy, wz

    g0, g1, g2, g3 = plane  # ground plane in sensor frame, (H,) each
    # bottom corners 5..8 are rows 4..7
    bx = [None] * 4
    by = [None] * 4
    bz = [None] * 4
    for k in range(4):
        bx[k], by[k], bz[k] = unproject_to_plane(
            cx[:, 4 + k], cy[:, 4 + k], g0, g1, g2, g3
        )

    length_half = 0.5 * torch.sqrt(
        (bx[0] - bx[3]) ** 2 + (by[0] - by[3]) ** 2 + (bz[0] - bz[3]) ** 2
    )
    width_half = 0.5 * torch.sqrt(
        (bx[0] - bx[1]) ** 2 + (by[0] - by[1]) ** 2 + (bz[0] - bz[1]) ** 2
    )

    # wall plane through ground corners 5, 6 (world frame), normal horizontal
    ex = bx[0] - bx[1]
    ey = by[0] - by[1]
    # n = e x (0,0,1) = (ey, -ex, 0)
    nn = torch.sqrt(ey * ey + ex * ex)
    nx = ey / nn
    ny = -ex / nn
    dist = -(nx * bx[0] + ny * by[0])
    sgn = torch.where(dist < 0, -1.0, 1.0)
    nx, ny, dist = sgn * nx, sgn * ny, sgn * dist
    # transform wall plane to sensor frame: p_s = T_wc^T p_w (nz = 0)
    w0 = Twc["00"] * nx + Twc["10"] * ny
    w1 = Twc["01"] * nx + Twc["11"] * ny
    w2 = Twc["02"] * nx + Twc["12"] * ny
    w3 = Twc["03"] * nx + Twc["13"] * ny + dist

    _, _, tz = unproject_to_plane(cx[:, 1], cy[:, 1], w0, w1, w2, w3)  # corner 2
    height_half = 0.5 * tz

    pos_x = 0.25 * (bx[0] + bx[1] + bx[2] + bx[3])
    pos_y = 0.25 * (by[0] + by[1] + by[2] + by[3])
    return pos_x, pos_y, height_half, length_half, width_half, height_half


# corner reorder to the universal cuboid layout
# (change_2d_corner_to_3d_object, object_3d_util.cpp:995-1007), 0-based
_REORDER_VP_LEFT = (5, 4, 7, 6, 1, 2, 3, 0)
_REORDER_VP_RIGHT = (4, 5, 6, 7, 2, 1, 0, 3)


def _similarity_corners_3d(pos, rotY, scale):
    """compute3D_BoxCorner via the yaw-only similarity transform
    (object_3d_util.cpp:15-73): (..., 3, 8)."""
    c, s = torch.cos(rotY), torch.sin(rotY)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    R = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1).reshape(
        tuple(rotY.shape) + (3, 3)
    )
    body = torch.tensor(
        [
            [1.0, 1, -1, -1, 1, 1, -1, -1],
            [1.0, -1, -1, 1, 1, -1, -1, 1],
            [-1.0, -1, -1, -1, 1, 1, 1, 1],
        ],
        dtype=pos.dtype,
        device=pos.device,
    )
    return R @ (scale[..., :, None] * body) + pos[..., :, None]


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def _sample_offsets(lo, hi, step, dtype, device="cpu"):
    """Static-count linespace offsets: lo + k*step while <= hi (+eps), mirroring
    the reference's accumulating `linespace` (matrix_utils.cpp:368-380)."""
    out = []
    k = 0
    while True:
        v = lo + k * step
        if v > hi + 1e-9:
            break
        out.append(v)
        k += 1
        if k > 1000:
            break
    return torch.tensor(out, dtype=dtype, device=device)


@hostsync.stage("proposals/grid")
def hypothesis_grid(
    gray: torch.Tensor,
    K: torch.Tensor,
    T_wc: torch.Tensor,
    box,
    lines: torch.Tensor,
    line_mask: torch.Tensor,
    cfg: ProposalConfig,
    euler_raw,
    roll_flat: torch.Tensor,
    pitch_flat: torch.Tensor,
    rp_valid: torch.Tensor,
    yaws: torch.Tensor,
    top_xs: torch.Tensor,
    top_ok: torch.Tensor,
):
    """Stage A of the proposal engine: the raw per-hypothesis grid for an
    EXPLICIT roll/pitch sample set (box_proposal_detail.cpp:200-713 —
    everything before score fusion), for all B boxes of a frame at once.

    `box` is the floored (left, top, w, h, right) as (B, 1) columns;
    `top_xs`/`top_ok` are (B, T); `rp_valid` masks padded roll/pitch rows.
    `lines` (L, 4) must already be left-right-aligned.

    With `cfg.sample_bbox_height` every box is run at S = 3 bottom
    expansions {0, round(r/2), r} (box_proposal_detail.cpp:160-172), each
    with its own ROI, merged lines, Canny mask and distance map; the B*S
    (box, sample) pairs are the rows of one batch, box-major, so all their
    distance maps come from one EDT kernel launch.  Returns (hblock, aux):
    hblock is a dict of (B*S, ..., nC*Hc) arrays, aux the (Hc,)
    yaw/roll/pitch broadcasts, the config count nC and the sample count S.
    """
    dtype = gray.dtype
    dev = gray.device
    img_h, img_w = gray.shape
    left, top, w, h, right = box
    B0 = left.shape[0]
    RP = roll_flat.shape[0]

    # bbox-height samples (box_proposal_detail.cpp:160-172) as extra rows
    if cfg.sample_bbox_height:
        rng = torch.clamp(torch.clamp(h - 90.0, max=20.0), min=20.0)
        rng = torch.minimum(rng, img_h - top - h - 1.0)
        down_expand = torch.cat([torch.zeros_like(rng), torch.round(rng / 2.0), rng], dim=-1)
        sample_valid = torch.cat(
            [torch.ones_like(rng, dtype=torch.bool), rng > 10.0,
             torch.ones_like(rng, dtype=torch.bool)], dim=-1,
        )
    else:
        down_expand = torch.zeros_like(h)
        sample_valid = torch.ones_like(h, dtype=torch.bool)
    S = down_expand.shape[-1]
    B = B0 * S
    left, top, w, h, right = (v.repeat_interleave(S, dim=0) for v in (left, top, w, h, right))
    top_xs = top_xs.repeat_interleave(S, dim=0)
    top_ok = top_ok.repeat_interleave(S, dim=0)
    down_expand = down_expand.reshape(B, 1)
    sample_valid = sample_valid.reshape(B, 1)

    # rebuild camera products per (roll, pitch): rotation replaced
    R_new = rotu.euler_zyx_to_rot(roll_flat, pitch_flat, euler_raw[2].expand(RP))
    T_new = T_wc.to(dtype).expand(RP, 4, 4).clone()
    T_new[:, :3, :3] = R_new
    cams = cam.make_camera_pose(K.to(dtype).expand(RP, 3, 3), T_new)
    ground_sensor = cam.ground_plane_sensor_frame(T_new)  # (RP, 4)

    Y = yaws.shape[0]
    T = cfg.max_top_samples

    # vanishing points depend only on (roll, pitch, yaw) — shared; kept
    # homogeneous throughout (f32 stability, see _dir_to)
    vps = vanishing_points_h(cams.KinvR[:, None, :, :], yaws[None, :])  # (RP, Y, 3, 3)

    Hc = RP * Y * T

    def bcast_ryt(x_ry):  # (..., RP, Y) -> (..., Hc)
        lead = tuple(x_ry.shape[:-2])
        return x_ry[..., None].expand(lead + (RP, Y, T)).reshape(lead + (Hc,))

    def bcast_t(x_t):  # (B, T) -> (B, Hc)
        return x_t[:, None, None, :].expand(B, RP, Y, T).reshape(B, Hc)

    def bcast_rp(x_rp):  # (RP,) -> (Hc,)
        return x_rp[:, None, None].expand(RP, Y, T).reshape(-1)

    vp = {
        f"{name}{v + 1}": bcast_ryt(vps[:, :, v, k])
        for v in range(3)
        for k, name in enumerate(("a", "b", "w"))
    }
    c1x = bcast_t(top_xs)
    c1y = top.expand(B, Hc)
    top_ok_f = bcast_t(top_ok)
    yaw_f = bcast_ryt(yaws[None, :].expand(RP, Y))

    Kinv = {
        f"{i}{j}": bcast_rp(cams.K_inv[:, i, j]) for i in range(3) for j in range(3)
    }
    Twc_soa = {
        f"{i}{j}": bcast_rp(T_new[:, i, j]) for i in range(3) for j in range(4)
    }
    plane = tuple(bcast_rp(ground_sensor[:, k]) for k in range(4))
    roll_f = bcast_rp(roll_flat)
    pitch_f = bcast_rp(pitch_flat)
    rp_valid_f = bcast_rp(rp_valid)

    config_ids = []
    if cfg.consider_config_1:
        config_ids.append(1)
    if cfg.consider_config_2:
        config_ids.append(2)
    nC = len(config_ids)

    # ---- per (box, height sample): ROI, lines, distance map, the full
    # hypothesis grid (box_proposal_detail.cpp:200-799) --------------------
    h_expan = h + down_expand
    down_expan = top + h_expan
    diag = torch.sqrt(w * w + h_expan * h_expan)

    # expanded ROI (box_proposal_detail.cpp:242-248)
    wid = torch.minimum(
        torch.clamp(torch.clamp(w - 100.0, max=20.0), min=10.0),
        torch.clamp(torch.clamp(h_expan - 100.0, max=20.0), min=10.0),
    )
    exp_left = torch.clamp(left - wid, min=0.0)
    exp_right = torch.clamp(right + wid, max=img_w - 1.0)
    exp_top = torch.clamp(top - wid, min=0.0)
    exp_down = torch.clamp(down_expan + wid, max=img_h - 1.0)
    geom = _BoxGeom(
        left, top, right, down_expan, exp_left, exp_top, exp_right, exp_down, diag
    )

    # lines inside this ROI, merged, length-filtered.  The merge runs in
    # f32 REGARDLESS of the pipeline dtype: its angle/gap/length
    # thresholds are discrete decisions, and a borderline merge flipping
    # between f32 and f64 changes the VP-support edge set — which shifts
    # EVERY hypothesis's angle score.  One fixed dtype => identical merged
    # lines => the remaining f32 score noise is ~1e-5 and rank_margin
    # absorbs it.
    inside = line_ops.inside_box_mask(
        lines[None],
        torch.cat([exp_left, exp_top], dim=-1),
        torch.cat([exp_right, exp_down], dim=-1),
    )  # (B, L)
    roi_mask = line_mask[None] & inside
    L_all = lines.shape[0]
    lines_b = lines[None].expand(B, L_all, 4)
    if 0 < cfg.merge_cap < L_all:
        # valid-first stable compaction: preserves the relative slot
        # order among inside-ROI lines, so the merge's lexicographic
        # mutual-first pairing is unchanged while its O(L^2)-per-round
        # work shrinks (ProposalConfig.merge_cap).
        sel = torch.sort((~roi_mask).to(torch.uint8), dim=-1, stable=True).indices
        sel = sel[:, : cfg.merge_cap]
        lines_m = torch.gather(lines_b, 1, sel[..., None].expand(B, cfg.merge_cap, 4))
        mask_m = torch.gather(roi_mask, 1, sel)
        merge_overflow = torch.clamp(
            torch.sum(roi_mask, dim=-1).to(torch.int32) - cfg.merge_cap, min=0
        )
    else:
        lines_m = lines_b
        mask_m = roi_mask
        merge_overflow = torch.zeros(B, dtype=torch.int32, device=dev)
    with hostsync.stage("proposals/merge"):
        m_lines32, m_mask = line_ops.merge_break_lines(
            lines_m.to(torch.float32),
            mask_m,
            cfg.pre_merge_dist_thre,
            cfg.pre_merge_angle_thre_deg,
            cfg.edge_length_threshold,
        )
    m_lines = m_lines32.to(dtype)
    angles = line_ops.line_angles(m_lines)
    mids = line_ops.line_midpoints(m_lines)

    dist_map = image_ops.roi_canny_distance_map(
        gray,
        exp_left[:, 0].to(torch.int64),
        exp_top[:, 0].to(torch.int64),
        exp_right[:, 0].to(torch.int64),
        exp_down[:, 0].to(torch.int64),
        low=cfg.canny_low,
        high=cfg.canny_high,
    ).to(dtype)  # (B, h, w)

    ang_a_g, ang_b_g, has_g = vp_support_edge_angles(
        vps, mids, angles, m_mask,
        cfg.vp12_edge_angle_thre_deg, cfg.vp3_edge_angle_thre_deg,
    )  # (B, RP, Y, 3)
    ang_a = [bcast_ryt(ang_a_g[..., k]) for k in range(3)]
    ang_b = [bcast_ryt(ang_b_g[..., k]) for k in range(3)]
    has = [bcast_ryt(has_g[..., k]) for k in range(3)]

    blocks = []
    with hostsync.stage("proposals/score"):
        for config_id in config_ids:
            cx, cy, vp1_pos, valid = _corner_chain(
                vp, c1x, c1y, geom, config_id, cfg.shorted_edge_thre
            )
            valid = valid & top_ok_f & sample_valid & rp_valid_f
            angle = _edge_angle_score(ang_a, ang_b, has, cx, cy, config_id)
            px, py, pz, lh, wh, hh = _lift_soa(cx, cy, Kinv, Twc_soa, plane)
            cap = cfg.dist_gather_cap if config_id == 1 else cfg.dist_gather_cap2
            first_block = not blocks
            if 0 < cap < Hc:
                # gather the chamfer samples only for VALID hypotheses (exact
                # while n_valid <= cap: fusion/ranking mask invalid dists with
                # +inf; see ProposalConfig.dist_gather_cap).  Sort key: invalid
                # last, then ascending angle error, so a binding cap sheds the
                # least-promising hypotheses first.
                Kc = cap
                amax = torch.amax(torch.abs(angle), dim=-1, keepdim=True) + 1.0
                order = torch.sort(
                    torch.where(valid, angle, amax), dim=-1, stable=True
                ).indices[:, :Kc]
                # saturation accounting: a binding cap silently invalidates the
                # overflow, so count it.
                overflow = torch.clamp(
                    torch.sum(valid, dim=-1).to(torch.int32) - Kc, min=0
                )
                order8 = order[:, None, :].expand(B, 8, Kc)
                distc = _edge_dist_score(
                    dist_map, torch.gather(cx, 2, order8), torch.gather(cy, 2, order8),
                    config_id, cfg.reweight_edge_distance, bilinear=cfg.bilinear_dist,
                )
                dist = torch.zeros((B, Hc), dtype=dist_map.dtype, device=dev)
                dist.scatter_(1, order, distc)
                gathered = torch.zeros((B, Hc), dtype=torch.bool, device=dev)
                gathered.scatter_(1, order, True)
                valid = valid & gathered
            else:
                overflow = torch.zeros(B, dtype=torch.int32, device=dev)
                dist = _edge_dist_score(
                    dist_map, cx, cy, config_id, cfg.reweight_edge_distance,
                    bilinear=cfg.bilinear_dist,
                )
            dist = dist / diag
            if first_block:
                # merge-cap saturation rides the same observable/fallback
                # channel as the gather caps (summed in _fuse_and_rank)
                overflow = overflow + merge_overflow
            blocks.append(
                dict(
                    cx=cx,
                    cy=cy,
                    vp1=vp1_pos,
                    valid=valid,
                    cap_overflow=overflow[:, None],
                    dist=dist,
                    angle=angle,
                    cfg_id=torch.full((B, Hc), config_id, dtype=torch.int32, device=dev),
                    pos_x=px,
                    pos_y=py,
                    pos_z=pz,
                    len_h=lh,
                    wid_h=wh,
                    hei_h=hh,
                )
            )

    out = {
        key: torch.cat([b[key] for b in blocks], dim=-1) for key in blocks[0]
    }
    out["dist_map"] = dist_map
    out["m_lines"] = m_lines
    out["m_mask"] = m_mask
    aux = dict(yaw_f=yaw_f, roll_f=roll_f, pitch_f=pitch_f, nC=nC, S=S)
    return out, aux


@hostsync.stage("proposals/rank")
def _fuse_and_rank(
    hblock,
    aux,
    cfg: ProposalConfig,
    euler_raw,
    yaw_prior=None,
    return_internals: bool = False,
    extras=None,
):
    """Stage B of the proposal engine: per-height-sample score fusion
    (fuse_normalize_scores_v2, object_3d_util.cpp:726-837) followed by the
    global skew-penalised ranking (box_proposal_detail.cpp:801-838), per box.

    `hblock` holds one row per (box, height sample) (see `hypothesis_grid`);
    fusion runs per row, then each box's samples are laid side by side on
    the hypothesis axis, sample-major, as the JAX package concatenates them.
    `yaw_prior` (scalar or (B,)) adds the mod-90-degree yaw penalty.
    """
    b = hblock
    nC, S = aux["nC"], aux["S"]
    B = b["valid"].shape[0] // S
    # score fusion runs PER height sample (box_proposal_detail.cpp:715)
    scores, kept = fuse_normalized_scores(
        b["dist"], b["angle"], b["valid"],
        cfg.weight_vp_angle, cfg.whether_normalize_two_errors,
    )

    def cat(x):  # (B*S, ..., X) -> (B, ..., S*X)
        lead = tuple(x.shape[1:-1])
        x = x.reshape((B, S) + lead + (x.shape[-1],)).movedim(1, -2)
        return x.reshape((B,) + lead + (S * x.shape[-1],))

    # cap saturation, summed over config blocks and height samples
    cap_overflow = torch.sum(b["cap_overflow"].reshape(B, -1), dim=-1).to(torch.int32)
    cx_f, cy_f = cat(b["cx"]), cat(b["cy"])  # (B, 8, H)
    vp1_f, valid_f = cat(b["vp1"]), cat(b["valid"])
    dist_f, angle_f, cfgid_f = cat(b["dist"]), cat(b["angle"]), cat(b["cfg_id"])
    pos_x, pos_y, pos_z = cat(b["pos_x"]), cat(b["pos_y"]), cat(b["pos_z"])
    len_h, wid_h, hei_h = cat(b["len_h"]), cat(b["wid_h"]), cat(b["hei_h"])
    scores, kept = cat(scores), cat(kept)
    yaw_grid = torch.cat([aux["yaw_f"]] * (nC * S))
    roll_grid = torch.cat([aux["roll_f"]] * (nC * S))
    pitch_grid = torch.cat([aux["pitch_f"]] * (nC * S))
    dtype = scores.dtype
    dev = scores.device
    inf = float("inf")

    scale_ok = (
        (len_h >= 0)
        & (wid_h >= 0)
        & (hei_h >= 0)
        & torch.isfinite(len_h)
        & torch.isfinite(wid_h)
        & torch.isfinite(hei_h)
    )

    # ---- final skew-penalised ranking (box_proposal_detail.cpp:801-838) ----
    skew = torch.maximum(len_h, wid_h) / torch.minimum(len_h, wid_h)
    skew_err = cfg.weight_skew_error * torch.clamp(skew - cfg.nominal_skew_ratio, min=0.0)
    skew_err = torch.where(skew > cfg.max_cut_skew, 100.0, skew_err)
    # NB: the weight really is applied twice — the reference multiplies
    # weight_skew_error at box_proposal_detail.cpp:813 AND again at :820
    # (its own comment flags it).  Kept for winner-level parity.
    final = scores + cfg.weight_skew_error * skew_err
    if yaw_prior is not None:
        # temporal smoothness prior on the object yaw (the reference leaves
        # this as a TODO, box_proposal_detail.cpp:178).  Distance is modulo
        # 90 deg (min_log_error resolves the front face downstream).
        prior = torch.as_tensor(yaw_prior, dtype=dtype, device=dev).reshape(-1, 1)
        dy = torch.abs(yaw_grid - prior)
        dy = torch.remainder(dy + math.pi / 4, math.pi / 2) - math.pi / 4
        final = final + cfg.yaw_prior_weight * torch.abs(dy)
    final = torch.where(kept & scale_ok & torch.isfinite(scores), final, inf)
    yaw_bh = yaw_grid.expand(B, -1)  # per box: average_top_k writes into it

    def mk_result(idx):
        """ProposalResult for the hypotheses at flat grid indices `idx`
        ((B,) or (B, N)), read from the (possibly winner-averaged) fields."""
        shape = tuple(idx.shape)
        flat = idx.reshape(B, -1)

        def at(a):  # (B, H) -> idx.shape
            return torch.gather(a, 1, flat).reshape(shape)

        b_vp1 = at(vp1_f)
        reorder = torch.where(
            (b_vp1 == 1)[..., None],
            torch.tensor(_REORDER_VP_LEFT, device=dev),
            torch.tensor(_REORDER_VP_RIGHT, device=dev),
        )  # idx.shape + (8,)
        idx8 = flat[:, None, :].expand(B, 8, flat.shape[1])

        def corners(c):  # (B, 8, H) -> idx.shape + (8,), reordered
            c8 = torch.gather(c, 2, idx8).transpose(1, 2).reshape(shape + (8,))
            return torch.gather(c8, -1, reorder)

        b_pos = torch.stack([at(pos_x), at(pos_y), at(pos_z)], dim=-1)
        b_yaw = at(yaw_bh)
        b_scale = torch.stack([at(len_h), at(wid_h), at(hei_h)], dim=-1)
        return ProposalResult(
            valid=torch.isfinite(at(final)),
            pos=b_pos,
            rotY=b_yaw,
            scale=b_scale,
            box_config_type=torch.stack(
                [at(cfgid_f).to(torch.int32), b_vp1.to(torch.int32)], dim=-1
            ),
            corners_2d=torch.stack([corners(cx_f), corners(cy_f)], dim=-2),
            corners_3d_world=_similarity_corners_3d(b_pos, b_yaw, b_scale),
            edge_distance_error=at(dist_f),
            edge_angle_error=at(angle_f),
            normalized_error=at(scores),
            skew_ratio=at(skew),
            camera_roll_delta=roll_grid[idx] - euler_raw[0],
            camera_pitch_delta=pitch_grid[idx] - euler_raw[1],
            cap_overflow=cap_overflow,
        )

    if cfg.max_cuboid_num > 1:
        # ranked ObjectSet: the N best hypotheses by final score, best first
        # (box_proposal_detail.cpp:801-838 partial-sort semantics)
        top_idx = stable_top_k(-final, cfg.max_cuboid_num)[1]  # (B, N)
        result = mk_result(top_idx)
        if not return_internals:
            return result
        return result, dict(final=final, best=top_idx, scores=scores, valid=valid_f)

    H_total = final.shape[-1]
    best = first_argmin(final)  # (B,)
    if cfg.rank_margin > 0.0:
        f_best = torch.gather(final, 1, best[:, None])
        within = final <= f_best + cfg.rank_margin
        ids = torch.arange(H_total, device=dev)
        best = torch.where(within, ids, H_total).amin(dim=-1).clamp(max=H_total - 1)
    best_valid = torch.isfinite(torch.gather(final, 1, best[:, None])[:, 0])

    if cfg.average_top_k > 1:
        # variance reduction beyond the reference's argmin-top-1: average the
        # k best hypotheses' 9-DoF states, each canonicalised to the best
        # one's front face first (rotate yaw by the nearest multiple of
        # 90 deg, swapping l/w on odd multiples — the equivalence
        # min_log_error uses, g2o_Object.h:104-114).  The averages are
        # written at the winner's index of fresh copies of the fields.
        top_idx = stable_top_k(-final, cfg.average_top_k)[1]  # (B, k)

        def g(a):
            return torch.gather(a, 1, top_idx)

        wgt = torch.isfinite(g(final)).to(dtype)
        wgt = wgt / torch.clamp(torch.sum(wgt, dim=-1, keepdim=True), min=1.0)
        yaw_k = g(yaw_bh)
        r = torch.round(-(yaw_k - yaw_k[:, :1]) / (math.pi / 2.0))
        yaw_adj = yaw_k + r * (math.pi / 2.0)
        odd = torch.remainder(r, 2.0) != 0
        len_k = torch.where(odd, g(wid_h), g(len_h))
        wid_k = torch.where(odd, g(len_h), g(wid_h))

        def put(a, v):  # a copy of `a` with the weighted mean of v at `best`
            return a.scatter(1, best[:, None], torch.sum(wgt * v, dim=-1, keepdim=True))

        pos_x = put(pos_x, g(pos_x))
        pos_y = put(pos_y, g(pos_y))
        pos_z = put(pos_z, g(pos_z))
        len_h = put(len_h, len_k)
        wid_h = put(wid_h, wid_k)
        hei_h = put(hei_h, g(hei_h))
        yaw_bh = put(yaw_bh, yaw_adj)

    result = mk_result(best)._replace(valid=best_valid)
    if not return_internals:
        return result
    first = slice(None, None, S)  # sample 0 of each box
    internals = dict(
        corners=torch.stack([cx_f, cy_f], dim=-1).permute(0, 2, 1, 3),  # (B, H, 8, 2)
        valid=valid_f,
        dist=dist_f,
        angle=angle_f,
        scores=scores,
        kept=kept,
        final=final,
        vp1_pos=vp1_f,
        cfg_id=cfgid_f,
        yaw_grid=yaw_bh if cfg.average_top_k > 1 else yaw_grid,
        pos=torch.stack([pos_x, pos_y, pos_z], dim=-1),
        scale=torch.stack([len_h, wid_h, hei_h], dim=-1),
        merged_lines=hblock["m_lines"][first],
        merged_mask=hblock["m_mask"][first],
        dist_map=hblock["dist_map"][first],
        yaws=extras["yaws"],
        top_xs=extras["top_xs"],
        top_ok=extras["top_ok"],
        best=best,
    )
    return result, internals


class _Setup(NamedTuple):
    """What the hypothesis grid takes besides the image: the floored boxes
    (left, top, w, h, right) as (B, 1) columns, the left-right-aligned lines,
    the camera's raw Euler angles, the roll/pitch samples (RP,), the yaw
    samples (Y,) and the top-edge samples (B, T) with their validity."""

    box: tuple
    lines: torch.Tensor
    euler_raw: torch.Tensor
    roll_flat: torch.Tensor
    pitch_flat: torch.Tensor
    yaws: torch.Tensor
    top_xs: torch.Tensor
    top_ok: torch.Tensor


@hostsync.stage("proposals/grid")
def _proposal_setup(gray, K, T_wc, bboxes, lines, cfg: ProposalConfig) -> _Setup:
    """The sample grids of `detect_cuboids` (box_proposal_detail.cpp:65-237)
    for boxes (B, 4) [x y w h], in gray's dtype and on its device."""
    dtype = gray.dtype
    dev = gray.device
    bboxes = bboxes.to(dtype)
    left = torch.floor(bboxes[:, 0:1])
    top = torch.floor(bboxes[:, 1:2])
    w = torch.floor(bboxes[:, 2:3])
    h = torch.floor(bboxes[:, 3:4])
    right = left + w

    lines = line_ops.align_left_right(lines.to(dtype))

    # ---- sample grids ------------------------------------------------------
    cam0 = cam.make_camera_pose(K.to(dtype), T_wc.to(dtype))
    euler_raw = cam0.euler

    if cfg.sample_cam_roll_pitch:
        rp_off = _sample_offsets(-6.0, 6.0, 3.0, dtype, dev) * (math.pi / 180.0)
        rolls = euler_raw[0] + rp_off
        pitchs = euler_raw[1] + rp_off
        roll_grid, pitch_grid = torch.meshgrid(rolls, pitchs, indexing="ij")
        roll_flat = roll_grid.reshape(-1)
        pitch_flat = pitch_grid.reshape(-1)
    else:
        roll_flat = euler_raw[0][None]
        pitch_flat = euler_raw[1][None]

    yaw_off = _sample_offsets(-45.0, 45.0, 6.0, dtype, dev) * (math.pi / 180.0)
    yaw_init = euler_raw[2] - math.pi / 2.0
    yaws = yaw_init + yaw_off  # (Y,)

    # top-edge samples (box_proposal_detail.cpp:212-237):
    # step = min(20, w // 10) integer semantics; samples while <= right-5
    step = torch.clamp(torch.floor(w / 10.0), max=20.0)  # (B, 1)
    ks = torch.arange(cfg.max_top_samples, dtype=dtype, device=dev)
    top_xs = left + 5.0 + ks * step  # (B, T)
    top_ok = (top_xs <= right - 5.0) & (step >= 1.0)
    return _Setup((left, top, w, h, right), lines, euler_raw, roll_flat, pitch_flat,
                  yaws, top_xs, top_ok)


def detect_cuboids(
    gray: torch.Tensor,
    K: torch.Tensor,
    T_wc: torch.Tensor,
    bboxes: torch.Tensor,
    bbox_mask: torch.Tensor,
    lines: torch.Tensor,
    line_mask: torch.Tensor,
    cfg: ProposalConfig = ProposalConfig(),
    return_internals: bool = False,
    yaw_prior=None,
):
    """Detect cuboids for a padded batch of 2D boxes on one image.

    The reference loops over detections (box_proposal_detail.cpp:135); here
    the boxes are a batch axis of the whole per-box program (each box gets
    its own ROI distance map and hypothesis grid, all maps from one EDT
    kernel launch).  gray (H, W) float; K (3, 3); T_wc (4, 4); bboxes (B, 4)
    [x y w h] (0-based pixels); bbox_mask (B,); lines (L, 4) padded segments
    with line_mask (L,).  Returns a ProposalResult with leading axis B whose
    `valid` is ANDed with bbox_mask; with `cfg.max_cuboid_num` N > 1 every
    field has a second axis N, ranks best first, and `valid` is (B, N).
    `yaw_prior` (scalar or (B,) tensor, or None) penalises each hypothesis by
    `cfg.yaw_prior_weight` times its yaw distance, modulo 90 deg, from the
    prior.  All tensors live on gray's device.

    Mirrors detect_cuboid (box_proposal_detail.cpp:65-861).  Bbox-height
    sampling (`cfg.sample_bbox_height`, whether_sample_bbox_height in the
    reference) runs the grid at 3 bottom expansions {0, r/2, r} with
    per-sample score fusion; both reference drivers default it off
    (detect_3d_cuboid/src/main.cpp:68, object_slam/src/main_obj.cpp:498).
    """
    st = _proposal_setup(gray, K, T_wc, bboxes, lines, cfg)
    rp_valid = torch.ones(st.roll_flat.shape, dtype=torch.bool, device=gray.device)
    hblock, aux = hypothesis_grid(
        gray, K, T_wc, st.box, st.lines, line_mask, cfg,
        st.euler_raw, st.roll_flat, st.pitch_flat, rp_valid, st.yaws, st.top_xs, st.top_ok,
    )
    out = _fuse_and_rank(
        hblock, aux, cfg, st.euler_raw, yaw_prior, return_internals,
        extras=dict(yaws=st.yaws, top_xs=st.top_xs, top_ok=st.top_ok),
    )
    res = out[0] if return_internals else out
    if cfg.max_cuboid_num > 1:  # valid is (B, N): mask per box
        bbox_mask = bbox_mask[:, None]
    res = res._replace(valid=res.valid & bbox_mask)
    return (res, out[1]) if return_internals else res


def detect_cuboid_single(
    gray: torch.Tensor,
    K: torch.Tensor,
    T_wc: torch.Tensor,
    bbox: torch.Tensor,
    lines: torch.Tensor,
    line_mask: torch.Tensor,
    cfg: ProposalConfig = ProposalConfig(),
    return_internals: bool = False,
    yaw_prior=None,
):
    """Detect the best cuboid for one 2D bounding box `bbox` (4,) [x y w h]:
    `detect_cuboids` on a batch of one, with the box axis removed."""
    mask = torch.ones(1, dtype=torch.bool, device=gray.device)
    out = detect_cuboids(
        gray, K, T_wc, bbox[None], mask, lines, line_mask, cfg,
        return_internals=return_internals, yaw_prior=yaw_prior,
    )

    def drop(t):
        return t[0] if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == 1 else t

    if not return_internals:
        return ProposalResult(*(drop(t) for t in out))
    res, internals = out
    shared = ("yaws",)
    return (
        ProposalResult(*(drop(t) for t in res)),
        {k: (v if k in shared else drop(v)) for k, v in internals.items()},
    )
