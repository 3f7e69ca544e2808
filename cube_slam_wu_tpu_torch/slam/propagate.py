"""Spanning-tree initial-estimate propagation over the camera-object graph.

Covers the reference's g2o `EstimatePropagator` / `HyperDijkstra` pair
(object_slam/Thirdparty/g2o/g2o/core/estimate_propagator.{h,cpp},
hyper_dijkstra.{h,cpp}): before a *batch* optimisation, vertices with no
estimate are initialised by walking min-cost paths from the fixed vertices
and composing each edge's measurement along the way.

The g2o implementation is a sequential Dijkstra with a priority queue over a
pointer graph.  This design is a fixed-shape *parallel Bellman-Ford*: every
relaxation round updates ALL vertices at once with masked min-reductions over
the edge tables, so the whole propagation is a loop of fixed length over
dense tensor ops (no queue, no data-dependent shapes, no host read).  A graph
of diameter D converges in D rounds; rounds are cheap (a handful of
(F,)/(F, O) element-wise ops and SE3 composes).

Edge semantics (matching graph.py / the reference measurement models):
- odometry edge i:   odom[i] = Tcw_i * Twc_{i-1}
    forward   Tcw_i     = odom[i] * Tcw_{i-1}
    backward  Tcw_{i-1} = odom[i]^-1 * Tcw_i
- camera-object edge (f, o): cube_meas[f, o] is the cuboid in camera frame f
    frame -> object:  cube_world = meas.transform_from(Twc_f)
    object -> frame:  Twc_f = pose_w * pose_meas^-1  =>
                      Tcw_f = pose_meas * pose_w^-1
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core import rotations as rot
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.utils.tree import tree_where as _select


class PropagateResult(NamedTuple):
    graph: CameraObjectGraph  # estimates overwritten where reached
    frame_dist: torch.Tensor  # (F,) path cost from the fixed set (inf = unreached)
    cube_dist: torch.Tensor  # (O,) path cost (inf = unreached)


def _cuboid_at(c: Cuboid, idx) -> Cuboid:
    return Cuboid(c.pose[idx], c.scale[idx])


def propagate_estimates(
    graph: CameraObjectGraph,
    fixed_frames: torch.Tensor | None = None,
    odom_cost: float = 1.0,
    cube_cost: float | None = None,
    rounds: int | None = None,
) -> PropagateResult:
    """Initialise every reachable vertex estimate from the fixed frames.

    Args:
      graph: measurements + masks (estimates of non-fixed vertices ignored).
      fixed_frames: (F,) bool — trusted pose slots to propagate FROM.
        Defaults to frame 0 (the reference fixes vertex 0,
        main_obj.cpp:758-760).
      odom_cost / cube_cost: per-edge path costs.  cube_cost defaults to
        F * odom_cost + 1, which makes a single landmark hop more expensive
        than the LONGEST possible odometry path: relative odometry is far
        more reliable than a single-view cuboid measurement, so hops only
        bridge genuine odometry breaks — the same preference as g2o's
        `EstimatePropagatorCostOdometry`.
      rounds: relaxation rounds; defaults to F + O (covers any diameter).

    Unreached vertices keep their incoming estimates.
    """
    F = graph.capacity
    O = graph.n_objects
    dtype = graph.cam_Tcw.trans.dtype
    dev = graph.cam_Tcw.trans.device
    inf = math.inf
    if cube_cost is None:
        cube_cost = F * odom_cost + 1.0

    idx = torch.arange(F, device=dev)
    if fixed_frames is None:
        fixed_frames = idx == 0
    fixed_frames = fixed_frames & graph.frame_mask

    if rounds is None:
        rounds = F + O

    prev_i = torch.clamp(idx - 1, min=0)
    next_i = torch.clamp(idx + 1, max=F - 1)
    objs = torch.arange(O, device=dev)
    # odometry edge i links frames (i-1, i); valid both directions
    fwd_ok = graph.odom_mask & (idx > 0) & graph.frame_mask
    # edge at slot i+1 seen from frame i
    bwd_ok = graph.odom_mask[next_i] & (idx < F - 1) & graph.frame_mask
    meas_ok = (
        graph.cube_meas_mask
        & graph.frame_mask[:, None]
        & (graph.cube_meas_weight > 0)
    )
    odom_inv = graph.odom.inverse()

    zero_f = torch.zeros(F, dtype=dtype, device=dev)
    dist_f = torch.where(fixed_frames, zero_f, inf)
    dist_o = torch.full((O,), inf, dtype=dtype, device=dev)
    Tcw, cube = graph.cam_Tcw, graph.cube

    for _ in range(rounds):
        # -- odometry forward: frame i-1 -> frame i --------------------------
        cand = torch.where(fwd_ok, dist_f[prev_i] + odom_cost, inf)
        pose = graph.odom.compose(Tcw[prev_i])
        better = cand < dist_f
        dist_f = torch.where(better, cand, dist_f)
        Tcw = _select(better, pose, Tcw)

        # -- odometry backward: frame i+1 -> frame i -------------------------
        cand = torch.where(bwd_ok, dist_f[next_i] + odom_cost, inf)
        pose = odom_inv[next_i].compose(Tcw[next_i])
        better = cand < dist_f
        dist_f = torch.where(better, cand, dist_f)
        Tcw = _select(better, pose, Tcw)

        # -- frame -> object: lift the min-cost frame's measurement ----------
        cand_fo = torch.where(meas_ok, dist_f[:, None] + cube_cost, inf)  # (F, O)
        best_f = rot.first_argmin(cand_fo, dim=0)  # (O,)
        cand_o = cand_fo[best_f, objs]
        # (O,) cuboid measurements from each object's best frame
        meas_best = _cuboid_at(graph.cube_meas, (best_f, objs))
        cube_cand = meas_best.transform_from(Tcw[best_f].inverse())
        better = cand_o < dist_o
        dist_o = torch.where(better, cand_o, dist_o)
        cube = _select(better, cube_cand, cube)

        # -- object -> frame: Tcw_f = pose_meas * pose_world^-1 --------------
        cand_of = torch.where(meas_ok, dist_o[None, :] + cube_cost, inf)  # (F, O)
        best_o = rot.first_argmin(cand_of)  # (F,)
        cand_f = cand_of[idx, best_o]
        # (F,) each frame's measurement of its best object
        meas_f = _cuboid_at(graph.cube_meas, (idx, best_o))
        pose_cand = meas_f.pose.compose(cube.pose[best_o].inverse())
        better = cand_f < dist_f
        dist_f = torch.where(better, cand_f, dist_f)
        Tcw = _select(better, pose_cand, Tcw)

    out = graph._replace(cam_Tcw=Tcw, cube=cube)
    return PropagateResult(out, dist_f, dist_o)
