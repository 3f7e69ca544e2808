"""Incremental camera-object SLAM: the per-frame step.

Re-designs the reference's per-frame loop (incremental_build_graph,
object_slam/src/main_obj.cpp:479-841): every step activates one more frame
in the fixed-capacity graph (constant-velocity pose initialisation,
measurement insertion) and re-optimises the full graph with 5 LM iterations
— the same O(N)-per-frame re-optimisation schedule as the reference — or,
in the fixed-lag step, only the trailing window (slam/window.py).

Objects are a batch axis: each frame carries up to O cuboid measurements
(with masks); an object's vertex is initialised from its first observation
(the reference's frame-0 special case generalised, main_obj.cpp:741-750).

The frame index `i` is a host integer (the caller knows which frame it is
feeding), so slot addressing costs no device read.  The graph is updated
functionally: a step returns new tensors and leaves its input untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam import ba
from cube_slam_wu_tpu_torch.slam import window as win_mod
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph


class FrameInput(NamedTuple):
    """Per-frame measurement inputs (leading axis = object)."""

    meas: Cuboid  # (O,) camera-frame cuboid measurements
    quality: torch.Tensor  # (O,) in [0.5, 1]; weight = 2*quality
    has_meas: torch.Tensor  # (O,) bool
    active: torch.Tensor  # () bool: frame exists (for padded batches)
    # optional 2D bbox observations [cx, cy, w, h] per object for
    # EdgeSE3CuboidProj factors (g2o_Object.h:264-292).  The reference's
    # object_slam main program builds only the 3D EdgeSE3Cuboid; the projection
    # edge is part of its capability surface and is wired here behind
    # bbox_weight (None/0 = reference behaviour).
    bbox: torch.Tensor | None = None  # (O, 4)
    bbox_weight: torch.Tensor | None = None  # (O,)


def _set_row(batch: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    out = batch.clone()
    out[i] = value
    return out


def _set_se3(batch: SE3, i: int, value: SE3) -> SE3:
    return SE3(_set_row(batch.quat, i, value.quat), _set_row(batch.trans, i, value.trans))


def _set_cuboid(batch: Cuboid, i: int, value: Cuboid) -> Cuboid:
    return Cuboid(_set_se3(batch.pose, i, value.pose), _set_row(batch.scale, i, value.scale))


def _insert_frame(
    graph: CameraObjectGraph,
    i: int,
    frame: FrameInput,
    first_Twc: SE3,
    gate_threshold: float | None,
    soft_gate_alpha: float | None,
    soft_gate_power: float,
) -> CameraObjectGraph:
    """Constant-velocity pose init + measurement insertion + cuboid vertex
    initialisation (shared by the full-graph and windowed steps).

    Innovation gating (beyond the reference, which feeds every detection into
    the graph unweighted): before inserting a camera-object edge, the 9-d
    `min_log_error` innovation of the measurement against the CURRENT cuboid
    estimate (at the constant-velocity predicted pose) is computed;
    `gate_threshold` drops edges whose innovation norm exceeds it, and
    `soft_gate_alpha` scales the measurement quality by
    1/(1 + alpha*innovation^power).  This is what keeps the online pipeline
    at trajectory parity despite noisier single-frame detections."""
    O = graph.n_objects
    i = int(i)

    # -- constant-velocity pose initialisation (main_obj.cpp:548-565) ----
    prev = graph.cam_Tcw[max(i - 1, 0)]
    prevprev = graph.cam_Tcw[max(i - 2, 0)]
    if i > 1:
        odom_val = prev.compose(prevprev.inverse())
    else:
        odom_val = SE3.identity(
            (), graph.cam_Tcw.trans.dtype, graph.cam_Tcw.trans.device
        )
    curr_Tcw = first_Twc.inverse() if i == 0 else odom_val.compose(prev)

    # -- innovation gating against the current cuboid estimates ----------
    curr_Twc = curr_Tcw.inverse()
    Twc_b = SE3(curr_Twc.quat.expand(O, 4), curr_Twc.trans.expand(O, 3))
    pred_global = frame.meas.transform_from(Twc_b)  # (O,)
    innovation = torch.linalg.norm(
        graph.cube.min_log_error(pred_global), dim=-1
    )  # (O,)
    can_gate = graph.cube_valid & (i > 0)
    quality = frame.quality
    has_meas = frame.has_meas
    if soft_gate_alpha is not None:
        quality = torch.where(
            can_gate,
            quality / (1.0 + soft_gate_alpha * innovation**soft_gate_power),
            quality,
        )
    if gate_threshold is not None:
        has_meas = has_meas & (~can_gate | (innovation < gate_threshold))

    # -- write the new frame into the graph ------------------------------
    g = graph._replace(
        cam_Tcw=_set_se3(graph.cam_Tcw, i, curr_Tcw),
        frame_mask=_set_row(graph.frame_mask, i, frame.active),
        odom=_set_se3(graph.odom, i, odom_val),
        odom_mask=_set_row(graph.odom_mask, i, frame.active & (i > 0)),
        cube_meas=_set_cuboid(graph.cube_meas, i, frame.meas),
        cube_meas_weight=_set_row(graph.cube_meas_weight, i, 2.0 * quality),
        cube_meas_mask=_set_row(graph.cube_meas_mask, i, frame.active & has_meas),
    )
    if frame.bbox is not None:
        g = g._replace(
            bbox_meas=_set_row(g.bbox_meas, i, frame.bbox),
            bbox_weight=_set_row(g.bbox_weight, i, frame.bbox_weight),
            bbox_mask=_set_row(
                g.bbox_mask, i, frame.active & has_meas & (frame.bbox_weight > 0)
            ),
        )

    # -- cuboid vertex initialisation on first observation ---------------
    # (generalises the reference's frame-0 init, main_obj.cpp:741-750)
    init_cube = frame.meas.transform_from(Twc_b)  # (O,)
    set_cube = (~g.cube_valid) & frame.active & frame.has_meas
    return g._replace(
        cube=Cuboid(
            SE3(
                torch.where(set_cube[:, None], init_cube.pose.quat, g.cube.pose.quat),
                torch.where(set_cube[:, None], init_cube.pose.trans, g.cube.pose.trans),
            ),
            torch.where(set_cube[:, None], init_cube.scale, g.cube.scale),
        ),
        cube_valid=g.cube_valid | set_cube,
    )


def make_incremental_step(
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Build the full-graph step:
    (graph, (index, FrameInput, first_pose)) -> (graph, (chi2, cubes)).

    `first_pose` is the fixed frame-0 camera-to-world pose (the reference
    uses the first ground-truth pose, main_obj.cpp:526)."""

    def step(carry, inp):
        graph: CameraObjectGraph = carry
        i, frame, first_Twc = inp
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )
        # -- full-graph re-optimisation (main_obj.cpp:802-803) ---------------
        result = ba.optimize(
            g, iterations=iterations, fix_first=True, robust_delta=robust_delta
        )
        g = g._replace(cam_Tcw=result.cam_Tcw, cube=result.cube)
        # skip everything for padded slots
        g = ba.tree_where(frame.active, g, graph)
        # per-frame optimized landmark snapshot (cube_pose_opti_history,
        # main_obj.cpp:815-819)
        return g, (result.chi2, g.cube.to_minimal())

    return step


def make_windowed_step(
    window: int,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Fixed-lag step: ((graph, prior), (index, FrameInput, first_pose)) ->
    ((graph, prior), (chi2, cubes)).  Optimises only the trailing `window`
    frames; on frame departure its cuboid edges are absorbed into the Gaussian
    prior (slam.window).  Per-frame cost is O(window^2 .. ^3) independent of
    the sequence length, unlike the reference's whole-graph re-optimisation
    (main_obj.cpp:802-803).

    The frame index is a host integer, so the departing frame and the
    window's start are host arithmetic and the window is a plain slice."""
    W = int(window)

    def step(carry, inp):
        graph, prior = carry
        i, frame, first_Twc = inp
        i = int(i)
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )

        # -- absorb the departing frame (index i - W) into the prior ---------
        d = max(i - W, 0)
        mask_d = g.cube_meas_mask[d] if i >= W else torch.zeros_like(g.cube_meas_mask[d])
        prior_new = win_mod.absorb_frame(
            prior,
            g.cam_Tcw[d].inverse(),
            Cuboid(g.cube_meas.pose[d], g.cube_meas.scale[d]),
            g.cube_meas_weight[d],
            mask_d,
            g.cube,
        )

        # -- optimise the trailing window ------------------------------------
        s = min(max(i - W + 1, 0), g.capacity - W)
        win = win_mod.window_slice(g, s, W)
        result = ba.optimize(
            win, iterations=iterations, fix_first=True, prior=prior_new,
            robust_delta=robust_delta,
        )
        g = win_mod.window_scatter(g, result.cam_Tcw, s)
        g = g._replace(cube=result.cube)

        # skip everything for padded slots
        g = ba.tree_where(frame.active, g, graph)
        prior_new = ba.tree_where(frame.active, prior_new, prior)
        return (g, prior_new), (result.chi2, g.cube.to_minimal())

    return step
