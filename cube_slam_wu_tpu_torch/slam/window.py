"""Sliding-window (fixed-lag) bundle adjustment support.

The reference re-optimises the ENTIRE graph every frame
(object_slam/src/main_obj.cpp:802-803); its sparse block solver
(Thirdparty/g2o/g2o/core/block_solver.h) tolerates growing graphs, but the
cost is still O(frames) per frame and unusable at KITTI length.  This design
instead runs a fixed-lag smoother:

- only the most recent W frames are free variables (the oldest in-window
  pose is the gauge anchor, held fixed — it carries the frozen past);
- when a frame leaves the window, its camera-object edges are absorbed
  into a per-object Gaussian prior: the departing pose is frozen, so each
  of its cuboid edges becomes a UNARY factor on the object, linearised
  once at the object's estimate (first-estimates-style linearisation
  point) and accumulated as a 9x9 information block + gradient;
- odometry edges of departed frames contribute through the fixed anchor.

The window's start is a host integer (the caller knows which frame it is
feeding), so slicing and scattering are plain slices: no gather, no host
read.  A slice of a tensor is a view; nothing here writes in place, so the
full graph is never changed through a window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.utils.capture import Captured
from cube_slam_wu_tpu_torch.utils.tree import tree_map, tree_where

_EPS = 1e-9

# graph fields with a leading frame axis (sliced/scattered by the window)
_FRAME_FIELDS = (
    "cam_Tcw",
    "frame_mask",
    "odom",
    "odom_mask",
    "cube_meas",
    "cube_meas_weight",
    "cube_meas_mask",
    "bbox_meas",
    "bbox_weight",
    "bbox_mask",
)


class CubePrior(NamedTuple):
    """Accumulated Gaussian prior over the O cuboid landmarks.

    Energy per object: E(c) = 0.5 d^T H d + b^T d with d = c boxminus lin
    (right-multiplicative tangent, Cuboid.exp_update convention).  S / c_vec
    are the residual factorisation r(d) = S d + c_vec with S^T S = H and
    S^T c_vec = b, recomputed at absorption time so the LM residual vector
    is a cheap matmul.
    """

    H: torch.Tensor  # (O, 9, 9)
    b: torch.Tensor  # (O, 9)
    S: torch.Tensor  # (O, 9, 9) upper-triangular sqrt information
    c_vec: torch.Tensor  # (O, 9)
    lin: Cuboid  # (O,) linearisation points
    valid: torch.Tensor  # (O,) bool

    @staticmethod
    def empty(n_objects: int, dtype=torch.float64, device="cpu") -> "CubePrior":
        O = n_objects
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return CubePrior(
            H=z(O, 9, 9),
            b=z(O, 9),
            S=z(O, 9, 9),
            c_vec=z(O, 9),
            lin=Cuboid.identity((O,), dtype, device),
            valid=torch.zeros(O, dtype=torch.bool, device=device),
        )


def prior_residuals(prior: CubePrior, cube: Cuboid) -> torch.Tensor:
    """(O, 9) residual rows of the prior at candidate estimates `cube`."""
    d = cube.log_error(prior.lin)  # (O, 9): cube = lin (+) d
    r = torch.einsum("oij,oj->oi", prior.S, d) + prior.c_vec
    return torch.where(prior.valid[:, None], r, 0.0)


def absorb_frame(
    prior: CubePrior,
    Twc_frozen: SE3,
    meas: Cuboid,
    weight: torch.Tensor,
    mask: torch.Tensor,
    cube_est: Cuboid,
    absorb_gate: float = 3.0,
    info_cap: float = 1e4,
) -> CubePrior:
    """Fold the departing frame's camera-object edges into the prior.

    Twc_frozen: () the departed camera pose (now constant); meas/weight/mask:
    (O,) its cuboid measurements; cube_est: (O,) current landmark estimates
    (used as linearisation point on an object's FIRST absorption).

    `absorb_gate` drops edges whose residual norm at the linearisation point
    exceeds it: a measurement that far from the landmark estimate is an
    outlier (wrong association, degenerate proposal), and freezing it into a
    permanent Gaussian would bias the landmark forever — the in-window
    optimisation already got its chance to reconcile it.  `info_cap` bounds
    each absorption's information diagonal: near-pi relative rotations make
    the SE3-log Jacobian diverge, and one such edge would otherwise poison
    the prior's H with ~1e12 entries — which silently disables ALL later
    window solves because LM seeds lambda_0 from max diag(H).

    The front-face choice of each edge is made at the linearisation point,
    outside the differentiated function (as in slam.ba): the half-turn
    candidate of `min_log_error` has no derivative and must never be
    differentiated through.
    """
    O = weight.shape[0]
    dtype = weight.dtype
    dev = weight.device
    Twc_b = SE3(Twc_frozen.quat.expand(O, 4), Twc_frozen.trans.expand(O, 3))
    meas_global = meas.transform_from(Twc_b)  # (O,)

    first = mask & ~prior.valid
    lin = tree_where(first, cube_est, prior.lin)

    # same residual direction as graph_residuals' camera-object term:
    # r(c) = w * c.min_log_error(meas_global) (g2o_Object.h:250-259)
    choice = lin.front_face_choice(meas_global)

    def f(d):
        # objects are independent, so one increment shared by all of them
        # gives every object's own 9x9 block with 9 tangents
        upd = lin.exp_update(d.expand(O, 9))
        return weight[:, None] * upd.log_error_for_choice(meas_global, choice)

    zero = torch.zeros((9,), dtype=dtype, device=dev)
    r0 = f(zero)  # (O, 9)
    J = torch.func.jacfwd(f)(zero)  # (O, 9, 9)

    innov = torch.linalg.norm(r0, dim=-1) / torch.clamp(weight, min=1e-9)
    gate = (mask & (weight > 0) & (innov < absorb_gate)).to(dtype)
    # bound each edge's information so one degenerate linearisation cannot
    # poison the (never-decaying) prior
    jmax = torch.amax(torch.abs(J), dim=(-2, -1))  # (O,)
    shrink = torch.clamp(info_cap**0.5 / torch.clamp(jmax, min=1e-12), max=1.0)
    J = J * (gate * shrink)[:, None, None]
    r0 = r0 * (gate * shrink)[:, None]

    H = prior.H + torch.einsum("oki,okj->oij", J, J)
    b = prior.b + torch.einsum("oki,ok->oi", J, r0)
    valid = prior.valid | (gate > 0)

    eye = torch.eye(9, dtype=dtype, device=dev)
    # cholesky_ex: no error check, hence no host read; a failed factor is NaN
    # as it is in the reference implementation
    L = _cholesky_nan(H + _EPS * eye)  # (O, 9, 9) lower
    S = L.transpose(-1, -2)
    c_vec = torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
    vgate = valid[:, None]
    return CubePrior(
        H=H,
        b=b,
        S=torch.where(vgate[..., None], S, 0.0),
        c_vec=torch.where(vgate, c_vec, 0.0),
        lin=lin,
        valid=valid,
    )


# the process's captured absorption (`utils.capture.Captured`): the fixed-lag
# point step (`tracker.make_windowed_point_step`) absorbs a departing frame at
# the same shapes on every frame, so on a card `absorb_frame` is captured once
# per signature (the inputs' shapes, dtypes and device, and `absorb_gate` and
# `info_cap` where a caller passes them) and replayed; on the CPU it is plain
# `absorb_frame`.  The function is
# looked up when called, so what replaces the module's `absorb_frame` is what
# runs.
captured_absorb = Captured(lambda *args, **options: absorb_frame(*args, **options))


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; a matrix that is not positive definite
    gives NaN (no exception, no host read)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def window_slice(graph: CameraObjectGraph, start: int, W: int) -> CameraObjectGraph:
    """The W-frame window [start, start+W) as a standalone graph.

    The first in-window odometry edge reaches outside the window, so its
    mask is cleared (the anchor pose is fixed instead).  The cleared mask is a
    new tensor: the full graph's `odom_mask` is not written."""
    start = int(start)
    sl = slice(start, start + W)
    win = graph._replace(
        **{name: tree_map(lambda a: a[sl], getattr(graph, name)) for name in _FRAME_FIELDS}
    )
    odom_mask = torch.cat([torch.zeros_like(win.odom_mask[:1]), win.odom_mask[1:]])
    return win._replace(odom_mask=odom_mask)


def window_scatter(graph: CameraObjectGraph, cam_win: SE3, start: int) -> CameraObjectGraph:
    """Write the optimized window poses back into the full-capacity graph
    (out of place)."""
    start = int(start)

    def put(full, win):
        return torch.cat([full[:start], win, full[start + win.shape[0] :]])

    return graph._replace(
        cam_Tcw=SE3(put(graph.cam_Tcw.quat, cam_win.quat), put(graph.cam_Tcw.trans, cam_win.trans))
    )

