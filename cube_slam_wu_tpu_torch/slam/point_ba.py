"""Joint camera-object-point bundle adjustment with Schur complement.

Covers the reference's point-landmark machinery: g2o's SBA point vertices and
mono projection edges (Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:145-175,
types_sba.{h,cpp}) and the Schur-complement block solver
(g2o/core/block_solver.h), as dense batched tensor algebra:

- observations live in a dense (F frames x P points) raster with a mask;
- the per-observation 2x6 pose and 2x3 point Jacobians are written out in
  closed form (the derivative at zero of the left-multiplicative pose update
  and the additive point update of the pinhole projection, and of the Huber
  scaling when `point_huber` is set): one batched expression over (F, P)
  instead of a forward-mode pass per observation;
- the normal equations are reduced over the points with the classic Schur
  complement
      H_red = H_cc - sum_p W_p Hpp_p^-1 W_p^T,
  then a dense solve for cameras + cuboids and a batched 3x3
  back-substitution for the points;
- the LM damping schedule matches slam.ba.optimize.

The camera-object edges of the cuboid graph are folded into the same reduced
system, so this is the full CubeSLAM objective: odometry + cuboid + point
reprojection.  Every solve and inverse is an `_ex` variant and the LM
accept/reject is a `torch.where`: no host read inside the loop.

That makes the whole of `optimize` capturable in a CUDA graph.  `captured_lm`
(a `CapturedLM`, one per process) is what a per-frame caller runs: on a card
its first call for a signature (the inputs' structure, shapes, dtypes and
device, the Python numbers among them, and the options) warms up, captures
`optimize` into a graph and keeps the graph with its static input and output
tensors; every call copies the inputs into the static ones and replays, so
the host enqueues one graph instead of the LM's tens of thousands of kernels
(`utils.capture.Captured`).  It hands back clones of the static outputs: the
next replay overwrites those buffers, and a caller keeps what it got (the
fixed-lag step puts the result into its carry).  On the CPU it is plain
`optimize`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core import rotations as rot
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam.ba import (
    _apply_increments,
    _huber_scale,
    _linearize,
    _residual_vector,
    tree_where,
)
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.utils.capture import Captured


class PointFactors(NamedTuple):
    """Point landmarks + dense observation raster.

    points: (P, 3) world positions; obs_uv: (F, P, 2) pixel observations;
    obs_mask: (F, P) validity; obs_weight: (F, P) sqrt-information.

    Stereo (g2o EdgeStereoSE3ProjectXYZ, types_six_dof_expmap.h:217-270):
    obs_ur (F, P) right-camera u observations with stereo_mask; `baseline`
    is fx*b in pixels.  Stereo rows add a third residual
    u_r_pred = u - baseline/z.
    """

    points: torch.Tensor
    point_mask: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor
    obs_weight: torch.Tensor
    obs_ur: torch.Tensor | None = None  # (F, P) right-image u
    stereo_mask: torch.Tensor | None = None  # (F, P)
    baseline: float = 0.0  # fx * b (pixels)


def project_point(Tcw: SE3, X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """World point -> pixel (EdgeSE3ProjectXYZ cam_project semantics)."""
    pc = Tcw.apply(X)
    z = torch.clamp(pc[..., 2], min=1e-9)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def project_point_stereo(Tcw: SE3, X: torch.Tensor, K: torch.Tensor, baseline: float) -> torch.Tensor:
    """World point -> (u, v, u_right) (EdgeStereoSE3ProjectXYZ cam_project,
    types_six_dof_expmap.h:217-270); baseline = fx*b in pixels."""
    pc = Tcw.apply(X)
    z = torch.clamp(pc[..., 2], min=1e-9)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return torch.stack([u, v, u - baseline / z], dim=-1)


def _obs_residual(d_pose, d_point, Tcw0: SE3, X0, uv, K):
    """Residual of one observation as a function of local increments
    (left-multiplicative pose update, additive point update)."""
    Tcw = SE3.exp(d_pose).compose(Tcw0)
    return uv - project_point(Tcw, X0 + d_point, K)


def _obs_residual_stereo(d_pose, d_point, Tcw0: SE3, X0, uvr, K, baseline):
    Tcw = SE3.exp(d_pose).compose(Tcw0)
    return uvr - project_point_stereo(Tcw, X0 + d_point, K, baseline)


def _obs_jacobians(Tcw: SE3, X: torch.Tensor, K: torch.Tensor, baseline: float | None):
    """Residuals and their derivatives for every (frame, point) pair at zero
    increments: r = obs - proj(exp(d_pose) Tcw, X + d_point).

    Tcw batched (F,), X (P, 3).  Returns (pred (F, P, R), dr/d_pose (F, P, R,
    6), dr/d_point (F, P, R, 3)) with R = 2 (mono) or 3 (stereo); the residual
    itself is obs - pred.  d pc / d_pose = [-[pc]x | I] (tangent = [omega,
    upsilon]), d pc / d_point = R_cw; the projection's depth is clamped at
    1e-9, beyond which it has no derivative in depth."""
    Tb = Tcw[:, None]
    pc = Tb.apply(X[None, :, :])  # (F, P, 3)
    x, y, zr = pc[..., 0], pc[..., 1], pc[..., 2]
    live = zr > 1e-9
    z = torch.clamp(zr, min=1e-9)
    fx, fy = K[0, 0], K[1, 1]
    u = fx * x / z + K[0, 2]
    v = fy * y / z + K[1, 2]
    zero = torch.zeros_like(z)
    dz_u = torch.where(live, -fx * x / (z * z), zero)
    dz_v = torch.where(live, -fy * y / (z * z), zero)
    rows = [
        torch.stack([fx / z, zero, dz_u], dim=-1),
        torch.stack([zero, fy / z, dz_v], dim=-1),
    ]
    preds = [u, v]
    if baseline is not None:
        preds.append(u - baseline / z)
        dz_r = dz_u + torch.where(live, baseline / (z * z), zero)
        rows.append(torch.stack([fx / z, zero, dz_r], dim=-1))
    Jproj = torch.stack(rows, dim=-2)  # (F, P, R, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dpose = torch.cat([-rot.skew(pc), eye], dim=-1)  # (F, P, 3, 6)
    Rcw = Tcw.rotation_matrix()[:, None]  # (F, 1, 3, 3)
    A = -(Jproj @ dpc_dpose)
    B = -(Jproj @ Rcw)
    return torch.stack(preds, dim=-1), A, B


def _huber_jacobian(res: torch.Tensor, delta: float) -> torch.Tensor:
    """d/dres of `ba._huber_scale(res, delta)`: w (I - 0.5 r r^T / |r|^2)
    beyond the threshold, I inside it (last axis = residual dims)."""
    sq = torch.sum(res * res, dim=-1, keepdim=True) + 1e-24
    norm = torch.sqrt(sq)
    ratio = delta / norm
    w = torch.sqrt(torch.clamp(ratio, max=1.0))
    n = res.shape[-1]
    eye = torch.eye(n, dtype=res.dtype, device=res.device)
    outer = res[..., :, None] * res[..., None, :] / sq[..., None]
    robust = w[..., None] * (eye - 0.5 * outer)
    return torch.where((ratio < 1.0)[..., None], robust, eye)


def triangulate_points(cam_Tcw: SE3, obs_uv: torch.Tensor, obs_mask: torch.Tensor, K: torch.Tensor):
    """Batched DLT triangulation.

    cam_Tcw (F,), obs_uv (F, P, 2), obs_mask (F, P) -> (points (P, 3),
    ok (P,)).  Classic homogeneous linear system u*(p3.X) - p1.X = 0 per
    observation; smallest eigenvector of the masked normal matrix.  Validity:
    >= 2 observations and positive depth in every observing frame."""
    F = obs_uv.shape[0]
    R = cam_Tcw.rotation_matrix()  # (F, 3, 3)
    t = cam_Tcw.trans  # (F, 3)
    Pm = K @ torch.cat([R, t[..., None]], dim=-1)  # (F, 3, 4)

    u = obs_uv[..., 0]
    v = obs_uv[..., 1]
    rows = torch.stack(
        [
            u[..., None] * Pm[:, None, 2, :] - Pm[:, None, 0, :],
            v[..., None] * Pm[:, None, 2, :] - Pm[:, None, 1, :],
        ],
        dim=2,
    )  # (F, P, 2, 4)
    rows = torch.where(obs_mask[..., None, None], rows, 0.0)
    A = rows.permute(1, 0, 2, 3).reshape(-1, F * 2, 4)  # (P, 2F, 4)
    N = torch.einsum("pij,pik->pjk", A, A)  # (P, 4, 4)
    _, vecs = torch.linalg.eigh(N)
    X_h = vecs[..., 0]  # smallest eigenvector
    w = X_h[..., 3]
    w_safe = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    X = X_h[..., :3] / w_safe[..., None]

    # positive depth in all observing frames
    pc_z = torch.einsum("fj,pj->fp", R[:, 2, :], X) + t[:, 2][:, None]
    depth_ok = torch.all(torch.where(obs_mask, pc_z > 0.1, True), dim=0)
    n_obs = torch.sum(obs_mask, dim=0)
    ok = (n_obs >= 2) & depth_ok & torch.all(torch.isfinite(X), dim=-1)
    return X, ok


class PointBAResult(NamedTuple):
    cam_Tcw: SE3
    cube: Cuboid
    points: torch.Tensor
    chi2: torch.Tensor
    lambda_final: torch.Tensor
    accepted: torch.Tensor  # () int64: the LM iterations whose step was taken


def optimize(
    graph: CameraObjectGraph,
    pts: PointFactors,
    K: torch.Tensor,
    iterations: int = 5,
    fix_first: bool = True,
    robust_delta: float | None = None,
    prior=None,
    point_huber: float | None = None,
) -> PointBAResult:
    """LM over cameras + cuboids + points with Schur reduction over points.

    `robust_delta` / `prior` apply to the graph part exactly as in
    slam.ba.optimize (Huber on odometry/cuboid/bbox edges; sliding-window
    CubePrior on the landmarks), so this solver serves as the windowed
    incremental back-end.  `point_huber` (pixels) puts a Huber kernel on
    each point reprojection residual (g2o RobustKernelHuber semantics,
    differentiated through like slam.ba._huber_scale)."""
    F = graph.capacity
    dtype = graph.cam_Tcw.trans.dtype
    dev = graph.cam_Tcw.trans.device
    n_c = F * 6 + graph.n_objects * 9  # camera + cuboid block size
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye_c = torch.eye(n_c, dtype=dtype, device=dev)
    eye_f = torch.eye(F, dtype=dtype, device=dev)
    zero_c = torch.zeros((n_c,), dtype=dtype, device=dev)

    stereo = pts.obs_ur is not None
    if stereo:
        obs = torch.cat([pts.obs_uv, pts.obs_ur[..., None]], dim=-1)
        stereo_mask = pts.stereo_mask
        if stereo_mask is None:
            stereo_mask = torch.ones(pts.obs_ur.shape, dtype=torch.bool, device=dev)
        row_mask = torch.stack([pts.obs_mask, pts.obs_mask, pts.obs_mask & stereo_mask], dim=-1)
    else:
        obs = pts.obs_uv
        row_mask = torch.stack([pts.obs_mask, pts.obs_mask], dim=-1)
    scale = torch.where(row_mask, pts.obs_weight[..., None], 0.0)  # (F, P, R)
    baseline = pts.baseline if stereo else None

    frame_gate = graph.frame_mask.to(dtype)
    if fix_first:
        frame_gate = frame_gate * (torch.arange(F, device=dev) != 0)
    point_gate = pts.point_mask.to(dtype)

    def point_residuals(cam_Tcw: SE3, points: torch.Tensor):
        """Masked, weighted (and Huber-scaled) residuals (F, P, R)."""
        Tb = cam_Tcw[:, None]
        if stereo:
            pred = project_point_stereo(Tb, points[None], K, baseline)
        else:
            pred = project_point(Tb, points[None], K)
        raw = obs - pred
        if point_huber is not None:
            raw = _huber_scale(raw, point_huber)
        return raw * scale

    def point_terms(cam_Tcw: SE3, points: torch.Tensor):
        pred, A, B = _obs_jacobians(cam_Tcw, points, K, baseline)
        raw = obs - pred
        if point_huber is not None:
            Jh = _huber_jacobian(raw, point_huber)
            raw = _huber_scale(raw, point_huber)
            A = Jh @ A
            B = Jh @ B
        return raw * scale, A * scale[..., None], B * scale[..., None]

    def build_system(g: CameraObjectGraph, points: torch.Tensor):
        # graph part (odometry + cuboid + bbox + prior)
        H_cc, g_c, chi2 = _linearize(g, fix_first, robust_delta, prior)

        # point part
        r, A, B = point_terms(g.cam_Tcw, points)
        A = A * frame_gate[:, None, None, None]
        B = B * point_gate[None, :, None, None]
        chi2 = chi2 + torch.sum(r * r)

        # camera-block contributions (block-diagonal over frames)
        H_cc_pts = torch.einsum("fpki,fpkj->fij", A, A)  # (F, 6, 6)
        block = torch.einsum("fij,fg->figj", H_cc_pts, eye_f).reshape(F * 6, F * 6)
        H_cc = torch.cat(
            [
                torch.cat([H_cc[: F * 6, : F * 6] + block, H_cc[: F * 6, F * 6 :]], dim=1),
                H_cc[F * 6 :],
            ],
            dim=0,
        )
        g_pts = torch.einsum("fpki,fpk->fi", A, r).reshape(-1)
        g_c = torch.cat([g_c[: F * 6] + g_pts, g_c[F * 6 :]])

        # point blocks
        H_pp = torch.einsum("fpki,fpkj->pij", B, B) + 1e-12 * eye3  # (P, 3, 3)
        g_p = torch.einsum("fpki,fpk->pi", B, r)  # (P, 3)
        W = torch.einsum("fpki,fpkj->pfij", A, B)  # (P, F, 6, 3)
        return H_cc, g_c, H_pp, g_p, W, chi2

    def chi2_of(g: CameraObjectGraph, points: torch.Tensor):
        r_g = _residual_vector(g, zero_c, fix_first, None, robust_delta, prior)
        r = point_residuals(g.cam_Tcw, points)
        return torch.sum(r_g * r_g) + torch.sum(r * r)

    def solve(H_cc, g_c, H_pp, g_p, W, lam):
        H_cc_d = H_cc + lam * eye_c
        H_pp_d = H_pp + lam * eye3
        # inv_ex / solve_ex: no error check, hence no host read
        Hpp_inv = torch.linalg.inv_ex(H_pp_d).inverse  # (P, 3, 3) batched
        # Schur: H_red = H_cc - sum_p W_p Hpp^-1 W_p^T over the camera rows
        WHi = torch.einsum("pfij,pjk->pfik", W, Hpp_inv)  # (P, F, 6, 3)
        red = torch.einsum("pfik,pgjk->figj", WHi, W).reshape(F * 6, F * 6)
        H_red = torch.cat(
            [
                torch.cat([H_cc_d[: F * 6, : F * 6] - red, H_cc_d[: F * 6, F * 6 :]], dim=1),
                H_cc_d[F * 6 :],
            ],
            dim=0,
        )
        g_red = torch.cat(
            [g_c[: F * 6] - torch.einsum("pfik,pk->fi", WHi, g_p).reshape(-1), g_c[F * 6 :]]
        )
        dx_c = -torch.linalg.solve_ex(H_red, g_red[:, None]).result[:, 0]
        # back-substitute points: dx_p = -Hpp^-1 (g_p + W^T dx_c)
        dxc_cam = dx_c[: F * 6].reshape(F, 6)
        Wt_dx = torch.einsum("pfij,fi->pj", W, dxc_cam)
        dx_p = -torch.einsum("pij,pj->pi", Hpp_inv, g_p + Wt_dx)
        return dx_c, dx_p

    def apply(g: CameraObjectGraph, points, dx_c, dx_p):
        cam_new, cube_new = _apply_increments(g, dx_c, fix_first)
        return g._replace(cam_Tcw=cam_new, cube=cube_new), points + dx_p * point_gate[:, None]

    g = graph
    points = pts.points
    # the system that sets lambda_0 is also the first iteration's
    system = build_system(g, points)
    chi2 = system[5]
    lam = torch.clamp(1e-5 * torch.amax(torch.abs(torch.diagonal(system[0]))), min=1e-12)
    ni = torch.full((), 2.0, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(iterations):
        H_cc, g_c, H_pp, g_p, W, chi2_cur = system if it == 0 else build_system(g, points)
        dx_c, dx_p = solve(H_cc, g_c, H_pp, g_p, W, lam)
        g_new, pts_new = apply(g, points, dx_c, dx_p)
        chi2_new = chi2_of(g_new, pts_new)
        pred = torch.dot(dx_c, lam * dx_c - g_c) + torch.sum(dx_p * (lam * dx_p - g_p))
        rho = (chi2_cur - chi2_new) / torch.clamp(torch.abs(pred), min=1e-30)
        accept = (rho > 0) & torch.isfinite(chi2_new)
        accepted = accepted + accept.to(torch.int64)
        scale_up = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam * scale_up, lam * ni)
        ni = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
        g = g._replace(
            cam_Tcw=tree_where(accept, g_new.cam_Tcw, g.cam_Tcw),
            cube=tree_where(accept, g_new.cube, g.cube),
        )
        points = torch.where(accept, pts_new, points)
        chi2 = torch.where(accept, chi2_new, chi2_cur)
    return PointBAResult(
        cam_Tcw=g.cam_Tcw, cube=g.cube, points=points, chi2=chi2, lambda_final=lam,
        accepted=accepted,
    )


class CapturedLM(Captured):
    """`optimize`, captured in one CUDA graph per signature and replayed
    (`utils.capture.Captured`; module docstring)."""

    def __init__(self):
        super().__init__(optimize)


# the process's captured LM: a later run loop in the process (a fresh
# `run_kitti_frames` call, say) replays the graphs that an earlier one captured
captured_lm = CapturedLM()
