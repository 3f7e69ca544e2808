"""Sim(3) 7-DoF pose-graph optimization (loop-closure scale correction).

Covers the reference's bundled g2o seven-DoF types
(object_slam/Thirdparty/g2o/g2o/types/types_seven_dof_expmap.{h,cpp}:
VertexSim3Expmap + EdgeSim3), the machinery ORB-SLAM-style monocular
systems use to correct accumulated scale drift at loop closure — shipped by
the reference but unused by its driver.  The graph is fixed-shape (padded
pose/edge tensors + masks), residuals are batched over edges, Jacobians come
from forward-mode autodiff (`torch.func.jacfwd`) of the tangent increments at
zero, and the dense damped normal equations are solved on the device.  The
LM loop reads nothing back to the host: accept/reject is a `torch.where` on
0-d tensors.

Conventions (matching the g2o types):
- vertex estimate S_iw : world -> frame i similarity (VertexSim3Expmap);
- edge (i, j) measurement S_ji : frame i -> frame j relative similarity;
- error = log(S_ji_meas * S_iw * S_jw^-1)  (EdgeSim3::computeError,
  types_seven_dof_expmap.h);
- vertex update: left-multiplicative S_iw <- exp(delta) * S_iw
  (VertexSim3Expmap::oplusImpl), delta in the [omega, upsilon, sigma]
  tangent ordering of core/sim3.Sim3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core.rotations import first_argmin
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.core.sim3 import Sim3
from cube_slam_wu_tpu_torch.utils.tree import tree_where


def sim3_from_se3(T: SE3, scale=1.0) -> Sim3:
    """Embed an SE3 (batched ok) as a Sim3 with the given scale."""
    s = torch.as_tensor(scale, dtype=T.trans.dtype, device=T.trans.device)
    return Sim3(T.quat, T.trans, s.expand(T.trans.shape[:-1]).clone())


def _take(s: Sim3, idx: torch.Tensor) -> Sim3:
    """Vertices `idx` of the last batch axis (leading axes, such as the LM's
    candidate axis, pass through)."""
    return Sim3(s.quat[..., idx, :], s.trans[..., idx, :], s.scale[..., idx])


class Sim3PoseGraph(NamedTuple):
    """Padded, fixed-shape 7-DoF pose graph.

    poses: (N,) batched Sim3 vertex estimates S_iw.
    edge_i/edge_j: (E,) int32 endpoint indices (i = from, j = to).
    meas: (E,) batched Sim3 measurements S_ji.
    weight: (E,) scalar information weight per edge (info = w * I_7).
    edge_mask: (E,) bool — inactive edges contribute nothing.
    pose_mask: (N,) bool — inactive vertices receive no increments.
    """

    poses: Sim3
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    meas: Sim3
    weight: torch.Tensor
    edge_mask: torch.Tensor
    pose_mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.poses.scale.shape[-1]


def edge_residuals(graph: Sim3PoseGraph, poses: Sim3) -> torch.Tensor:
    """(..., E, 7) weighted tangent-space residuals
    sqrt(w) * log(S_ji * S_iw * S_jw^-1) for every (masked) edge.

    Masked-out edges may carry arbitrary padding in `meas` (all-zero is the
    natural fill, and a zero-scale similarity would send log() to NaN, which
    NaN*0 cannot remove).  So masked edges first have their measurement
    substituted with the exactly-consistent S_jw * S_iw^-1 built from the
    current poses — the relative term becomes the identity for EVERY pose
    perturbation, giving an identically-zero, NaN-free residual and Jacobian
    whatever the padding holds."""
    Si = _take(poses, graph.edge_i)
    Sj = _take(poses, graph.edge_j)
    m = graph.edge_mask
    consistent = Sj.compose(Si.inverse())
    meas = Sim3(
        torch.where(m[:, None], graph.meas.quat, consistent.quat),
        torch.where(m[:, None], graph.meas.trans, consistent.trans),
        torch.where(m, graph.meas.scale, consistent.scale),
    )
    err = meas.compose(Si.compose(Sj.inverse())).log()
    w = torch.sqrt(graph.weight) * m.to(err.dtype)
    return err * w[:, None]


def _apply_increments(graph: Sim3PoseGraph, dx: torch.Tensor, fix_first: bool) -> Sim3:
    """exp(dx_i) * S_iw for every vertex; `dx` is (..., 7N)."""
    N = graph.capacity
    gate = graph.pose_mask.to(dx.dtype)
    if fix_first:
        gate = gate * (torch.arange(N, device=dx.device) != 0).to(dx.dtype)
    d = dx.reshape(dx.shape[:-1] + (N, 7)) * gate[:, None]
    return Sim3.exp(d).compose(graph.poses)


def _residual_vector(graph: Sim3PoseGraph, dx: torch.Tensor, fix_first: bool) -> torch.Tensor:
    poses = _apply_increments(graph, dx, fix_first)
    return edge_residuals(graph, poses).reshape(-1)


class PoseGraphResult(NamedTuple):
    poses: Sim3
    chi2: torch.Tensor
    lambda_final: torch.Tensor


def optimize(graph: Sim3PoseGraph, iterations: int = 10, fix_first: bool = True) -> PoseGraphResult:
    """LM over the 7-DoF pose graph.

    Damping: where g2o retries an iteration serially with escalating lambda
    (optimization_algorithm_levenberg.cpp, maxTrialsAfterFailure), each
    iteration here solves a small batch of candidate dampings lam * [0.1, 1,
    10, 100] at once (one batched solve of the four damped systems) and keeps
    the best accepted step, the lowest candidate index among equal chi2.

    The first vertex is fixed by default (gauge freedom: a global Sim3 —
    including global scale — is unobservable from relative edges alone).

    The Jacobian is dense: `jacfwd` pushes 7N tangents through the E edges."""
    N = graph.capacity
    dtype = graph.poses.trans.dtype
    dev = graph.poses.trans.device
    n = N * 7
    lam_mults = torch.tensor([0.1, 1.0, 10.0, 100.0], dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    zero = torch.zeros((n,), dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    def linearize(g: Sim3PoseGraph):
        f = lambda dx: _residual_vector(g, dx, fix_first)
        r0 = f(zero)
        J = torch.func.jacfwd(f)(zero)
        return J.T @ J, J.T @ r0, torch.sum(r0 * r0)

    # the linearization that sets lambda_0 is also the first iteration's
    lin = linearize(graph)
    lam = 1e-5 * torch.amax(torch.abs(torch.diagonal(lin[0])))
    lam = torch.clamp(lam, min=1e-12)
    chi2 = lin[2]
    g = graph
    for it in range(iterations):
        H, grad, chi2_cur = lin if it == 0 else linearize(g)
        lams = lam * lam_mults
        # a damping escalated past the dtype's range (float32 after a dozen
        # rejections) gives JAX a NaN step, hence an infinite chi2: such a
        # candidate solves the identity instead (no NaN reaches the LU) and
        # gets the infinite chi2 directly
        ok = torch.isfinite(lams)
        A = torch.where(ok[:, None, None], H + lams[:, None, None] * eye, eye)  # (4, n, n)
        # solve_ex: no error check, hence no host read inside the loop
        dx = -torch.linalg.solve_ex(A, grad.expand(4, n)[..., None]).result[..., 0]
        poses_c = _apply_increments(g, dx, fix_first)  # (4, N) candidates
        r = edge_residuals(g, poses_c)
        chi2_c = torch.sum(r * r, dim=(-2, -1))
        chi2_c = torch.where(torch.isfinite(chi2_c) & ok, chi2_c, inf)
        k = first_argmin(chi2_c)
        chi2_best = chi2_c[k]
        accept = chi2_best < chi2_cur
        g = g._replace(poses=tree_where(accept, Sim3(*(a[k] for a in poses_c)), g.poses))
        # accepted: adopt the winning damping (decaying when the lightest
        # candidate wins); rejected: escalate past the heaviest candidate
        lam = torch.where(accept, lams[k], lam * 1e3)
        chi2 = torch.where(accept, chi2_best, chi2_cur)
    return PoseGraphResult(poses=g.poses, chi2=chi2, lambda_final=lam)


def chain_odometry(meas: Sim3, start: Sim3 | None = None) -> Sim3:
    """Integrate relative measurements S_{i+1,i} (shape (N-1,)) into vertex
    estimates S_iw, frame 0 at `start` (identity by default) — the
    initialisation a monocular front-end provides before loop closure.  A
    sequential loop in the order of the JAX package's scan, so its rounding
    follows that scan's."""
    dtype, dev = meas.trans.dtype, meas.trans.device
    prev = start if start is not None else Sim3.identity(dtype=dtype, device=dev)
    out = [prev]
    for i in range(meas.scale.shape[0]):
        prev = meas[i].compose(prev)
        out.append(prev)
    return Sim3(*(torch.stack(leaves) for leaves in zip(*out)))


def correct_scale_drift(
    poses_se3: SE3,
    drift_scales: torch.Tensor,
    loop_from: int,
    loop_to: int,
    loop_meas: Sim3,
    odom_weight: float = 1.0,
    loop_weight: float = 100.0,
    iterations: int = 15,
) -> PoseGraphResult:
    """Build and solve the canonical monocular loop-closure problem: a
    drifted SE3 trajectory + per-vertex accumulated scale estimates, one
    Sim3 loop edge carrying the true relative similarity.

    poses_se3: (N,) drifted camera poses T_iw; drift_scales: (N,) the
    front-end's accumulated scale per vertex (1.0 if unknown); the odometry
    edges are formed CONSISTENTLY from consecutive drifted vertices (zero
    initial residual), so all correction pressure comes from the loop edge
    — mirroring how ORB-SLAM builds its essential graph for EdgeSim3."""
    poses = sim3_from_se3(poses_se3, drift_scales)
    n = poses.scale.shape[0]
    dtype, dev = poses.trans.dtype, poses.trans.device
    idx = torch.arange(n - 1, device=dev)
    Si = _take(poses, idx)
    Sj = _take(poses, idx + 1)
    odo = Sj.compose(Si.inverse())  # S_{i+1,i}: exactly consistent

    loop = torch.tensor([loop_from], device=dev)
    edge_i = torch.cat([idx, loop]).to(torch.int32)
    edge_j = torch.cat([idx + 1, torch.tensor([loop_to], device=dev)]).to(torch.int32)
    meas = Sim3(*(torch.cat([a, b[None]]) for a, b in zip(odo, loop_meas)))
    weight = torch.cat([
        torch.full((n - 1,), odom_weight, dtype=dtype, device=dev),
        torch.tensor([loop_weight], dtype=dtype, device=dev),
    ])
    graph = Sim3PoseGraph(
        poses=poses,
        edge_i=edge_i,
        edge_j=edge_j,
        meas=meas,
        weight=weight,
        edge_mask=torch.ones((n,), dtype=torch.bool, device=dev),
        pose_mask=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    return optimize(graph, iterations=iterations)
