"""Bundle adjustment over the camera-object graph: Levenberg-Marquardt,
Gauss-Newton and Powell's dogleg, with an optional Huber kernel and the
fixed-lag smoother's prior, and the marginal covariances of an estimate.

Replaces the bundled g2o optimizer stack (SparseOptimizer + BlockSolverX +
LinearSolverDense + OptimizationAlgorithmLevenberg,
object_slam/src/main_obj.cpp:510-519 and Thirdparty/g2o core) with a dense
solver:

- Jacobians come from forward-mode autodiff (`torch.func.jacfwd`) of the
  residuals with respect to tangent-space increments evaluated at zero (g2o
  numerically differentiates the same local parameterisation,
  base_binary_edge.h);
- the normal equations are dense and solved by an LU solve.  H is singular
  by design on the gauge/masked columns; LM's lambda*I (a tiny diagonal floor
  for Gauss-Newton and dogleg) is what makes the system well-posed, so this
  is a general solve, not a Cholesky;
- the damping schedule mirrors g2o's Levenberg implementation
  (optimization_algorithm_levenberg.cpp): lambda_0 = 1e-5 * max diag(H),
  accept -> lambda *= max(1/3, 1-(2*rho-1)^3), reject -> lambda *= 2.

Everything is fixed-shape; the iteration loops are branch-free (an accepted
or rejected step, and the dogleg's choice of step, are `torch.where`s on 0-d
tensors, never a host read).  Masked-out frames contribute zero residuals and
zero Jacobian columns (their increments stay zero because the damped system
is then block-diagonal lambda*I).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam.graph import (
    CameraObjectGraph,
    front_face_choice,
    graph_residuals,
)
from cube_slam_wu_tpu_torch.slam.window import prior_residuals
from cube_slam_wu_tpu_torch.utils.tree import tree_where  # noqa: F401  (used by callers as ba.tree_where)


class BAResult(NamedTuple):
    cam_Tcw: SE3
    cube: Cuboid
    chi2: torch.Tensor
    # LM: the final damping; dogleg: the final trust radius; Gauss-Newton: 0
    lambda_final: torch.Tensor


def _apply_increments(graph: CameraObjectGraph, dx: torch.Tensor, fix_first: bool):
    """Map a stacked tangent increment onto (poses, cubes).

    Layout: dx = [cam increments (F, 6) | cube increments (O, 9)].
    Camera: left-multiplicative (VertexSE3Expmap::oplusImpl), cuboid:
    right-multiplicative + additive scale (VertexCuboid::oplusImpl).
    """
    F = graph.capacity
    O = graph.n_objects
    d_cam = dx[: F * 6].reshape(F, 6)
    d_cube = dx[F * 6 :].reshape(O, 9)
    gate = graph.frame_mask.to(dx.dtype)
    if fix_first:
        gate = gate * (torch.arange(F, device=dx.device) != 0)
    d_cam = d_cam * gate[:, None]
    cam_new = SE3.exp(d_cam).compose(graph.cam_Tcw)
    cube_gate = graph.cube_valid.to(dx.dtype)[:, None]
    cube_new = graph.cube.exp_update(d_cube * cube_gate)
    return cam_new, cube_new


def _huber_scale(res: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS square-root Huber weight per edge (last axis = residual dims),
    matching g2o's RobustKernelHuber (robust_kernel_impl.cpp): residual
    blocks with norm > delta are scaled by sqrt(delta/norm)."""
    # safe sqrt: the norm's derivative is NaN at exactly-zero rows (masked
    # edges are identically zero), which would poison the Jacobian
    norm = torch.sqrt(torch.sum(res * res, dim=-1, keepdim=True) + 1e-24)
    w = torch.sqrt(torch.clamp(delta / norm, max=1.0))
    return res * w


def _residual_vector(
    graph: CameraObjectGraph,
    dx: torch.Tensor,
    fix_first: bool,
    face_choice=None,
    robust_delta: float | None = None,
    prior=None,
):
    cam, cube = _apply_increments(graph, dx, fix_first)
    odom_res, cube_res, bbox_res = graph_residuals(graph, cam, cube, face_choice)
    if robust_delta is not None:
        # the reference ships robust kernels unused (g2o robust_kernel_impl);
        # here they are an optional cap on any single edge's influence
        odom_res = _huber_scale(odom_res, robust_delta)
        cube_res = _huber_scale(cube_res, robust_delta)
        bbox_res = _huber_scale(bbox_res, robust_delta)
    parts = [odom_res.reshape(-1), cube_res.reshape(-1), bbox_res.reshape(-1)]
    if prior is not None:
        # sliding-window marginalisation prior on the cuboids (slam.window);
        # never robust-scaled: it is already a Gaussian summary
        parts.append(prior_residuals(prior, cube).reshape(-1))
    return torch.cat(parts)


def _linearize(g: CameraObjectGraph, fix_first: bool, robust_delta, prior):
    """(H, grad, chi2) of the residuals at the graph's estimates.

    The front-face choice of every camera-object edge is made once, at the
    linearization point and outside the differentiated function: forward mode
    then carries one candidate per edge instead of four (same values: the
    choice inside would be made at this point too)."""
    n = g.capacity * 6 + g.n_objects * 9
    zero = torch.zeros((n,), dtype=g.cam_Tcw.trans.dtype, device=g.cam_Tcw.trans.device)
    choice = front_face_choice(g, *_apply_increments(g, zero, fix_first))
    f = lambda dx: _residual_vector(g, dx, fix_first, choice, robust_delta, prior)
    r0 = f(zero)
    J = torch.func.jacfwd(f)(zero)
    return J.T @ J, J.T @ r0, torch.sum(r0 * r0)


def optimize(
    graph: CameraObjectGraph,
    iterations: int = 5,
    fix_first: bool = True,
    robust_delta: float | None = None,
    prior=None,
    algorithm: str = "lm",
) -> BAResult:
    """Run `iterations` outer iterations (graph.optimize(k) analogue,
    main_obj.cpp:802-803) and return updated estimates.

    `robust_delta` enables a Huber kernel on every edge (norm cap in the
    residual metric); None mirrors the reference's plain least squares.
    `prior` (slam.window.CubePrior) adds the sliding-window marginalisation
    prior on the cuboid landmarks.

    `algorithm` selects the step rule, covering the bundled g2o's three
    OptimizationAlgorithm implementations (its main program only ever uses LM,
    main_obj.cpp:517-519; GN/Dogleg ship unused):
    - "lm": Levenberg-Marquardt with the g2o damping schedule (default);
    - "gn": plain Gauss-Newton (optimization_algorithm_gauss_newton.cpp) —
      unconditional damped-free steps, tiny diagonal regularisation only
      for the gauge/masked block;
    - "dogleg": Powell's dogleg trust region
      (optimization_algorithm_dogleg.cpp): blend of the Gauss-Newton and
      Cauchy steepest-descent steps inside an adaptive radius."""
    if algorithm not in ("lm", "gn", "dogleg"):
        raise ValueError(f"unknown algorithm {algorithm!r}")

    F = graph.capacity
    dtype = graph.cam_Tcw.trans.dtype
    dev = graph.cam_Tcw.trans.device
    n = F * 6 + graph.n_objects * 9
    zero = torch.zeros((n,), dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)

    def chi2_of(g: CameraObjectGraph):
        r = _residual_vector(g, zero, fix_first, None, robust_delta, prior)
        return torch.sum(r * r)

    def linearize(g: CameraObjectGraph):
        return _linearize(g, fix_first, robust_delta, prior)

    def solve(A, grad):
        # solve_ex: no error check, hence no host read inside the loop
        return -torch.linalg.solve_ex(A, grad[:, None]).result[:, 0]

    def solve_reg(H, grad, reg_scale):
        """Damped solve; the tiny floor also regularises the gauge/masked
        columns (zeroed by _apply_increments) that make H singular."""
        reg = reg_scale * torch.clamp(torch.amax(torch.abs(torch.diagonal(H))), min=1.0)
        return solve(H + reg * eye, grad)

    def moved(g: CameraObjectGraph, dx):
        cam_new, cube_new = _apply_increments(g, dx, fix_first)
        return g._replace(cam_Tcw=cam_new, cube=cube_new)

    def keep_if(accept, g_new: CameraObjectGraph, g: CameraObjectGraph):
        return g._replace(
            cam_Tcw=tree_where(accept, g_new.cam_Tcw, g.cam_Tcw),
            cube=tree_where(accept, g_new.cube, g.cube),
        )

    g = graph
    if algorithm == "gn":
        for _ in range(iterations):
            H, grad, _ = linearize(g)
            g = moved(g, solve_reg(H, grad, 1e-10))
        return BAResult(
            cam_Tcw=g.cam_Tcw, cube=g.cube, chi2=chi2_of(g),
            lambda_final=torch.zeros((), dtype=dtype, device=dev),
        )

    if algorithm == "dogleg":
        Delta = torch.full((), 1e4, dtype=dtype, device=dev)
        chi2 = chi2_of(g)
        norm = torch.linalg.vector_norm
        for _ in range(iterations):
            H, grad, chi2_cur = linearize(g)
            h_gn = solve_reg(H, grad, 1e-10)
            gg = torch.dot(grad, grad)
            gBg = torch.dot(grad, H @ grad)
            alpha = gg / torch.clamp(gBg, min=1e-30)
            h_sd = -alpha * grad
            n_gn = norm(h_gn)
            n_sd = norm(h_sd)
            d = h_gn - h_sd
            c = torch.dot(h_sd, d)
            dd = torch.clamp(torch.dot(d, d), min=1e-30)
            disc = torch.sqrt(torch.clamp(c * c + dd * (Delta**2 - n_sd**2), min=0.0))
            beta = torch.where(
                c <= 0,
                (-c + disc) / dd,
                (Delta**2 - n_sd**2) / torch.clamp(c + disc, min=1e-30),
            )
            h_blend = h_sd + torch.clamp(beta, 0.0, 1.0) * d
            h = torch.where(
                n_gn <= Delta,
                h_gn,
                torch.where(
                    n_sd >= Delta,
                    (Delta / torch.clamp(n_sd, min=1e-30)) * h_sd,
                    h_blend,
                ),
            )
            g_new = moved(g, h)
            chi2_new = chi2_of(g_new)
            pred = -(torch.dot(grad, h) + 0.5 * torch.dot(h, H @ h))
            rho = (chi2_cur - chi2_new) / torch.clamp(pred, min=1e-30)
            accept = (rho > 0) & torch.isfinite(chi2_new)
            h_norm = norm(h)
            Delta = torch.where(
                rho > 0.75,
                torch.maximum(Delta, 3.0 * h_norm),
                torch.where(rho < 0.25, 0.5 * Delta, Delta),
            )
            g = keep_if(accept, g_new, g)
            chi2 = torch.where(accept, chi2_new, chi2_cur)
        return BAResult(cam_Tcw=g.cam_Tcw, cube=g.cube, chi2=chi2, lambda_final=Delta)

    # the linearization that sets lambda_0 is also the first iteration's
    lin = linearize(graph)
    chi2 = lin[2]
    lam = 1e-5 * torch.amax(torch.abs(torch.diagonal(lin[0])))
    lam = torch.clamp(lam, min=1e-12)
    ni = torch.full((), 2.0, dtype=dtype, device=dev)

    for it in range(iterations):
        H, grad, chi2_cur = lin if it == 0 else linearize(g)
        dx = solve(H + lam * eye, grad)
        g_new = moved(g, dx)
        chi2_new = chi2_of(g_new)

        # gain ratio rho = (F0 - F1) / (0.5 * dx^T (lam*dx - grad))
        denom = torch.clamp(torch.abs(torch.dot(dx, lam * dx - grad)), min=1e-30)
        rho = (chi2_cur - chi2_new) / denom
        accept = (rho > 0) & torch.isfinite(chi2_new)

        scale = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.where(accept, lam * scale, lam * ni)
        ni = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
        g = keep_if(accept, g_new, g)
        chi2 = torch.where(accept, chi2_new, chi2_cur)
        lam = lam_next

    return BAResult(cam_Tcw=g.cam_Tcw, cube=g.cube, chi2=chi2, lambda_final=lam)


class MarginalCovariance(NamedTuple):
    cam: torch.Tensor  # (F, 6, 6) per-camera tangent-space covariance blocks
    cube: torch.Tensor  # (O, 9, 9) per-cuboid covariance blocks
    cam_valid: torch.Tensor  # (F,) bool: block is estimable (active, not gauge)
    cube_valid: torch.Tensor  # (O,) bool


def marginal_covariance(
    graph: CameraObjectGraph,
    fix_first: bool = True,
    robust_delta: float | None = None,
) -> MarginalCovariance:
    """Per-vertex marginal covariance blocks of the current estimate.

    Linearizes at the current estimate and inverts the Gauss-Newton
    information matrix H = J^T J — the same quantity g2o's
    SparseOptimizer::computeMarginals extracts via a sparse partial inverse
    (Thirdparty/g2o g2o/core/sparse_optimizer.h; the reference's main program
    never calls it, but it is part of the optimizer's API surface).  Because
    the residuals are pre-scaled by sqrt-information (cube_meas_weight), H is
    the information matrix and its inverse the covariance.

    Gauge/inactive parameters (the fixed first camera, masked frames,
    uninitialised cuboids) have zero Jacobian columns; their rows/columns
    are replaced by identity before the inverse and their blocks reported
    as zero with `*_valid` False.

    With `fix_first=False` the global gauge is unconstrained and H is
    singular along it — the returned blocks are then numerically meaningless
    (~1e14 pseudo-variances).  Keep the gauge fixed when extracting
    covariances, exactly as g2o requires a fixed vertex for computeMarginals.
    """
    F = graph.capacity
    O = graph.n_objects
    dtype = graph.cam_Tcw.trans.dtype
    dev = graph.cam_Tcw.trans.device
    H = _linearize(graph, fix_first, robust_delta, None)[0]

    cam_active = graph.frame_mask
    if fix_first:
        cam_active = cam_active & (torch.arange(F, device=dev) != 0)
    active = torch.cat(
        [
            torch.repeat_interleave(cam_active, 6),
            torch.repeat_interleave(graph.cube_valid, 9),
        ]
    )
    # identity on the inactive complement keeps H nonsingular without
    # perturbing the active sub-block's inverse (block-diagonal split)
    a = active.to(dtype)
    outer = a[:, None] * a[None, :]
    H_reg = H * outer + torch.diag(1.0 - a)
    # inv_ex: no error check, hence no host read
    sigma = torch.linalg.inv_ex(H_reg).inverse * outer

    base = F * 6
    cam_blocks = torch.stack([sigma[i * 6 : (i + 1) * 6, i * 6 : (i + 1) * 6] for i in range(F)])
    cube_blocks = torch.stack(
        [
            sigma[base + i * 9 : base + (i + 1) * 9, base + i * 9 : base + (i + 1) * 9]
            for i in range(O)
        ]
    )
    return MarginalCovariance(
        cam=cam_blocks, cube=cube_blocks, cam_valid=cam_active, cube_valid=graph.cube_valid
    )
