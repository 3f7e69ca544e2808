"""Distributed bundle adjustment: factor-sharded normal equations reduced
with `torch.distributed.all_reduce`.

The reference has no distributed compute at all (SURVEY.md section 2.9);
this is the scale-out design for the back end:

- the (small) state vector — camera poses + cuboids — is replicated on every
  rank of a process group (`replicate` broadcasts rank 0's graph);
- the FACTORS are split by frame slot: rank r of W owns the odometry and
  camera-object edges of frames [r*F/W, (r+1)*F/W), the remainder going to
  the last rank;
- each rank linearizes only its block (the other rows are zeroed) and forms
  the partial normal equations H_r = J_r^T J_r, g_r = J_r^T r_r and chi2_r;
- one `all_reduce` of the packed (n^2 + n + 1) buffer sums them; the damped
  solve and the LM accept/reject run replicated on the reduced values.

This is the "sequence parallel" analogue for SLAM: the keyframe axis is the
sequence axis (SURVEY.md section 5.7).  The only communication is the
Hessian all-reduce per linearization.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cube_slam_wu_tpu_torch.parallel import multihost
from cube_slam_wu_tpu_torch.slam.ba import BAResult, _apply_increments, _residual_vector
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph, front_face_choice
from cube_slam_wu_tpu_torch.utils.tree import tree_where


def _owned_rows(graph: CameraObjectGraph, rank: int, world: int) -> torch.Tensor:
    """Bool mask over `_residual_vector`'s rows [odom (F, 6) | cube (F, O, 9) |
    bbox (F, O, 4)]: the rows of the frames this rank owns."""
    F, O = graph.capacity, graph.n_objects
    frames = torch.arange(F, device=graph.frame_mask.device)
    block = F // world
    owned = (frames >= rank * block) & (frames < (rank + 1) * block)
    # remainder frames go to the last rank
    owned = owned | ((frames >= world * block) & (rank == world - 1))
    return torch.cat([owned.repeat_interleave(6), owned.repeat_interleave(O * 9),
                      owned.repeat_interleave(O * 4)])


def _local_residual_vector(graph, dx, fix_first: bool, rows: torch.Tensor, choice):
    """Residuals of this rank's factor block, given the replicated state, a
    replicated increment vector and the front-face choice made at the
    linearization point.  Masking (not slicing) keeps the arithmetic that of
    the single-device path; the rows this rank does not own are zero."""
    return torch.where(rows, _residual_vector(graph, dx, fix_first, choice), 0.0)


def make_sharded_optimize(group, iterations: int = 5, fix_first: bool = True):
    """Build `optimize(graph) -> BAResult` over the ranks of `group` (a
    `torch.distributed` process group; every rank calls `optimize` with the
    same replicated graph and gets the same result).

    The LM loop is `slam.ba.optimize`'s (g2o's damping schedule) without the
    robust kernel, the prior or the other step rules.  Per linearization it
    makes ONE all-reduce of the packed (J^T J, J^T r, chi2)."""
    rank, world = multihost.rank_world(group)

    def linearize(g: CameraObjectGraph):
        n = g.capacity * 6 + g.n_objects * 9
        zero = torch.zeros((n,), dtype=g.cam_Tcw.trans.dtype, device=g.cam_Tcw.trans.device)
        rows = _owned_rows(g, rank, world)
        # the choice every rank makes is the same: it sees the whole graph
        choice = front_face_choice(g, *_apply_increments(g, zero, fix_first))
        f = lambda dx: _local_residual_vector(g, dx, fix_first, rows, choice)  # noqa: E731
        r0 = f(zero)
        J = torch.func.jacfwd(f)(zero)
        packed = torch.cat([(J.T @ J).reshape(-1), J.T @ r0, torch.sum(r0 * r0)[None]])
        # Every element of the reduced buffer is summed once, by the rank that
        # owns its chunk of the ring, and then copied to the others: every rank
        # holds the same bits.  The solve and the accept/reject below are the
        # same operations on the same bits on every rank, so every rank takes
        # the same branch and the replicas never part.
        dist.all_reduce(packed, group=group)
        return packed[: n * n].reshape(n, n), packed[n * n : n * n + n], packed[-1]

    def optimize(graph: CameraObjectGraph) -> BAResult:
        F = graph.capacity
        n = F * 6 + graph.n_objects * 9
        dtype = graph.cam_Tcw.trans.dtype
        dev = graph.cam_Tcw.trans.device
        zero = torch.zeros((n,), dtype=dtype, device=dev)
        eye = torch.eye(n, dtype=dtype, device=dev)

        def chi2_of(g):
            # chi2 is cheap: evaluated unsharded, on every rank
            r = _residual_vector(g, zero, fix_first)
            return torch.sum(r * r)

        # the linearization that sets lambda_0 is also the first iteration's
        # (the same graph: the same values)
        lin = linearize(graph)
        chi2 = lin[2]
        lam = torch.clamp(1e-5 * torch.amax(torch.abs(torch.diagonal(lin[0]))), min=1e-12)
        ni = torch.full((), 2.0, dtype=dtype, device=dev)
        g = graph
        for it in range(iterations):
            H, grad, chi2_cur = lin if it == 0 else linearize(g)
            dx = -torch.linalg.solve_ex(H + lam * eye, grad[:, None]).result[:, 0]
            cam_new, cube_new = _apply_increments(g, dx, fix_first)
            g_new = g._replace(cam_Tcw=cam_new, cube=cube_new)
            chi2_new = chi2_of(g_new)
            denom = torch.clamp(torch.abs(torch.dot(dx, lam * dx - grad)), min=1e-30)
            rho = (chi2_cur - chi2_new) / denom
            accept = (rho > 0) & torch.isfinite(chi2_new)
            scale = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_next = torch.where(accept, lam * scale, lam * ni)
            ni = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
            g = g._replace(cam_Tcw=tree_where(accept, g_new.cam_Tcw, g.cam_Tcw),
                           cube=tree_where(accept, g_new.cube, g.cube))
            chi2 = torch.where(accept, chi2_new, chi2_cur)
            lam = lam_next
        return BAResult(cam_Tcw=g.cam_Tcw, cube=g.cube, chi2=chi2, lambda_final=lam)

    return optimize


def make_group():
    """The process group over every rank (`multihost.initialize` must have
    run): what `make_sharded_optimize` takes."""
    return multihost.global_group()


def replicate(tree, group, device):
    """Rank 0's graph (or any nested NamedTuple of tensors) on `device` on
    every rank of `group`, broadcast from rank 0."""
    return multihost.replicate_tree(tree, group, device)
