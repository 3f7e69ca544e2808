"""Sim(3) similarity transforms (rotation + translation + scale).

Covers the reference's bundled g2o Sim3 type
(object_slam/Thirdparty/g2o/g2o/types/sim3.h) used by ORB-SLAM-style loop
closing: a batched NamedTuple of tensors with exp/log in the [omega(3),
upsilon(3), sigma(1)] tangent ordering, composition, inverse and point action
p -> s R p + t.

The small-angle and small-scale branches are `torch.where`s over operands
that are themselves guarded (a squared norm replaced by 1 where it is small,
never a norm of zero), so forward-mode tangents (`torch.func.jacfwd`) stay
finite at the zero tangent, the LM linearisation point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core import rotations as rot

_EPS = 1e-7


def _sim3_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix coupling translation to (rotation, scale) in Sim3 exp:
    t = W upsilon (Strasdat; g2o sim3.h constructor).  Batched with
    small-theta / small-sigma series guards."""
    s = torch.exp(sigma)
    # squared-norm guard: a norm has a NaN derivative at omega == 0, which
    # poisons jacfwd at the zero tangent; sqrt of the guarded square is smooth
    # on both branches
    theta2 = torch.sum(omega * omega, dim=-1)
    small_t = theta2 < _EPS * _EPS
    small_s = torch.abs(sigma) < _EPS
    th = torch.sqrt(torch.where(small_t, torch.ones_like(theta2), theta2))
    sg = torch.where(small_s, torch.ones_like(sigma), sigma)

    Om = rot.skew(omega)
    Om2 = Om @ Om
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(Om.shape)

    th2 = th * th
    sg2 = sg * sg
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    C = torch.where(small_s, torch.ones_like(sg), (s - 1.0) / sg)
    A_ss = torch.where(small_t, torch.full_like(th, 0.5), (1.0 - cos_t) / th2)
    # Strasdat's closed form: A = (a*sigma + (1-b)*theta) /
    # (theta*(sigma^2+theta^2)) with a = s*sin(theta), b = s*cos(theta)
    A_gs = (s * sin_t * sg + (1.0 - s * cos_t) * th) / (th * (sg2 + th2))
    A_gt = ((sg - 1.0) * s + 1.0) / sg2
    A = torch.where(small_s, A_ss, torch.where(small_t, A_gt, A_gs))

    B_ss = torch.where(small_t, torch.full_like(th, 1.0 / 6.0), (th - sin_t) / (th2 * th))
    B_gs = (C - ((s * cos_t - 1.0) * sg + s * sin_t * th) / (sg2 + th2)) / th2
    B_gt = (s * (0.5 * sg2 - sg + 1.0) - 1.0) / (sg2 * sg)
    B = torch.where(small_s, B_ss, torch.where(small_t, B_gt, B_gs))

    return C[..., None, None] * eye + A[..., None, None] * Om + B[..., None, None] * Om2


class Sim3(NamedTuple):
    quat: torch.Tensor  # (..., 4) wxyz
    trans: torch.Tensor  # (..., 3)
    scale: torch.Tensor  # (...,)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "Sim3":
        batch_shape = tuple(batch_shape)
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return Sim3(
            q.expand(batch_shape + (4,)).clone(),
            torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
            torch.ones(batch_shape, dtype=dtype, device=device),
        )

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return self.scale[..., None] * rot.quat_rotate(self.quat, pts) + self.trans

    def compose(self, other: "Sim3") -> "Sim3":
        q = rot.quat_normalize(rot.quat_multiply(self.quat, other.quat))
        t = self.scale[..., None] * rot.quat_rotate(self.quat, other.trans) + self.trans
        return Sim3(q, t, self.scale * other.scale)

    def inverse(self) -> "Sim3":
        qinv = rot.quat_conjugate(self.quat)
        s_inv = 1.0 / self.scale
        t = -s_inv[..., None] * rot.quat_rotate(qinv, self.trans)
        return Sim3(qinv, t, s_inv)

    @staticmethod
    def exp(tangent: torch.Tensor) -> "Sim3":
        """tangent = [omega(3), upsilon(3), sigma(1)]; sigma = log scale."""
        omega = tangent[..., :3]
        upsilon = tangent[..., 3:6]
        sigma = tangent[..., 6]

        # squared-norm guard (see _sim3_W): keeps jacfwd finite at omega == 0
        theta2 = torch.sum(omega * omega, dim=-1)
        small_t = theta2 < _EPS * _EPS
        th = torch.sqrt(torch.where(small_t, torch.ones_like(theta2), theta2))
        Om = rot.skew(omega)
        Om2 = Om @ Om
        eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(Om.shape)
        a = torch.where(small_t, 1.0 - theta2 / 6.0, torch.sin(th) / th)
        b = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
        R = eye + a[..., None, None] * Om + b[..., None, None] * Om2

        W = _sim3_W(omega, sigma)
        t = torch.einsum("...ij,...j->...i", W, upsilon)
        return Sim3(rot.rot_to_quat(R), t, torch.exp(sigma))

    def log(self) -> torch.Tensor:
        sigma = torch.log(self.scale)
        R = rot.quat_to_rot(self.quat)
        d = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
        dR = torch.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            dim=-1,
        )
        near = d > 0.99999
        d_c = torch.clamp(d, -1.0 + 1e-12, 1.0 - 1e-12)
        theta = torch.acos(d_c)
        denom = 2.0 * torch.sqrt(torch.clamp(1.0 - d_c * d_c, min=1e-24))
        omega = torch.where(near, 0.5 + (1.0 - d) / 6.0, theta / denom)[..., None] * dR
        W = _sim3_W(omega, sigma)
        upsilon = torch.linalg.solve(W, self.trans[..., :, None])[..., 0]
        return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)

    def __getitem__(self, idx) -> "Sim3":
        return Sim3(self.quat[idx], self.trans[idx], self.scale[idx])
