"""9-DoF cuboid landmark: SE(3) pose + per-axis half-extents.

Re-designs the reference back-end cuboid state `g2o::cuboid`
(object_slam/include/object_slam/g2o_Object.h:23-199) as a batched NamedTuple
of tensors.  The update rule, error definitions (including the 4-way yaw
disambiguation of `min_log_error`, g2o_Object.h:76-101) and the corner /
projection geometry match the reference's semantics; the implementation is
branch-free so it batches over landmarks inside the bundle adjuster.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.core import rotations as rot
from cube_slam_wu_tpu_torch.core.se3 import SE3

# Unit-cube corner table, columns are corners 1..8 (g2o_Object.h:169-171).
# front-face choices of min_log_error: rotations of the other cuboid about z
_FACE_ANGLES = (-math.pi / 2, 0.0, math.pi / 2, math.pi)

_CORNERS_BODY = (
    (1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0),
    (1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0),
    (-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0),
)


# Device constants (`rotations.device_constant`), each computed as the literal
# it replaces was, so its bits are the same.


@rot.device_constant
def _yaw_quat(yaw_angle: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`quat_from_yaw` of the 0-d tensor `yaw_angle` (`Cuboid.rotate`)."""
    return rot.quat_from_yaw(torch.tensor(yaw_angle, dtype=dtype, device=device))


@rot.device_constant
def _face_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(4, 4) quaternions of the front-face rotations `_FACE_ANGLES`."""
    return rot.quat_from_yaw(torch.tensor(_FACE_ANGLES, dtype=dtype, device=device))


@rot.device_constant
def _corners_body(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(3, 8) unit-cube corner table `_CORNERS_BODY`."""
    return torch.tensor(_CORNERS_BODY, dtype=dtype, device=device)


def _swap_lw(scale: torch.Tensor) -> torch.Tensor:
    """Half-extents [l, w, h] -> [w, l, h] (a gather by a Python list
    would copy its indices to the device first)."""
    return torch.stack([scale[..., 1], scale[..., 0], scale[..., 2]], dim=-1)


class Cuboid(NamedTuple):
    """Cuboid(s): object-to-world pose + half-extents [l, w, h] (..., 3)."""

    pose: SE3
    scale: torch.Tensor

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_minimal(v: torch.Tensor) -> "Cuboid":
        """From [x y z roll pitch yaw l w h] (g2o_Object.h:37-42)."""
        q = rot.euler_zyx_to_quat(v[..., 3], v[..., 4], v[..., 5])
        return Cuboid(SE3(q, v[..., :3]), v[..., 6:9])

    def to_minimal(self) -> torch.Tensor:
        roll, pitch, yaw = rot.quat_to_euler_zyx(self.pose.quat)
        return torch.cat(
            [self.pose.trans, torch.stack([roll, pitch, yaw], dim=-1), self.scale],
            dim=-1,
        )

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "Cuboid":
        batch_shape = tuple(batch_shape)
        return Cuboid(
            SE3.identity(batch_shape, dtype, device),
            torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
        )

    # -- state update & errors ---------------------------------------------
    def exp_update(self, update: torch.Tensor) -> "Cuboid":
        """Right-multiplicative SE3 update + additive scale (g2o_Object.h:57-63)."""
        return Cuboid(
            self.pose.compose(SE3.exp(update[..., :6])),
            self.scale + update[..., 6:9],
        )

    def log_error(self, other: "Cuboid") -> torch.Tensor:
        """9-d error [se3 log of other^-1*self, self.scale - other.scale]
        (g2o_Object.h:66-73)."""
        pose_diff = other.pose.inverse().compose(self.pose)
        return torch.cat([pose_diff.log(), self.scale - other.scale], dim=-1)

    def rotate(self, yaw_angle: float) -> "Cuboid":
        """Re-pick the front face by rotating about body z; +-90deg swaps l/w
        (g2o_Object.h:104-114).  `yaw_angle` is a static python float."""
        q = _yaw_quat(float(yaw_angle), self.scale.dtype, self.scale.device)
        new_pose = SE3(
            rot.quat_normalize(
                rot.quat_multiply(self.pose.quat, q.expand(self.pose.quat.shape))
            ),
            self.pose.trans,
        )
        swap = (
            abs(abs(float(yaw_angle)) - math.pi / 2) < 1e-9
            or abs(float(yaw_angle) - 3 * math.pi / 2) < 1e-9
        )
        scale = _swap_lw(self.scale) if swap else self.scale
        return Cuboid(new_pose, scale)

    def min_log_error(self, other: "Cuboid") -> torch.Tensor:
        """Min-norm 9-d error over 4 front-face choices of `other`
        (rotations -90/0/90/180 deg about z; g2o_Object.h:76-101).

        The SE3 log loses the rotation axis at exactly 180 deg (its
        antisymmetric part vanishes there), so a candidate that is a clean
        half turn away can come out with a rotation error of exactly zero and
        an undefined derivative — it happens when a cuboid was just
        initialised from this very measurement.  Such a candidate must never
        win: for the selection its norm is floored by its true rotation angle,
        read off the quaternion, whenever that angle is within 0.01 rad of
        pi.  The errors themselves are untouched."""
        errs, best = self._front_face_errors(other)
        idx = best[..., None, None].expand(best.shape + (1, 9))
        return torch.gather(errs, -2, idx)[..., 0, :]

    def _front_face_errors(self, other: "Cuboid"):
        """(errs (..., 4, 9), best (...,)) over the four front-face choices."""
        cands = [other.rotate(a) for a in _FACE_ANGLES]
        errs = torch.stack([self.log_error(c) for c in cands], dim=-2)
        norms = torch.linalg.norm(errs, dim=-1)
        turn = []
        for c in cands:
            q = c.pose.inverse().compose(self.pose).quat
            turn.append(
                2.0 * torch.atan2(torch.linalg.norm(q[..., 1:], dim=-1), torch.abs(q[..., 0]))
            )
        turn = torch.stack(turn, dim=-1)
        norms = torch.where(turn > math.pi - 0.01, torch.maximum(norms, turn), norms)
        return errs, rot.first_argmin(norms)

    def front_face_choice(self, other: "Cuboid") -> torch.Tensor:
        """Index (0..3 for -90/0/90/180 deg) of the front-face choice that
        `min_log_error` takes."""
        return self._front_face_errors(other)[1]

    def log_error_for_choice(self, other: "Cuboid", choice: torch.Tensor) -> torch.Tensor:
        """`min_log_error` with the front-face choice given: one candidate is
        evaluated instead of four.  With `choice = front_face_choice(other)`
        the value equals `min_log_error(other)` bit for bit; a caller that
        differentiates the error passes a choice made outside the
        differentiated function and so pays for one candidate only."""
        table = _face_table(self.scale.dtype, self.scale.device)
        q = rot.quat_normalize(rot.quat_multiply(other.pose.quat, table[choice]))
        swap = (choice == 0) | (choice == 2)
        scale = torch.where(swap[..., None], _swap_lw(other.scale), other.scale)
        return self.log_error(Cuboid(SE3(q, other.pose.trans), scale))

    # -- frame changes ------------------------------------------------------
    def transform_from(self, Twc: SE3) -> "Cuboid":
        """Camera-frame cuboid -> world-frame, Twc = camera-to-world."""
        pose = Twc.compose(self.pose)
        scale = self.scale.expand(pose.batch_shape + (3,))
        return Cuboid(pose, scale)

    def transform_to(self, Twc: SE3) -> "Cuboid":
        """World-frame cuboid -> camera-frame."""
        pose = Twc.inverse().compose(self.pose)
        scale = self.scale.expand(pose.batch_shape + (3,))
        return Cuboid(pose, scale)

    # -- geometry -----------------------------------------------------------
    def corners_3d(self) -> torch.Tensor:
        """World-frame corners (..., 3, 8) (g2o_Object.h:165-178)."""
        body = _corners_body(self.scale.dtype, self.scale.device)
        scaled = self.scale[..., :, None] * body  # (..., 3, 8)
        R = self.pose.rotation_matrix()
        return R @ scaled + self.pose.trans[..., :, None]

    def project_bbox(self, Tcw: SE3, K: torch.Tensor) -> torch.Tensor:
        """Project corners with world-to-camera pose Tcw and intrinsics K,
        return [cx, cy, w, h] of the bounding rectangle (g2o_Object.h:181-197)."""
        corners_w = self.corners_3d()  # (..., 3, 8)
        corners_c = Tcw.rotation_matrix() @ corners_w + Tcw.trans[..., :, None]
        uvw = K @ corners_c
        uv = uvw[..., :2, :] / uvw[..., 2:3, :]
        top_left = torch.amin(uv, dim=-1)
        bottom_right = torch.amax(uv, dim=-1)
        center = 0.5 * (top_left + bottom_right)
        wh = bottom_right - top_left
        return torch.cat([center, wh], dim=-1)

    def astype(self, dtype) -> "Cuboid":
        return Cuboid(self.pose.astype(dtype), self.scale.to(dtype))

    def to(self, device) -> "Cuboid":
        return Cuboid(self.pose.to(device), self.scale.to(device))
