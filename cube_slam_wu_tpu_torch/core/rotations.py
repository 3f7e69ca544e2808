"""Rotation parameterisations and conversions (batched, plain torch).

Semantics follow the reference's ZYX-euler conventions so that poses parsed
from its datasets round-trip identically (reference:
detect_3d_cuboid/src/matrix_utils.cpp:19-98).  All functions broadcast over
leading batch dimensions; quaternions are stored as (..., 4) in (w, x, y, z)
order.
"""

from __future__ import annotations

import functools
import math

import torch


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalise, flipping sign so w >= 0 (canonical double cover)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def device_constant(build):
    """Cache `build(*args)` per argument tuple (the last two are a dtype and a
    device): a constant tensor made once and shared, never written.

    On a card a tensor built from Python numbers is a host-to-device copy,
    which stalls the stream and which CUDA graph capture refuses, so a
    constant that a hot loop uses is made once.  It is built outside every
    `torch.func` transform, since a first call inside `jacfwd` would
    otherwise cache a wrapper of that transform's level."""

    @functools.cache
    def cached(*args):
        with torch._C._DisableFuncTorch():
            return build(*args)

    return functools.wraps(build)(cached)


@device_constant
def _conjugate_signs(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * _conjugate_signs(q.dtype, q.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    r = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) wxyz.

    Branch-free Shepperd method: compute all four candidate quaternions and
    select the numerically best (largest pivot), so it batches without
    data-dependent control flow.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidate (unnormalised) quaternions, one per pivot
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 pivots, 4)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = first_argmax(pivots)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)
    return quat_normalize(q[..., 0, :])


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmax that returns the LOWEST index among equal maxima (torch.argmax
    promises no order among ties)."""
    n = x.shape[dim]
    is_max = x == x.max(dim=dim, keepdim=True).values
    shape = [1] * x.ndim
    shape[dim] = n
    ids = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(is_max, ids, n).min(dim=dim).values.clamp(max=n - 1)


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmin that returns the LOWEST index among equal minima."""
    return first_argmax(-x, dim=dim)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Pure z-axis rotation quaternion (matches g2o_Object.h:107)."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


# ---------------------------------------------------------------------------
# ZYX euler conventions (reference matrix_utils.cpp:19-98)
# ---------------------------------------------------------------------------

def euler_zyx_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """ZYX euler (roll about x applied first) -> quaternion wxyz.

    Matches reference `zyx_euler_to_quat` (matrix_utils.cpp:19-33).
    """
    sy, cy = torch.sin(yaw * 0.5), torch.cos(yaw * 0.5)
    sp, cp = torch.sin(pitch * 0.5), torch.cos(pitch * 0.5)
    sr, cr = torch.sin(roll * 0.5), torch.cos(roll * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quat_to_euler_zyx(q: torch.Tensor):
    """Quaternion wxyz -> (roll, pitch, yaw) (matrix_utils.cpp:38-49)."""
    qw, qx, qy, qz = q.unbind(-1)
    roll = torch.atan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def euler_zyx_to_rot(roll, pitch, yaw) -> torch.Tensor:
    """ZYX euler -> rotation matrix (..., 3, 3) (matrix_utils.cpp:81-96)."""
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    sr, cr = torch.sin(roll), torch.cos(roll)
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    r = torch.stack(
        [
            cp * cy, (sr * sp * cy) - (cr * sy), (cr * sp * cy) + (sr * sy),
            cp * sy, (sr * sp * sy) + (cr * cy), (cr * sp * sy) - (sr * cy),
            -sp, sr * cp, cr * cp,
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_euler_zyx(R: torch.Tensor):
    """Rotation matrix -> (roll, pitch, yaw); regular branch only
    (matrix_utils.cpp:54-74 gimbal-lock branches are ~never hit in practice)."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# small angle helpers
# ---------------------------------------------------------------------------

def normalize_to_pi_half(angle: torch.Tensor) -> torch.Tensor:
    """Fold angle into (-pi/2, pi/2] by +-pi, like reference `normalize_to_pi`
    (matrix_utils.cpp:344-353; despite the name it folds to half-pi range)."""
    angle = torch.where(angle > math.pi / 2, angle - math.pi, angle)
    angle = torch.where(angle < -math.pi / 2, angle + math.pi, angle)
    return angle


def angle_dist_pi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min(|a-b|, pi-|a-b|): distance between undirected line angles."""
    d = torch.abs(a - b)
    return torch.minimum(d, math.pi - d)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Hat operator: (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))
