"""Reference of entry `kitti_points`: the fixed-lag camera-cuboid-point step
recomputed in float64 from the program's own state, frame by frame.

For each frame it follows, the reference takes the program's carry before
the frame and the step's input (plain arrays, see `STATE` and `INPUT`),
computes the whole windowed point step anew, and compares the result with
the program's carry after the frame.  Each frame starts from the program's
state, so the program's float32 rounding never accumulates here.

The step, written from the documented math (the program is not imported):
- the camera vertex is g2o's `VertexSE3Expmap` (world-to-camera, tangent
  [omega, upsilon], left update exp(d) * T); the cuboid vertex is the
  reference's `VertexCuboid` (object-to-world pose with a right update
  T * exp(d[:6]), half-extents plus d[6:]) (g2o_Object.h);
- insertion (main_obj.cpp:548-565): frame i's pose from constant velocity
  (T_{i-1} T_{i-2}^-1 T_{i-1}; frame 0 at the given first pose), the
  odometry edge T_{i-1} T_{i-2}^-1 with identity information, the
  camera-object edges (main_obj.cpp:762-782) with sqrt-information 2 q,
  where the quality q is first divided by 1 + alpha |e| (the soft
  innovation gate, alpha = 2, e the 9-d error of the measurement at the
  predicted pose against the landmark), and a landmark's vertex set from
  its first measurement;
- the camera-object error (g2o_Object.h:76-101): the 9-d error [log(m^-1
  c), c.s - m.s] of landmark c against the measurement m in the world, the
  least of the four front faces of m (m turned by -90, 0, 90, 180 deg about
  its z axis, half-extents swapped at +-90); a face a half turn (within
  0.01 rad) from c counts at least its turn;
- the fixed-lag prior: when frame i - W leaves the window, each of its
  camera-object edges whose error at the linearisation point is under 3
  becomes a unary Gaussian factor on its landmark, linearised once (at the
  landmark's estimate on its first absorption, at the prior's point after),
  its Jacobian scaled so that no entry exceeds 100 (information 1e4);
- points: the frame's observations recorded, respawned slots forgotten;
  slots with no estimate and >= 3 observations in the window triangulated
  by DLT (Hartley & Zisserman 12.2) and kept when every observation
  reprojects within 8 px, the point lies 0.1 m in front of every observing
  camera and within 60 m of the newest window camera; ground-hinted slots
  that fail lifted from their newest ray onto z = 0; every observation
  reprojecting beyond 8 px dropped, and a point that loses all of them (of
  >= 3) demoted;
- the joint solve over the window: odometry, camera-object and prior
  factors, and pinhole reprojection (EdgeSE3ProjectXYZ,
  types_six_dof_expmap.h:145-175) with weight 0.3 and a 2-px Huber
  kernel (g2o RobustKernelHuber as a sqrt weight); the window's first pose
  fixed (`fix_first`); 5 Levenberg-Marquardt iterations with g2o's damping
  (optimization_algorithm_levenberg.cpp): lambda_0 = 1e-5 max diag of the
  camera and cuboid block, a step taken when the gain ratio is positive,
  lambda *= max(1/3, 1 - (2 rho - 1)^3) on a taken step, else lambda *=
  nu, nu doubling.

How it departs from the program's formulation (the same math, computed
otherwise): rotations are 3x3 matrices, not quaternions; the Jacobian is
one dense forward-mode derivative of the whole stacked residual vector,
and the normal equations are one dense solve (no Schur reduction over the
points, no closed-form point Jacobian); each front face is fixed at the
linearisation point of an iteration, and a step's error is judged with the
least face, as the documented LM takes them; the DLT takes the smallest
right singular vector of the stacked rows (an SVD of A, not an eigenvector
of A^T A); the SO(3) log takes its angle from atan2 and its small-angle
coefficients from series; the prior's factor is the Cholesky square root of
its information plus 1e-9 I, its offset L^-1 b.

The numbers, in percent, are shares of items with no counterpart within a
tolerance far above float32 rounding, but far below a wrong step:
- `pose_miss_pct`: the window's poses after the step (frames in the
  window), position within `POS_TOL_M` and rotation within `ROT_TOL_RAD`;
- `cube_miss_pct`: landmarks valid on either side, validity alike, centre
  within `CUBE_TOL_M`, half-extents within `CUBE_TOL_M`, yaw within
  `YAW_TOL_RAD`;
- `point_miss_pct`: points valid on either side, validity alike and
  position within `POINT_TOL_M`;
and, as an outcome check against the world's ground truth, `ate_m`: the
RMSE of the counted frames' camera centres, each the pose the program
delivered for its frame right after the frame's step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Tolerances, set from the per-item deviations of one whole 80-frame session
# on the card (H100; PERF.md section 2).  The program's float32 step parts
# from float64 by at most 6.6e-4 m and 5.4e-4 rad on a pose, 3.7e-4 m on a
# landmark, 2.0e-4 rad in yaw; its points have a heavy tail (99th
# percentile 2.6 mm, 0.29 % beyond 2 cm: short-baseline tracks whose depth
# float32 cannot pin).  The control (TF32 products, a bfloat16 blur) parts
# beyond these tolerances on 12.8 % of its poses, 5.2 % of its landmarks and
# 5.3 % of its points.
POS_TOL_M = 1e-3  # camera centres: 1.5x the program's largest deviation
ROT_TOL_RAD = 1e-3  # camera rotations: 1.9x the program's largest
CUBE_TOL_M = 1e-3  # landmark centres and half-extents: 2.7x the program's largest
YAW_TOL_RAD = 1e-3  # landmark yaw: 5x the program's largest
POINT_TOL_M = 2e-2  # points: 7.7x the program's 99th percentile

# the step's constants (the program's documented defaults)
SOFT_GATE_ALPHA = 2.0
ABSORB_GATE = 3.0
INFO_CAP = 1e4
PRIOR_EPS = 1e-9
MIN_OBS = 3
REPROJ_GATE_PX = 8.0
POINT_HUBER_PX = 2.0
MAX_POINT_RANGE_M = 60.0
FACE_ANGLES = (-math.pi / 2, 0.0, math.pi / 2, math.pi)

# the arrays of a state and of a step's input (F frames, O landmarks, P points;
# quaternions w x y z)
STATE = ("cam_q", "cam_t", "frame_mask", "odom_q", "odom_t", "odom_mask", "cube_q", "cube_t",
         "cube_s", "cube_valid", "meas_q", "meas_t", "meas_s", "meas_w", "meas_mask",
         "bbox_mask", "prior_H", "prior_b", "prior_lin_q", "prior_lin_t", "prior_lin_s",
         "prior_valid", "obs_uv", "obs_mask", "points", "point_valid")
INPUT = ("meas_q", "meas_t", "meas_s", "quality", "has_meas", "active", "bbox_weight",
         "first_q", "first_t", "obs", "obs_mask", "respawned", "ground")


# -- rotations and rigid motions (matrices) ----------------------------------

def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def quat_to_R(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def Rz(a, like):
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=like.dtype,
                        device=like.device)


def se3_exp(xi):
    """[omega, upsilon] -> (R, t): R = I + a W + b W^2, t = (I + b W + c W^2) upsilon."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, -1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th ** 3))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, (V @ v[..., None])[..., 0]


def so3_angle(R):
    """Rotation angle in [0, pi]."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.atan2(torch.linalg.norm(vee, dim=-1) / 2, (tr - 1) / 2)


def se3_log(R, t):
    """(R, t) -> [omega, V^-1 t], theta = atan2(|vee|/2, (tr - 1)/2)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    s2 = torch.sum(vee * vee, -1) / 4  # sin^2
    c = (tr - 1) / 2
    small = (s2 < 1e-8) & (c > 0)
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    th = torch.atan2(s, c)
    # small angles: theta^2 = sin^2 to the series' order
    k = torch.where(small, 0.5 + s2 / 12, th / (2 * torch.clamp(s, min=1e-300)))
    w = k[..., None] * vee
    th_s = torch.where(small, torch.ones_like(th), th)
    coef = torch.where(small, 1 / 12 + s2 / 720,
                       (1 - th_s / (2 * torch.tan(th_s / 2))) / (th_s * th_s))
    W = hat(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def compose(A, B):
    return A[0] @ B[0], (A[0] @ B[1][..., None])[..., 0] + A[1]


def inverse(A):
    Rt = A[0].transpose(-1, -2)
    return Rt, -(Rt @ A[1][..., None])[..., 0]


def apply(A, X):
    return (A[0] @ X[..., None])[..., 0] + A[1]


# -- cuboids: (R, t, half-extents) -------------------------------------------

def faces(m):
    """The four front faces of cuboid(s) m: (R (..., 4, 3, 3), t, s)."""
    R = torch.stack([m[0] @ Rz(a, m[0]) for a in FACE_ANGLES], -3)
    swap = m[2][..., [1, 0, 2]]
    s = torch.stack([swap, m[2], swap, m[2]], -2)
    return R, m[1][..., None, :].expand(R.shape[:-1]), s


def log_error(c, m):
    """[log(m^-1 c), c.s - m.s]."""
    d = compose(inverse((m[0], m[1])), (c[0], c[1]))
    return torch.cat([se3_log(*d), c[2] - m[2]], -1)


def face_choice(c, m):
    """The front face of m that the least error takes (first of equals)."""
    fR, ft, fs = faces(m)
    c4 = (c[0][..., None, :, :].expand(fR.shape), c[1][..., None, :].expand(ft.shape),
          c[2][..., None, :].expand(fs.shape))
    norms = torch.linalg.norm(log_error(c4, (fR, ft, fs)), dim=-1)
    turn = so3_angle(fR.transpose(-1, -2) @ c4[0])
    norms = torch.where(turn > math.pi - 0.01, torch.maximum(norms, turn), norms)
    ids = torch.arange(4, device=norms.device)
    return torch.where(norms == norms.amin(-1, keepdim=True), ids, 4).amin(-1)


def face_error(c, m, choice):
    """The error against front face `choice` of m."""
    fR, ft, fs = faces(m)
    k = choice[..., None, None]
    R = torch.gather(fR, -3, k[..., None].expand(choice.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ft, -2, k.expand(choice.shape + (1, 3)))[..., 0, :]
    sc = torch.gather(fs, -2, k.expand(choice.shape + (1, 3)))[..., 0, :]
    return log_error(c, (R, t, sc))


def least_error(c, m):
    return face_error(c, m, face_choice(c, m))


def to_world(Twc, m):
    R, t = compose(Twc, (m[0], m[1]))
    return R, t, m[2]


def right_update(c, d):
    R, t = compose((c[0], c[1]), se3_exp(d[..., :6]))
    return R, t, c[2] + d[..., 6:]


# -- the step ---------------------------------------------------------------

def _t(a, dev, dtype=torch.float64):
    a = np.asarray(a)
    return torch.as_tensor(a, device=dev, dtype=torch.bool if a.dtype == bool else dtype)


def load_state(st: dict, dev) -> dict:
    out = {k: _t(st[k], dev) for k in STATE}
    for k in ("cam", "odom", "cube", "meas", "prior_lin"):
        out[k + "_R"] = quat_to_R(out.pop(k + "_q"))
    return out


def _insert(s, inp, i):
    """Frame i into the graph: pose, odometry, cuboid edges, new vertices."""
    cam = (s["cam_R"], s["cam_t"])
    dev = cam[0].device
    eye = torch.eye(3, dtype=cam[0].dtype, device=dev)
    zero3 = torch.zeros(3, dtype=cam[0].dtype, device=dev)
    if i > 1:
        odom = compose((cam[0][i - 1], cam[1][i - 1]), inverse((cam[0][i - 2], cam[1][i - 2])))
    else:
        odom = (eye, zero3)
    first = (quat_to_R(inp["first_q"]), inp["first_t"])
    prev = (cam[0][max(i - 1, 0)], cam[1][max(i - 1, 0)])
    curr = inverse(first) if i == 0 else compose(odom, prev)
    Twc = inverse(curr)
    meas = (quat_to_R(inp["meas_q"]), inp["meas_t"], inp["meas_s"])
    mw = to_world(Twc, meas)
    cube = (s["cube_R"], s["cube_t"], s["cube_s"])
    innov = torch.linalg.norm(least_error(cube, mw), dim=-1)
    q = inp["quality"]
    if i > 0:
        q = torch.where(s["cube_valid"], q / (1 + SOFT_GATE_ALPHA * innov), q)
    n = dict(s)
    act = bool(inp["active"])
    has = inp["has_meas"] & act
    n["cam_R"], n["cam_t"] = cam[0].clone(), cam[1].clone()
    n["cam_R"][i], n["cam_t"][i] = curr
    n["frame_mask"] = s["frame_mask"].clone()
    n["frame_mask"][i] = act
    n["odom_R"], n["odom_t"] = s["odom_R"].clone(), s["odom_t"].clone()
    n["odom_R"][i], n["odom_t"][i] = odom
    n["odom_mask"] = s["odom_mask"].clone()
    n["odom_mask"][i] = act and i > 0
    for k, v in (("meas_R", meas[0]), ("meas_t", meas[1]), ("meas_s", meas[2]), ("meas_w", 2 * q),
                 ("meas_mask", has)):
        n[k] = s[k].clone()
        n[k][i] = v
    if bool((inp["bbox_weight"] > 0).any()) or bool(s["bbox_mask"].any()):
        raise ValueError("the reference has no 2D box edges (bbox_edge_weight 0)")
    new = ~s["cube_valid"] & has
    n["cube_R"] = torch.where(new[:, None, None], mw[0], s["cube_R"])
    n["cube_t"] = torch.where(new[:, None], mw[1], s["cube_t"])
    n["cube_s"] = torch.where(new[:, None], mw[2], s["cube_s"])
    n["cube_valid"] = s["cube_valid"] | new
    return n


def _absorb(n, i, W):
    """The prior after frame i - W leaves the window (unchanged before)."""
    O = n["cube_valid"].shape[0]
    H, b, valid = n["prior_H"], n["prior_b"], n["prior_valid"]
    lin = (n["prior_lin_R"], n["prior_lin_t"], n["prior_lin_s"])
    if i >= W:
        d = i - W
        mask = n["meas_mask"][d]
        w = n["meas_w"][d]
        Twc = inverse((n["cam_R"][d], n["cam_t"][d]))
        mw = to_world(Twc, (n["meas_R"][d], n["meas_t"][d], n["meas_s"][d]))
        first = mask & ~valid
        est = (n["cube_R"], n["cube_t"], n["cube_s"])
        lin = tuple(torch.where(first.reshape((O,) + (1,) * (e.dim() - 1)), e, p)
                    for e, p in zip(est, lin))
        choice = face_choice(lin, mw)

        def f(dv):
            return w[:, None] * face_error(right_update(lin, dv), mw, choice)

        zero = torch.zeros((O, 9), dtype=w.dtype, device=w.device)
        r0 = f(zero)
        Jfull = torch.func.jacfwd(f)(zero)  # (O, 9, O, 9)
        J = torch.stack([Jfull[o, :, o, :] for o in range(O)])
        innov = torch.linalg.norm(r0, dim=-1) / torch.clamp(w, min=1e-9)
        gate = mask & (w > 0) & (innov < ABSORB_GATE)
        jmax = J.abs().amax(dim=(-2, -1))
        k = gate * torch.clamp(math.sqrt(INFO_CAP) / torch.clamp(jmax, min=1e-12), max=1.0)
        J, r0 = J * k[:, None, None], r0 * k[:, None]
        H = H + J.transpose(-1, -2) @ J
        b = b + (J.transpose(-1, -2) @ r0[..., None])[..., 0]
        valid = valid | gate
    eye = torch.eye(9, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H + PRIOR_EPS * eye)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    c = torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
    S = torch.where(valid[:, None, None], L.transpose(-1, -2), 0.0)
    c = torch.where(valid[:, None], c, 0.0)
    return dict(H=H, b=b, S=S, c=c, lin=lin, valid=valid)


def _project(Tcw, X, K):
    pc = apply(Tcw, X)
    z = torch.clamp(pc[..., 2], min=1e-9)
    return torch.stack([K[0, 0] * pc[..., 0] / z + K[0, 2], K[1, 1] * pc[..., 1] / z + K[1, 2]], -1)


def _triangulate(Tcw, uv, mask, K):
    """DLT per point: the smallest right singular vector of the stacked rows
    u p3 - p1, v p3 - p2 of its observing frames."""
    Pm = K @ torch.cat([Tcw[0], Tcw[1][..., None]], -1)  # (W, 3, 4)
    u, v = uv[..., 0], uv[..., 1]
    rows = torch.stack([u[..., None] * Pm[:, None, 2] - Pm[:, None, 0],
                        v[..., None] * Pm[:, None, 2] - Pm[:, None, 1]], 2)  # (W, P, 2, 4)
    rows = torch.where(mask[..., None, None], rows, 0.0)
    A = rows.permute(1, 0, 2, 3).reshape(uv.shape[1], -1, 4)
    Xh = torch.linalg.svd(A).Vh[:, -1]
    w = Xh[:, 3]
    X = Xh[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))[:, None]
    z = apply((Tcw[0][:, None], Tcw[1][:, None]), X[None])[..., 2]
    ok = ((mask.sum(0) >= 2) & torch.where(mask, z > 0.1, True).all(0)
          & torch.isfinite(X).all(-1))
    return X, ok


def _points(n, inp, i, s0, W, K):
    """Observations recorded; triangulation, ground bootstrap, gate, demotion."""
    omask = n["obs_mask"] & ~inp["respawned"][None]
    omask[i] = inp["obs_mask"] & bool(inp["active"])
    ouv = n["obs_uv"].clone()
    ouv[i] = inp["obs"]
    pvalid = n["point_valid"] & ~inp["respawned"]
    sl = slice(s0, s0 + W)
    Tw = (n["cam_R"][sl], n["cam_t"][sl])
    uv_w, m_w = ouv[sl], omask[sl] & n["frame_mask"][sl][:, None]
    P = pvalid.shape[0]
    n_obs = m_w.sum(0)
    fresh = ~pvalid & (n_obs >= MIN_OBS)
    X_new, tri_ok = _triangulate(Tw, uv_w, m_w, K)

    def err(X):
        return torch.linalg.norm(_project((Tw[0][:, None], Tw[1][:, None]), X[None], K) - uv_w,
                                 dim=-1)

    newest_C = inverse((Tw[0][W - 1], Tw[1][W - 1]))[1]
    accept = (fresh & tri_ok & torch.where(m_w, err(X_new) < REPROJ_GATE_PX, True).all(0)
              & (torch.linalg.norm(X_new - newest_C, dim=-1) < MAX_POINT_RANGE_M))
    rows = torch.arange(W, device=pvalid.device)[:, None].expand(W, P)
    last = torch.where(m_w, rows, -1).amax(0)
    r = last.clamp(0, W - 1)
    Twc = inverse((Tw[0][r], Tw[1][r]))
    uv_last = uv_w[r, torch.arange(P, device=pvalid.device)]
    ray = torch.linalg.solve(K, torch.cat([uv_last, torch.ones_like(uv_last[:, :1])], -1).T).T
    d = (Twc[0] @ ray[..., None])[..., 0]
    C = Twc[1]
    dz = d[:, 2]
    t_hit = -C[:, 2] / torch.where(dz.abs() > 1e-6, dz, torch.full_like(dz, -1e-6))
    ground = (fresh & ~accept & inp["ground"] & (last >= 0) & (dz < -0.02) & (t_hit > 0.5)
              & (t_hit < MAX_POINT_RANGE_M) & (C[:, 2] > 0.2))
    X = torch.where(accept[:, None], X_new, n["points"])
    X = torch.where(ground[:, None], C + t_hit[:, None] * d, X)
    pvalid = pvalid | accept | ground
    ok = m_w & pvalid[None] & (err(X) < REPROJ_GATE_PX)
    pvalid = pvalid & ~(pvalid & (n_obs >= 3) & (ok.sum(0) == 0))
    return dict(obs_uv=ouv, obs_mask=omask, points=X, point_valid=pvalid, obs_ok=ok & pvalid[None])


def _huber(r, delta):
    nrm = torch.sqrt(torch.sum(r * r, -1, keepdim=True) + 1e-24)
    return r * torch.sqrt(torch.clamp(delta / nrm, max=1.0))


class _Window:
    """The window's least-squares problem over x = [cameras (W, 6), cuboids
    (O, 9), points (P, 3)]."""

    def __init__(self, n, prior, pts, s0, W, K, point_weight):
        sl = slice(s0, s0 + W)
        self.cam = (n["cam_R"][sl], n["cam_t"][sl])
        self.cube = (n["cube_R"], n["cube_t"], n["cube_s"])
        self.X = pts["points"]
        self.fm = n["frame_mask"][sl]
        self.om = n["odom_mask"][sl].clone()
        self.om[0] = False  # the first odometry edge reaches outside the window
        self.odom = (n["odom_R"][sl], n["odom_t"][sl])
        self.meas = (n["meas_R"][sl], n["meas_t"][sl], n["meas_s"][sl])
        self.mw = n["meas_w"][sl]
        self.mm = n["meas_mask"][sl] & self.fm[:, None] & n["cube_valid"][None]
        self.cv = n["cube_valid"]
        self.prior = prior
        self.uv, self.ok = pts["obs_uv"][sl], pts["obs_ok"]
        self.pv = pts["point_valid"]
        self.K, self.w = K, point_weight
        self.W, self.O, self.P = W, self.cv.shape[0], self.pv.shape[0]
        dt, dev = K.dtype, K.device
        free_cam = self.fm & (torch.arange(W, device=dev) > 0)  # the first pose is fixed
        self.gate = torch.cat([free_cam.to(dt).repeat_interleave(6),
                               self.cv.to(dt).repeat_interleave(9),
                               self.pv.to(dt).repeat_interleave(3)])
        self.nc = 6 * W + 9 * self.O

    def moved(self, x):
        x = x * self.gate
        W, O, P = self.W, self.O, self.P
        dc = x[:6 * W].reshape(W, 6)
        dq = x[6 * W:6 * W + 9 * O].reshape(O, 9)
        dp = x[6 * W + 9 * O:].reshape(P, 3)
        return compose(se3_exp(dc), self.cam), right_update(self.cube, dq), self.X + dp

    def edges(self, cam, cube):
        """(cube_b (W, O), meas in the world (W, O)) of the camera-object edges."""
        W, O = self.W, self.O
        Twc = inverse(cam)
        Twc_b = (Twc[0][:, None].expand(W, O, 3, 3), Twc[1][:, None].expand(W, O, 3))
        mw = to_world(Twc_b, self.meas)
        cb = (cube[0][None].expand(W, O, 3, 3), cube[1][None].expand(W, O, 3),
              cube[2][None].expand(W, O, 3))
        return cb, mw

    def residuals(self, x, choice=None):
        cam, cube, X = self.moved(x)
        W = self.W
        prev = (cam[0][[0] + list(range(W - 1))], cam[1][[0] + list(range(W - 1))])
        e = compose(compose(self.odom, prev), inverse(cam))
        r_odom = torch.where(self.om[:, None], se3_log(*e), 0.0)
        cb, mw = self.edges(cam, cube)
        err = least_error(cb, mw) if choice is None else face_error(cb, mw, choice)
        r_cube = torch.where(self.mm[..., None], self.mw[..., None] * err, 0.0)
        pr = self.prior
        d = log_error(cube, pr["lin"])
        r_prior = torch.where(pr["valid"][:, None], (pr["S"] @ d[..., None])[..., 0] + pr["c"], 0.0)
        proj = _project((cam[0][:, None], cam[1][:, None]), X[None], self.K)
        r_pt = torch.where(self.ok[..., None], self.w * _huber(self.uv - proj, POINT_HUBER_PX), 0.0)
        return torch.cat([r_odom.reshape(-1), r_cube.reshape(-1), r_prior.reshape(-1),
                          r_pt.reshape(-1)])

    def choice(self):
        cb, mw = self.edges(self.cam, self.cube)
        return face_choice(cb, mw)

    def take(self, x):
        self.cam, self.cube, self.X = self.moved(x)


def _lm(prob, iterations):
    """Levenberg-Marquardt with g2o's damping; returns the accepted count."""
    n = prob.gate.shape[0]
    dt, dev = prob.K.dtype, prob.K.device
    zero = torch.zeros(n, dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    lam, nu, accepted = None, 2.0, 0
    for _ in range(iterations):
        ch = prob.choice()
        f = lambda x: prob.residuals(x, ch)  # noqa: E731
        r0 = f(zero)
        J = torch.func.jacfwd(f)(zero)
        H, g = J.T @ J, J.T @ r0
        chi2 = float(r0 @ r0)
        if lam is None:
            lam = max(1e-5 * float(torch.diagonal(H)[:prob.nc].abs().max()), 1e-12)
        dx = -torch.linalg.solve(H + lam * eye, g)
        r1 = prob.residuals(dx)
        chi2_new = float(r1 @ r1)
        pred = float(dx @ (lam * dx - g))
        rho = (chi2 - chi2_new) / max(abs(pred), 1e-30)
        if rho > 0 and math.isfinite(chi2_new):
            prob.take(dx)
            lam *= max(1 / 3, 1 - (2 * rho - 1) ** 3)
            nu = 2.0
            accepted += 1
        else:
            lam *= nu
            nu *= 2
    return accepted


def step(before: dict, inp: dict, i: int, K, window: int, iterations: int, point_weight: float,
         device="cpu") -> dict:
    """The windowed point step in float64: the state after frame i (the
    window's poses, the landmarks and their validity, the points and their
    validity, where the window starts, and the LM's accepted count)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = load_state(before, device)
        x = {k: _t(inp[k], device) for k in INPUT}
        Kt = _t(K, device)
        n = _insert(s, x, i)
        prior = _absorb(n, i, window)
        F = n["frame_mask"].shape[0]
        s0 = min(max(i - window + 1, 0), F - window)
        pts = _points(n, x, i, s0, window, Kt)
        prob = _Window(n, prior, pts, s0, window, Kt, point_weight)
        accepted = _lm(prob, iterations)
        cam_R, cam_t = n["cam_R"].clone(), n["cam_t"].clone()
        cam_R[s0:s0 + window], cam_t[s0:s0 + window] = prob.cam
        return dict(start=s0, cam_R=cam_R, cam_t=cam_t, frame_mask=n["frame_mask"],
                    cube_R=prob.cube[0], cube_t=prob.cube[1], cube_s=prob.cube[2],
                    cube_valid=n["cube_valid"], points=prob.X, point_valid=pts["point_valid"],
                    prior_valid=prior["valid"], accepted=accepted)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- the comparison ---------------------------------------------------------

def _yaw(R):
    return np.arctan2(R[..., 1, 0], R[..., 0, 0])


def _gap(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def frame_misses(ref: dict, after: dict, window: int) -> dict:
    """(misses, items) of each number for one frame: the reference's state
    `ref` against the program's state `after` (plain arrays)."""
    h = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in ref.items()}
    a = {k: np.asarray(after[k]) for k in after}
    sl = slice(h["start"], h["start"] + window)
    aR = quat_to_R(torch.as_tensor(a["cam_q"][sl], dtype=torch.float64)).numpy()
    at = a["cam_t"][sl].astype(np.float64)
    rR, rt = h["cam_R"][sl], h["cam_t"][sl]
    live = a["frame_mask"][sl] | h["frame_mask"][sl]
    Ca = -np.einsum("fji,fj->fi", aR, at)
    Cr = -np.einsum("fji,fj->fi", rR, rt)
    rot = np.arccos(np.clip((np.einsum("fji,fjk->fik", aR, rR).trace(axis1=1, axis2=2) - 1) / 2,
                            -1.0, 1.0))
    pose_bad = (np.linalg.norm(Ca - Cr, axis=-1) > POS_TOL_M) | (rot > ROT_TOL_RAD)
    pose_bad |= a["frame_mask"][sl] != h["frame_mask"][sl]
    out = {"pose": (int((pose_bad & live).sum()), int(live.sum()))}

    cq = quat_to_R(torch.as_tensor(a["cube_q"], dtype=torch.float64)).numpy()
    va, vr = a["cube_valid"], h["cube_valid"]
    either = va | vr
    cube_bad = ((va != vr)
                | (np.linalg.norm(a["cube_t"] - h["cube_t"], axis=-1) > CUBE_TOL_M)
                | (np.abs(a["cube_s"] - h["cube_s"]).max(-1) > CUBE_TOL_M)
                | (_gap(_yaw(cq), _yaw(h["cube_R"])) > YAW_TOL_RAD))
    out["cube"] = (int((cube_bad & either).sum()), int(either.sum()))

    pa, pr = a["point_valid"], h["point_valid"]
    either = pa | pr
    pt_bad = (pa != pr) | (np.linalg.norm(a["points"] - h["points"], axis=-1) > POINT_TOL_M)
    out["point"] = (int((pt_bad & either).sum()), int(either.sum()))
    return out


def followed(ctx, frames) -> list:
    """The produced frames the reference follows: those counted in the window
    (every produced frame where the run had no timed window)."""
    window = getattr(ctx, "window", None)
    if window is None:
        return list(frames)
    counted = set(window.counted())
    return [f for f in frames if f["k"] in counted]


def ate(ctx, frames) -> float:
    """RMSE of the frames' camera centres against the world's."""
    T_wc = np.asarray(ctx.world.T_wc, np.float64)
    err = []
    for f in frames:
        T = np.asarray(f["Tcw"], np.float64)
        C = -T[:3, :3].T @ T[:3, 3]
        err.append(np.linalg.norm(C - T_wc[f["i"], :3, 3]))
    return float(np.sqrt(np.mean(np.square(err)))) if err else float("nan")


def readings(ctx, frames) -> tuple:
    """(each number, the frames with a miss, the frames compared)."""
    s = ctx.settings
    dev = ctx.device
    follow = followed(ctx, frames)
    miss, total, frames_missed = {}, {}, 0
    for f in follow:
        ref = step(f["before"], f["input"], f["i"], f["K"], s["window"], s["iterations"],
                   s["point_weight"], dev)
        per = frame_misses(ref, f["after"], s["window"])
        frames_missed += any(m for m, _ in per.values())
        for k, (m, n) in per.items():
            miss[k] = miss.get(k, 0) + m
            total[k] = total.get(k, 0) + n
    values = {f"{k}_miss_pct": 100.0 * miss[k] / max(total[k], 1) for k in miss}
    values["ate_m"] = ate(ctx, follow)
    return values, frames_missed, len(follow)
