"""Point-feature front-end: Harris corners + ZNCC patch tracking.

The reference's point landmarks come from its ORB-SLAM2 integration (not in
its repository, but its g2o ships the mono point projection edges that
slam/point_ba covers).  This module is the feature front-end that feeds those
edges: batched Harris corner detection and zero-mean NCC patch tracking over
a search window, both fixed-shape (padded corner sets + masks), plus the
host-side slot bookkeeping of the interleaved KITTI driver.

Sums along an image axis (the box filters of Harris and of the ZNCC
candidate statistics) go through `_cumsum`, whose summation order is fixed:
the result is the same on the CPU and on the card, and equals the JAX
package's on the CPU bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cube_slam_wu_tpu_torch.ops import image as image_ops
from cube_slam_wu_tpu_torch.ops.detect import gaussian_blur5
from cube_slam_wu_tpu_torch.ops.topk import first_argmax, stable_top_k
from cube_slam_wu_tpu_torch.utils import hostsync

_SCAN_BLOCK = 16


def _seq_cumsum_last(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, added left to right."""
    cols = [a[..., 0]]
    for j in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., j])
    return torch.stack(cols, dim=-1)


def _cumsum_last(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in blocks of 16: a left-to-
    right sum inside each block, the block totals scanned the same way
    (recursively), each block's exclusive prefix added last.  This is the
    order in which XLA on the CPU evaluates a cumulative sum (its
    reduce-window rewrite with base length 16), so float sums round as there,
    and the order does not depend on the device."""
    n = a.shape[-1]
    if n <= _SCAN_BLOCK:
        return _seq_cumsum_last(a)
    m = -(-n // _SCAN_BLOCK)
    pad = m * _SCAN_BLOCK - n
    blocks = F.pad(a, (0, pad)).reshape(a.shape[:-1] + (m, _SCAN_BLOCK))
    inner = _seq_cumsum_last(blocks)
    outer = _cumsum_last(inner[..., -1])
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], dim=-1)
    return (inner + excl[..., None]).reshape(a.shape[:-1] + (m * _SCAN_BLOCK,))[..., :n]


def _cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    return _cumsum_last(a.movedim(dim, -1)).movedim(-1, dim)


def _box_blur(a: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box filter via separable cumsum differences."""
    for dim in (-2, -1):
        n = a.shape[dim]
        idx = torch.arange(n, device=a.device)
        lo = torch.clamp(idx - r, 0, n - 1)
        hi = torch.clamp(idx + r, 0, n - 1)
        c = _cumsum(a, dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        a = c.index_select(dim, hi + 1) - c.index_select(dim, lo)
    return a


def harris_corners(
    gray: torch.Tensor,
    max_corners: int = 256,
    k: float = 0.04,
    rel_threshold: float = 1e-5,
    border: int = 12,
):
    """Harris corner detection; returns (pts (K, 2) [x, y] float, mask (K,)).

    Standard pipeline: blurred Sobel products -> windowed structure tensor ->
    R = det - k*tr^2 -> 3x3 NMS -> top-K above rel_threshold * max(R).  Among
    equal responses the lower flat index comes first."""
    g = gaussian_blur5(gray)
    gx, gy = image_ops.sobel3(g)
    Ixx = _box_blur(gx * gx, 2)
    Iyy = _box_blur(gy * gy, 2)
    Ixy = _box_blur(gx * gy, 2)
    tr = Ixx + Iyy
    if gray.dtype == torch.float32:
        # R as two fused multiply-adds, fma(-k, tr^2, fma(Ixx, Iyy, -Ixy^2)),
        # each rounded once to float32 (evaluated through float64, where the
        # product of two float32 values is exact): how XLA on the CPU
        # contracts this expression, so NMS ties break as in the JAX package
        w = torch.float64
        det = (Ixx.to(w) * Iyy.to(w) + (-(Ixy * Ixy)).to(w)).to(torch.float32)
        k32 = torch.tensor(-k, dtype=torch.float32).item()
        R = (k32 * (tr * tr).to(w) + det.to(w)).to(torch.float32)
    else:
        R = (Ixx * Iyy - Ixy * Ixy) - k * (tr * tr)

    # 3x3 non-max suppression
    m = R
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
        m = torch.maximum(m, torch.roll(R, (dy, dx), dims=(-2, -1)))
    is_peak = (R >= m) & (R > rel_threshold * torch.amax(R))

    h, w = gray.shape
    ys = torch.arange(h, device=gray.device)[:, None]
    xs = torch.arange(w, device=gray.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(is_peak & inside, R, -torch.inf)
    vals, idx = stable_top_k(score.reshape(-1), max_corners)
    py = torch.div(idx, w, rounding_mode="floor").to(gray.dtype)
    px = (idx % w).to(gray.dtype)
    return torch.stack([px, py], dim=-1), torch.isfinite(vals) & (vals > 0)


def track_corners(
    gray_prev: torch.Tensor,
    gray_next: torch.Tensor,
    pts: torch.Tensor,
    mask: torch.Tensor,
    patch_radius: int = 4,
    search_radius: int = 24,
    min_zncc: float = 0.7,
):
    """Track corners by exhaustive ZNCC over a search window.

    Returns (new_pts (K, 2), tracked (K,), zncc (K,)).  Fully batched with
    no data-dependent control flow.  Each corner's (2(s+r)+1)^2 search window
    is gathered once (a direct 2-D gather of clamped rows and columns); the
    zero-meaned reference patch is correlated against it by one grouped VALID
    convolution (full float32: the package turns TF32 off), and the candidate
    means and norms come from box sums over the same window."""
    r, s = patch_radius, search_radius
    H, W = gray_prev.shape
    P = (2 * r + 1) ** 2
    dev = pts.device
    off_p = torch.arange(-r, r + 1, device=dev)
    dy = off_p[:, None].expand(2 * r + 1, 2 * r + 1).reshape(-1)
    dx = off_p[None, :].expand(2 * r + 1, 2 * r + 1).reshape(-1)  # (P,)

    x0 = torch.round(pts[:, 0]).to(torch.int64)
    y0 = torch.round(pts[:, 1]).to(torch.int64)

    yy = torch.clamp(y0[:, None] + dy[None, :], 0, H - 1)
    xx = torch.clamp(x0[:, None] + dx[None, :], 0, W - 1)
    ref = gray_prev[yy, xx]  # (K, P)
    ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    ref_n = torch.sqrt(torch.sum(ref * ref, dim=-1) + 1e-9)

    # per-corner search windows: (K, Wd, Wd), clamped at the image border
    wr = s + r
    Wd = 2 * wr + 1
    off = torch.arange(-wr, wr + 1, device=dev)
    wy = torch.clamp(y0[:, None] + off[None, :], 0, H - 1)  # (K, Wd)
    wx = torch.clamp(x0[:, None] + off[None, :], 0, W - 1)
    Kc = pts.shape[0]
    win = gray_next[wy[:, :, None], wx[:, None, :]]

    # Everything below runs on the WINDOW-MEAN-SUBTRACTED field: the raw
    # sum-of-squares form S2 - S1^2/P cancels catastrophically in float32 on
    # bright windows; after centering S2 is on the order of the variance.
    win0 = win - torch.mean(win, dim=(-2, -1), keepdim=True)

    # numerator: sum(ref * (cand - mean_cand)) per displacement == grouped
    # VALID correlation of the zero-meaned ref patch over the centered window,
    # minus the residual mean term (sum(ref) is only ~0 up to rounding)
    num = F.conv2d(
        win0[None], ref.reshape(Kc, 1, 2 * r + 1, 2 * r + 1), groups=Kc
    )[0]  # (K, D1, D1) with D1 = 2s+1

    def box_valid(a):  # (K, Wd, Wd) -> (K, D1, D1) sums over (2r+1)^2
        for dim in (-2, -1):
            c = _cumsum(a, dim)
            c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
            a = c.narrow(dim, 2 * r + 1, Wd - 2 * r) - c.narrow(dim, 0, Wd - 2 * r)
        return a

    s1 = box_valid(win0)
    s2 = box_valid(win0 * win0)
    ref_sum = torch.sum(ref, dim=-1)
    num = num - (s1 / P) * ref_sum[:, None, None]
    cand_var = torch.clamp(s2 - s1 * s1 / P, min=0.0)
    # a candidate variance below the cancellation noise floor of the
    # S2 - S1^2/P form is indistinguishable from an exactly flat patch, whose
    # true zncc is 0: zero those lanes instead of dividing the numerator's own
    # rounding residual by a vanishing norm.  The clip bounds the survivors.
    reliable = cand_var > 1e-5 * s2 + 1e-6
    cand_n = torch.sqrt(cand_var + 1e-9)
    zncc = torch.where(
        reliable,
        torch.clamp(num / (ref_n[:, None, None] * cand_n), -1.0, 1.0),
        0.0,
    ).reshape(Kc, -1)  # (K, D)

    D1 = 2 * s + 1
    off_s = torch.arange(-s, s + 1, device=dev)
    sy = off_s[:, None].expand(D1, D1).reshape(-1)
    sx = off_s[None, :].expand(D1, D1).reshape(-1)  # same row-major order as zncc
    best = first_argmax(zncc, dim=-1)
    best_zncc = torch.gather(zncc, -1, best[:, None])[:, 0]

    # sub-pixel peak: separable 3-point parabola fit on the zncc surface
    # around the argmax (clamped to +-0.5; skipped at window borders and on
    # degenerate curvature)
    bi = torch.div(best, D1, rounding_mode="floor")
    bj = best % D1

    def parab(idx_lo, idx_c, idx_hi, valid):
        z_lo = torch.gather(zncc, -1, idx_lo[:, None])[:, 0]
        z_c = torch.gather(zncc, -1, idx_c[:, None])[:, 0]
        z_hi = torch.gather(zncc, -1, idx_hi[:, None])[:, 0]
        denom = z_lo - 2.0 * z_c + z_hi
        ok = valid & (denom < -1e-9)
        sub = torch.where(ok, 0.5 * (z_lo - z_hi) / torch.where(ok, denom, -1.0), 0.0)
        return torch.clamp(sub, -0.5, 0.5)

    ii = torch.clamp(bi, 1, D1 - 2)
    jj = torch.clamp(bj, 1, D1 - 2)
    sub_y = parab((ii - 1) * D1 + bj, ii * D1 + bj, (ii + 1) * D1 + bj, bi == ii)
    sub_x = parab(bi * D1 + jj - 1, bi * D1 + jj, bi * D1 + jj + 1, bj == jj)

    new_x = (x0 + sx[best]).to(pts.dtype) + sub_x.to(pts.dtype)
    new_y = (y0 + sy[best]).to(pts.dtype) + sub_y.to(pts.dtype)
    inb = (new_x >= r) & (new_x < W - r) & (new_y >= r) & (new_y < H - r)
    tracked = mask & (best_zncc > min_zncc) & inb
    return torch.stack([new_x, new_y], dim=-1), tracked, best_zncc


class IncrementalTracker:
    """Host-side rolling feature tracker for the interleaved per-frame loop
    (slam.pipeline.run_kitti_frames): fixed P slots, ZNCC tracking frame to
    frame, dead slots REUSED by re-detection (the windowed point step clears
    a respawned slot's observation history, so reuse cannot mix landmarks).

    Per frame call `advance(gray, bboxes)` -> (pts (P, 2), alive (P,),
    respawned (P,), ground_hint (P,)) as numpy.  `gray` is the frame's float32
    image on the device; the slots' positions are float64 (the correlation
    runs in the image's dtype, the sub-pixel positions are kept exactly);
    `bboxes` are the frame's 2D detection corners
    [x0 y0 x1 y1] (or None): a corner inside any box belongs to an OBJECT, not
    the ground, so its slot gets no ground hint; ground hints also require the
    corner to sit below the horizon row.  Each device call (tracking,
    re-detection) comes back in one counted read."""

    def __init__(
        self,
        n_slots: int = 96,
        horizon_row: float | None = None,
        redetect_min_alive: float = 0.6,
        redetect_spacing: float = 8.0,
        **track_kwargs,
    ):
        self.P = n_slots
        self.pts = np.zeros((n_slots, 2))
        self.alive = np.zeros(n_slots, bool)
        self.ground = np.zeros(n_slots, bool)
        self.prev_gray = None
        self.horizon_row = horizon_row
        self.min_alive = int(redetect_min_alive * n_slots)
        self.spacing = redetect_spacing
        self.track_kwargs = track_kwargs

    def state(self) -> dict:
        return dict(feat_pts=self.pts, feat_alive=self.alive, feat_ground=self.ground)

    def load_state(self, data) -> None:
        if "feat_pts" in data:
            self.pts[:] = data["feat_pts"]
            self.alive[:] = data["feat_alive"]
            self.ground[:] = data["feat_ground"]

    def _hints(self, cand, bboxes):
        g = np.ones(len(cand), bool)
        if self.horizon_row is not None:
            g &= cand[:, 1] > self.horizon_row
        if bboxes is not None and len(bboxes):
            b = np.asarray(bboxes)
            inside = (
                (cand[:, 0:1] >= b[None, :, 0]) & (cand[:, 0:1] <= b[None, :, 2])
                & (cand[:, 1:2] >= b[None, :, 1]) & (cand[:, 1:2] <= b[None, :, 3])
            ).any(axis=1)
            g &= ~inside
        return g

    def advance(self, gray: torch.Tensor, bboxes=None):
        respawned = np.zeros(self.P, bool)
        if self.prev_gray is not None and self.alive.any():
            new_pts, tracked, _ = track_corners(
                self.prev_gray, gray,
                hostsync.push(self.pts, gray.device, torch.float64),
                hostsync.push(self.alive, gray.device), **self.track_kwargs,
            )
            new_pts, tracked = hostsync.pull((new_pts, tracked))
            self.pts = np.array(new_pts, np.float64)
            self.alive = np.array(tracked)
        elif self.prev_gray is None:
            self.alive[:] = False

        if self.alive.sum() < self.min_alive:
            fresh, fmask = hostsync.pull(harris_corners(gray, max_corners=self.P))
            fresh = np.asarray(fresh, np.float64)[np.asarray(fmask)]
            if self.alive.any() and len(fresh):
                d = np.linalg.norm(
                    fresh[:, None, :] - self.pts[None, self.alive, :], axis=-1
                ).min(axis=1)
                fresh = fresh[d > self.spacing]
            free = np.nonzero(~self.alive)[0]
            take = min(len(fresh), len(free))
            if take:
                slots = free[:take]
                self.pts[slots] = fresh[:take]
                self.alive[slots] = True
                respawned[slots] = True
                self.ground[slots] = self._hints(fresh[:take], bboxes)

        self.prev_gray = gray
        return (
            self.pts.copy(), self.alive.copy(), respawned,
            self.ground & self.alive,
        )


def build_point_tracks(
    grays,
    max_corners: int = 192,
    capacity: int | None = None,
    redetect_min_alive: int | None = None,
    redetect_spacing: float = 8.0,
    **track_kwargs,
):
    """Track Harris corners through a frame list, re-detecting as tracks die.

    grays: sequence of (H, W) image tensors (on one device).  Returns (obs_uv
    (F, C, 2), obs_mask (F, C)) as numpy with C = `capacity` (default
    2*max_corners).  When the live count drops below `redetect_min_alive`
    (default max_corners//2), new corners are detected in the current frame
    and appended into UNUSED slots (never reviving a dead slot, so each slot
    remains one physical landmark for triangulation); corners within
    `redetect_spacing` px of a live track are skipped.  Set
    redetect_min_alive=0 to disable."""
    capacity = capacity or 2 * max_corners
    if redetect_min_alive is None:
        redetect_min_alive = max_corners // 2

    n_frames = len(grays)
    obs_uv = np.zeros((n_frames, capacity, 2))
    obs_mask = np.zeros((n_frames, capacity), bool)

    pts0, mask0 = hostsync.pull(harris_corners(grays[0], max_corners=max_corners))
    n0 = min(int(mask0.sum()), capacity)
    cur = np.zeros((capacity, 2))
    alive = np.zeros(capacity, bool)
    cur[:n0] = pts0[mask0][:n0]
    alive[:n0] = True
    next_free = n0
    obs_uv[0], obs_mask[0] = cur.copy(), alive.copy()

    for f in range(1, n_frames):
        g = grays[f]
        cur_t, alive_t, _ = track_corners(
            grays[f - 1], g, hostsync.push(cur, g.device, torch.float64),
            hostsync.push(alive, g.device), **track_kwargs,
        )
        cur, alive = (np.array(a) for a in hostsync.pull((cur_t, alive_t)))
        cur = cur.astype(np.float64)
        if alive.sum() < redetect_min_alive and next_free < capacity:
            fresh, fmask = hostsync.pull(harris_corners(g, max_corners=max_corners))
            cand = np.asarray(fresh, np.float64)[fmask]
            if alive.any() and len(cand):
                d = np.linalg.norm(cand[:, None, :] - cur[None, alive, :], axis=-1).min(axis=1)
                cand = cand[d > redetect_spacing]
            take = min(len(cand), capacity - next_free)
            if take:
                cur[next_free : next_free + take] = cand[:take]
                alive[next_free : next_free + take] = True
                next_free += take
        obs_uv[f], obs_mask[f] = cur.copy(), alive.copy()
    return obs_uv, obs_mask
