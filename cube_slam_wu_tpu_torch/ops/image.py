"""Batched image ops: grayscale, Sobel, Canny edges, exact distance transform.

Replacements for the OpenCV calls in the reference proposal engine
(`cv::Canny(gray(roi), 80, 200)` and `cv::distanceTransform(255-canny,
CV_DIST_L2, 3)`, detect_3d_cuboid/src/box_proposal_detail.cpp:322-327).
Differences by design:

- everything is fixed-shape; the ROI is handled by clamping coordinates
  (replicate-border semantics identical to running OpenCV on the cropped ROI)
  plus validity masks, not by dynamic crops;
- the distance transform is an *exact* Euclidean EDT (column pass + row-wise
  minimisation) rather than OpenCV's 3x3 chamfer approximation — exactness
  keeps proposal rankings stable;
- every function takes leading batch dimensions (one image per detection
  box), so the per-box loop is a batch axis.

The stencils are shifted adds, never library convolutions: on u8-valued
images they are exact integer arithmetic in float32.
"""

from __future__ import annotations

import torch

from cube_slam_wu_tpu_torch.ops.cuda_kernels import edt_row_min
from cube_slam_wu_tpu_torch.utils import hostsync


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB [0,255] -> rounded gray float (..., H, W).

    Uses the BT.601 weights OpenCV uses for CV_BGR2GRAY (the reference
    converts with cv::cvtColor, box_proposal_detail.cpp:82-86), with
    round-half-away like OpenCV's fixed-point path.
    """
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    gray = img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]
    return torch.floor(gray + 0.5)


def _as_index(v, device):
    return torch.as_tensor(v, device=device).to(torch.int64)


def replicate_roi(gray: torch.Tensor, x0, y0, x1, y1) -> torch.Tensor:
    """Fill the full-size buffer with the ROI [x0,x1]x[y0,y1] (inclusive),
    replicating the ROI border outward.  `gray` is (H, W); the bounds are
    scalars or (B,) tensors, giving (H, W) or (B, H, W).

    Filtering this buffer with any local stencil reproduces, inside the ROI,
    exactly what the same filter computes on the cropped ROI with
    BORDER_REPLICATE — which is how the reference runs Canny on
    `gray_img(object_bbox)` (box_proposal_detail.cpp:324).
    """
    h, w = gray.shape[-2:]
    dev = gray.device
    x0, y0, x1, y1 = (_as_index(v, dev) for v in (x0, y0, x1, y1))
    ys = torch.clamp(torch.arange(h, device=dev), y0[..., None], y1[..., None])
    xs = torch.clamp(torch.arange(w, device=dev), x0[..., None], x1[..., None])
    return gray[ys[..., :, None], xs[..., None, :]]


def _shifted(a: torch.Tensor, dim: int):
    """(a[i-1], a[i+1]) along `dim` with the border replicated."""
    n = a.shape[dim]
    lo = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)
    hi = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)
    return lo, hi


def sobel3(gray: torch.Tensor):
    """3x3 Sobel derivatives (replicate border). Returns (gx, gy)."""
    # separable: smooth [1 2 1], diff [-1 0 1]
    def smooth(a, dim):
        lo, hi = _shifted(a, dim)
        return 1.0 * lo + 2.0 * a + 1.0 * hi

    def diff(a, dim):
        lo, hi = _shifted(a, dim)
        return -1.0 * lo + 0.0 * a + 1.0 * hi

    gx = diff(smooth(gray, -2), -1)
    gy = diff(smooth(gray, -1), -2)
    return gx, gy


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Non-maximum suppression along the quantised gradient direction
    (OpenCV Canny sector logic: tan(22.5deg) boundaries)."""
    ax, ay = torch.abs(gx), torch.abs(gy)
    tg22 = 0.4142135623730950488  # tan(pi/8)
    # sector 0: |gy| < tan22*|gx|        -> horizontal gradient, compare L/R
    # sector 2: |gy| > tan(3pi/8)*|gx|   -> vertical gradient, compare U/D
    # else diagonal, sign picks which one
    horiz = ay < tg22 * ax
    vert = ay > (ax / tg22)
    diag_main = (~horiz) & (~vert) & (torch.sign(gx) == torch.sign(gy))
    # neighbours via roll (wraps at borders; harmless — the proposal path
    # only reads the map inside its ROI, whose border is replicate-padded)
    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), dims=(-2, -1))

    left, right = shift(mag, 0, 1), shift(mag, 0, -1)
    up, down = shift(mag, 1, 0), shift(mag, -1, 0)
    ul, dr = shift(mag, 1, 1), shift(mag, -1, -1)
    ur, dl = shift(mag, 1, -1), shift(mag, -1, 1)

    n1 = torch.where(horiz, left, torch.where(vert, up, torch.where(diag_main, ul, ur)))
    n2 = torch.where(horiz, right, torch.where(vert, down, torch.where(diag_main, dr, dl)))
    # OpenCV keeps a pixel if mag > n1 and mag >= n2 (breaks ties one-sided)
    return (mag > n1) & (mag >= n2)


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    """8-neighbour dilation of a bool mask (..., H, W), zeros outside."""
    mx = m.clone()
    mx[..., :, 1:] |= m[..., :, :-1]
    mx[..., :, :-1] |= m[..., :, 1:]
    out = mx.clone()
    out[..., 1:, :] |= mx[..., :-1, :]
    out[..., :-1, :] |= mx[..., 1:, :]
    return out


def canny(
    gray: torch.Tensor,
    low: float = 80.0,
    high: float = 200.0,
    max_hysteresis_iters: int = 256,
) -> torch.Tensor:
    """Canny edge mask (bool, same shape as gray), L1 gradient norm.

    Matches OpenCV `cv::Canny(img, low, high)` semantics (aperture 3,
    L2gradient=false): Sobel -> |gx|+|gy| -> direction-quantised NMS ->
    hysteresis by fixpoint dilation of strong edges through weak pixels.

    The hysteresis runs the constrained-dilation fixpoint on unpacked bool
    masks (the JAX package bit-packs them; the fixpoint is the same lattice,
    so the result is bit-equal).  Convergence is checked every 16 dilations;
    each check reads one flag on the host (counted by `utils.hostsync`).
    """
    gx, gy = sobel3(gray)
    mag = torch.abs(gx) + torch.abs(gy)
    keep = _nms(mag, gx, gy)
    strong = keep & (mag > high)
    weak = keep & (mag > low)

    edges = strong
    i = 0
    while i < max_hysteresis_iters:
        grown = edges
        for _ in range(16):
            grown = _dilate8(grown) & weak
        changed = hostsync.host_bool((grown != edges).any())
        edges = grown
        i += 16
        if not changed:
            break
    return edges



def _edt_1d_columns(edge: torch.Tensor) -> torch.Tensor:
    """Per-column distance (in rows) to the nearest edge pixel in that column.

    Exact min-plus DOUBLING instead of a sequential forward/backward scan:
    after step k, d[i] = min_{|j-i| < 2^k} (init[j] + |i-j|), so ceil(log2 h)
    whole-image steps replace 2·h dependent scan rows.  Values are exact
    small integers wherever a column edge is reachable and +inf-like where
    not.
    """
    h = edge.shape[-2]
    big = 1e9
    d = torch.where(
        edge,
        torch.zeros((), dtype=torch.float32, device=edge.device),
        torch.full((), big, dtype=torch.float32, device=edge.device),
    )

    off = 1
    while off < h:
        pad = torch.full_like(d[..., :off, :], big)
        up = torch.cat([pad, d[..., :-off, :]], dim=-2)  # d[i - off]
        dn = torch.cat([d[..., off:, :], pad], dim=-2)  # d[i + off]
        d = torch.minimum(d, torch.minimum(up, dn) + float(off))
        off *= 2
    return d


def distance_transform(edge: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance transform to the nearest True pixel.

    Two stages: per-column 1D distances g(x, y), then per-row exact
    minimisation D(y, x) = min_x' sqrt((x - x')^2 + g(x', y)^2), which is
    `ops.cuda_kernels.edt_row_min` (the CUDA kernel on the card, its plain
    version on the CPU).

    Pixels in images with no edges at all get a large finite value.
    """
    g = _edt_1d_columns(edge)  # (..., h, w) distance along columns
    g2 = torch.clamp(g, max=1e6) ** 2
    return edt_row_min(g2)


def roi_canny_distance_map(
    gray: torch.Tensor, x0, y0, x1, y1, low: float = 80.0, high: float = 200.0
) -> torch.Tensor:
    """Distance map used by proposal scoring: Canny on the (replicate-border)
    ROI [x0,x1]x[y0,y1] inclusive, then exact EDT to those edges, evaluated on
    the full-image grid (lookups are only valid inside the ROI).  With (B,)
    bounds it returns one map per box, (B, H, W), from one kernel launch.

    Mirrors box_proposal_detail.cpp:322-327 with absolute-coordinate lookups
    (the reference shifts corners into ROI coordinates; both index the same
    pixels since the ROI origin is integral).  Its host time splits into the
    `utils.hostsync` stages `proposals/canny` (with the hysteresis flag
    reads) and `proposals/edt`.
    """
    dev = gray.device
    with hostsync.stage("proposals/canny"):
        x0, y0, x1, y1 = (_as_index(v, dev) for v in (x0, y0, x1, y1))
        buf = replicate_roi(gray, x0, y0, x1, y1)
        edges = canny(buf, low=low, high=high)
    with hostsync.stage("proposals/edt"):
        ys = torch.arange(gray.shape[-2], device=dev)[:, None]
        xs = torch.arange(gray.shape[-1], device=dev)[None, :]
        b = lambda v: v[..., None, None]
        inside = (ys >= b(y0)) & (ys <= b(y1)) & (xs >= b(x0)) & (xs <= b(x1))
        return distance_transform(edges & inside)
