"""Line-Band-Descriptor (LBD) float descriptors and their L2 matcher: the part
of the JAX package's ops/lbd.py that the KITTI driver's line-track weighting
runs.

Batched re-design of the reference's descriptor stack
(line_lbd/libs/binary_descriptor.cpp:1150-1515 `computeLBD`):

- 9 bands x width 7 line-support region sampled along/perpendicular to the
  line, gradients projected on the line direction dL and its clockwise
  orthogonal dO, positive/negative parts split,
- per-row global Gaussian weight (sigma = halfHeight), per-band local
  Gaussian spill into the two neighbouring bands (sigma = (2w+1)/2),
- band means/stds with 1/(2w) edge-band and 1/(3w) inner-band normalisers,
- two-stage normalisation (means and stds separately), 0.4 clipping,
  re-normalisation -> 72-float descriptor.

The binary codes, the Hamming matchers and the reference-exact sampling path
of the JAX module are not part of this port yet.
"""

from __future__ import annotations

import torch

NUM_BANDS = 9
BAND_WIDTH = 7


def _gauss_coefs(dtype, device="cpu"):
    """Local (3w) and global (9w) Gaussian weights
    (binary_descriptor.cpp:147-177; note the integer divisions)."""
    w = BAND_WIDTH
    u_l = (w * 3 - 1) // 2
    sigma_l = (w * 2 + 1) // 2
    i = torch.arange(w * 3, dtype=dtype, device=device)
    coef_l = torch.exp(-((i - u_l) ** 2) / (2.0 * sigma_l * sigma_l))
    n = NUM_BANDS * w
    u_g = (n - 1) // 2
    sigma_g = u_g
    j = torch.arange(n, dtype=dtype, device=device)
    coef_g = torch.exp(-((j - u_g) ** 2) / (2.0 * sigma_g * sigma_g))
    return coef_l, coef_g


_GRAD_BIAS = 1020.0  # |3x3 Sobel of a u8 image| <= 4*255
_GRAD_SCALE = 2048.0  # bias*2*scale + bias*2 = 4.18M < 2^24: exact in f32


def _pack_gradients(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Pack the two INTEGER-VALUED gradient maps into one float32 so each
    descriptor sample costs one gather instead of two.

    Contract: gx and gy hold integers in [-1020, 1020] (the 3x3 Sobel of a u8
    image; `int_gradients` gives nothing else).  Then (gx+1020)*2048 +
    (gy+1020) <= 4.18M sits inside the float32 24-bit mantissa and unpacks
    exactly.  Outside that range the packing is silently wrong; nothing
    checks it here, because a check would read the device back to the host."""
    gxr = torch.round(gx.to(torch.float32))
    gyr = torch.round(gy.to(torch.float32))
    return (gxr + _GRAD_BIAS) * _GRAD_SCALE + (gyr + _GRAD_BIAS)


def _unpack_gradients(v: torch.Tensor):
    """Inverse of `_pack_gradients` (exact under its contract)."""
    dx = torch.floor(v / _GRAD_SCALE) - _GRAD_BIAS
    dy = v - (dx + _GRAD_BIAS) * _GRAD_SCALE - _GRAD_BIAS
    return dx, dy


def _reflect101(a: torch.Tensor, p: int) -> torch.Tensor:
    """Pad the last two axes by p with BORDER_REFLECT_101."""
    return torch.nn.functional.pad(a[None], (p, p, p, p), mode="reflect")[0]


def int_gradients(gray: torch.Tensor):
    """Reference-semantics gradient maps: 5x5 sigma-1 Gaussian blur
    (reflect-101 border) ROUNDED to u8 levels, then integer 3x3 Sobel
    (BinaryDescriptor::computeSobel, binary_descriptor.cpp:352-398).  Returns
    float32 maps holding exact integers in [-1020, 1020].

    Each blur pass is a chain of fused multiply-adds with one rounding each,
    fma(k0, s0, k1 s1) first, then fma(k_i, s_i, acc) for the other taps
    (evaluated through float64, where the product of two float32 values is
    exact): how XLA on the CPU contracts the JAX package's blur, so the
    rounded levels agree with it bit for bit, on the CPU and on the card."""
    g = gray.to(torch.float32)
    # the taps are computed in float64 and rounded once to float32
    x = torch.arange(5.0, dtype=torch.float64, device=g.device) - 2.0
    k = torch.exp(-(x * x) / 2.0)
    kw = (k / torch.sum(k)).to(torch.float32).to(torch.float64)
    a = _reflect101(g, 2)
    H, W = g.shape

    def taps(src, dim, n):
        tap = lambda i: src.narrow(dim, i, n).to(torch.float64) * kw[i]  # exact
        # fma(k0, s0, round(k1 s1)), then fma(k_i, s_i, acc) for the rest
        acc = tap(0) + tap(1).to(torch.float32).to(torch.float64)
        for i in range(2, 5):
            acc = acc.to(torch.float32).to(torch.float64) + tap(i)
        return acc.to(torch.float32)

    h = taps(a, 1, W)
    v = taps(h, 0, H)
    blur = torch.clamp(torch.round(v), 0.0, 255.0)
    b = _reflect101(blur, 1)
    sm_v = b[0:H, :] + 2.0 * b[1 : H + 1, :] + b[2 : H + 2, :]
    gx = sm_v[:, 2 : W + 2] - sm_v[:, 0:W]
    sm_h = b[:, 0:W] + 2.0 * b[:, 1 : W + 1] + b[:, 2 : W + 2]
    gy = sm_h[2 : H + 2, :] - sm_h[0:H, :]
    return gx, gy


def _descriptor_from_samples(packed, xi, yi, w_valid, dLx, dLy):
    """Shared descriptor core: given the PACKED gradient map
    (`_pack_gradients`) and per-sample integer coordinates (L, 63, max_len),
    compute the 72-float LBD as computeLBD does after its sampling loop
    (binary_descriptor.cpp:1298-1482): gradient projection on (dL, dO), per-row
    +/- split sums, global/local Gaussian band weighting, mean/std per band,
    two-stage normalisation, 0.4 clip, re-normalisation."""
    dtype = packed.dtype
    dev = packed.device
    dOx, dOy = -dLy, dLx  # clockwise orthogonal
    height = NUM_BANDS * BAND_WIDTH  # 63

    W = packed.shape[1]
    v = packed.reshape(-1)[yi * W + xi]
    dx, dy = _unpack_gradients(v)
    gdl = dx * dLx[:, None, None] + dy * dLy[:, None, None]
    gdo = dx * dOx[:, None, None] + dy * dOy[:, None, None]

    wv = w_valid[:, None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)
    pos_l = torch.sum(torch.where(wv & (gdl > 0), gdl, zero), dim=-1)  # (L, 63)
    neg_l = torch.sum(torch.where(wv & (gdl <= 0), -gdl, zero), dim=-1)
    pos_o = torch.sum(torch.where(wv & (gdo > 0), gdo, zero), dim=-1)
    neg_o = torch.sum(torch.where(wv & (gdo <= 0), -gdo, zero), dim=-1)

    coef_l, coef_g = _gauss_coefs(dtype, dev)
    rows = torch.stack([pos_l, neg_l, pos_o, neg_o], dim=-1) * coef_g[None, :, None]
    rows2 = rows * rows  # squared AFTER global weighting (matches reference)

    h = torch.arange(height, device=dev)
    band_of_row = torch.div(h, BAND_WIDTH, rounding_mode="floor")
    hmod = h % BAND_WIDTH

    # contribution weights of each row into (own band, band-1, band+1)
    c_self = coef_l[hmod + BAND_WIDTH]
    c_above = coef_l[hmod + 2 * BAND_WIDTH]  # into band-1
    c_below = coef_l[hmod]  # into band+1
    bands = torch.arange(NUM_BANDS, device=dev)

    def accumulate(target_band_of_row, coefs):
        onehot = (target_band_of_row[None, :] == bands[:, None]).to(dtype)  # (9, 63)
        w1 = (onehot * coefs[None, :]).to(rows.dtype)
        w2 = (onehot * (coefs * coefs)[None, :]).to(rows.dtype)
        return torch.einsum("bh,lhc->lbc", w1, rows), torch.einsum("bh,lhc->lbc", w2, rows2)

    s1a, s2a = accumulate(band_of_row, c_self)
    s1b, s2b = accumulate(band_of_row - 1, c_above)
    s1c, s2c = accumulate(band_of_row + 1, c_below)
    band_sum = s1a + s1b + s1c  # (L, 9, 4)
    band_sum2 = s2a + s2b + s2c

    edge = (bands == 0) | (bands == NUM_BANDS - 1)
    inv_n = torch.where(
        edge,
        torch.full((NUM_BANDS,), 1.0 / (BAND_WIDTH * 2.0), dtype=dtype, device=dev),
        torch.full((NUM_BANDS,), 1.0 / (BAND_WIDTH * 3.0), dtype=dtype, device=dev),
    )[None, :, None].to(rows.dtype)
    mean = band_sum * inv_n
    var = torch.clamp(band_sum2 * inv_n - mean * mean, min=0.0)
    std = torch.sqrt(var)

    # two-stage normalisation: means and stds separately
    m_norm = torch.sqrt(torch.sum(mean * mean, dim=(1, 2)) + 1e-24)
    s_norm = torch.sqrt(torch.sum(std * std, dim=(1, 2)) + 1e-24)
    desc = torch.cat([mean / m_norm[:, None, None], std / s_norm[:, None, None]], dim=-1)
    desc = torch.clamp(desc, max=0.4)  # illumination clipping
    flat = desc.reshape(desc.shape[0], -1)
    flat = flat / torch.sqrt(torch.sum(flat * flat, dim=-1, keepdim=True) + 1e-24)
    return flat.reshape(-1, NUM_BANDS * 8)


def lbd_descriptors(
    gray: torch.Tensor,
    lines: torch.Tensor,
    mask: torch.Tensor,
    max_len: int = 160,
    num_pixels: torch.Tensor | None = None,
    gradients: tuple | None = None,
):
    """Compute 72-float LBD descriptors for a padded line set.

    Reference semantics (computeLBD, binary_descriptor.cpp:1150-1513):
    integer halfWidth = (numOfPixels-1)/2, samples rounded half-away-from-
    zero and clamped to [0, W-1]x[0, H-1], line-support length equal to the
    Bresenham pixel count (cv::LineIterator semantics ~ Chebyshev length+1),
    gradients from the blurred image's integer 3x3 Sobel.

    gray (H, W); lines (L, 4) [x1 y1 x2 y2]; mask (L,); max_len caps the
    sampled support length; num_pixels optionally overrides the per-line
    support length; gradients optionally gives precomputed integer-valued
    (gx, gy) maps (see `_pack_gradients` for their range).

    Returns (desc (L, 72), valid (L,))."""
    dtype = gray.dtype
    dev = gray.device
    H, W = gray.shape
    gx, gy = int_gradients(gray) if gradients is None else gradients
    packed = _pack_gradients(gx, gy)

    # the line geometry keeps the lines' dtype; the sample grid has the
    # image's; the descriptor core runs in the packed map's float32
    sx, sy = lines[:, 0], lines[:, 1]
    ex, ey = lines[:, 2], lines[:, 3]
    direction = torch.atan2(ey - sy, ex - sx)
    dLx, dLy = torch.cos(direction), torch.sin(direction)
    dOx, dOy = -dLy, dLx  # clockwise orthogonal
    midx, midy = 0.5 * (sx + ex), 0.5 * (sy + ey)
    if num_pixels is None:
        # cv::LineIterator 8-connected count on rounded endpoints
        n_pix = (
            torch.maximum(
                torch.abs(torch.round(ex) - torch.round(sx)),
                torch.abs(torch.round(ey) - torch.round(sy)),
            )
            + 1.0
        )
    else:
        n_pix = num_pixels.to(dtype)
    n_pix = torch.clamp(n_pix, max=float(max_len))
    half_w = torch.floor((n_pix - 1.0) / 2.0)  # integer halfWidth (ref :1250)

    height = NUM_BANDS * BAND_WIDTH  # 63
    half_h = (height - 1) // 2  # 31

    h_ids = torch.arange(height, dtype=dtype, device=dev)
    w_ids = torch.arange(max_len, dtype=dtype, device=dev)
    w_valid = w_ids[None, :] < n_pix[:, None]  # (L, max_len)

    # sample positions: pos(h, w) = mid + (w - halfW)*dL + (h - halfH)*dO
    along = w_ids[None, None, :] - half_w[:, None, None]
    across = h_ids[None, :, None] - half_h
    px = midx[:, None, None] + along * dLx[:, None, None] + across * dOx[:, None, None]
    py = midy[:, None, None] + along * dLy[:, None, None] + across * dOy[:, None, None]
    # round half away from zero (C round(); after the >=0 clamp this is
    # floor(x+0.5) for every value that can land in range)
    xi = torch.clamp(torch.floor(px + 0.5).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.floor(py + 0.5).to(torch.int64), 0, H - 1)
    return _descriptor_from_samples(packed, xi, yi, w_valid, dLx, dLy), mask


def l2_match(
    query_desc: torch.Tensor,
    train_desc: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    max_dist: float = 0.6,
    query_lines: torch.Tensor | None = None,
    train_lines: torch.Tensor | None = None,
    max_midpoint_dist: float | None = None,
    mutual: bool = True,
):
    """Float-descriptor matching on L2 distance over the unit-norm LBD
    vectors, before binarization (beyond the reference, which matches the
    binarized codes, line_lbd_allclass.cpp:352-369).

    The (Lq, Lt) distances are computed directly as sqrt(sum((a - b)^2)), not
    by a matrix-product expansion (`torch.cdist` switches to one above 25
    rows, which rounds differently and flips nearest neighbours).

    Optional guided matching for video: with `query_lines`/`train_lines`
    ((L, 4) endpoints) and `max_midpoint_dist`, candidates farther than the
    given midpoint motion are excluded before the nearest-neighbour step.
    Among equal distances the lower index wins.

    Returns (match_idx (Lq,), match_dist (Lq,), matched (Lq,))."""
    from cube_slam_wu_tpu_torch.ops.topk import first_argmin

    d2 = torch.sum((query_desc[:, None, :] - train_desc[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    valid = train_mask[None, :] & query_mask[:, None]
    if max_midpoint_dist is not None:
        if query_lines is None or train_lines is None:
            raise ValueError("max_midpoint_dist requires query_lines and train_lines")
        mq = (query_lines[:, :2] + query_lines[:, 2:]) * 0.5
        mt = (train_lines[:, :2] + train_lines[:, 2:]) * 0.5
        move = torch.linalg.norm(mq[:, None, :] - mt[None, :, :], dim=-1)
        valid = valid & (move <= max_midpoint_dist)
    dist = torch.where(valid, dist, torch.full_like(dist, 1e9))
    fwd = first_argmin(dist, dim=-1)
    best = torch.gather(dist, -1, fwd[:, None])[:, 0]
    matched = query_mask & (best < max_dist)
    if mutual:
        bwd = first_argmin(dist, dim=-2)
        matched = matched & (bwd[fwd] == torch.arange(dist.shape[0], device=dist.device))
    return fwd, best, matched
