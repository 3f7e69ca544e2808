"""Line-Band-Descriptor (LBD) + binary conversion + Hamming matching.

Batched re-design of the reference's descriptor stack
(line_lbd/libs/binary_descriptor.cpp:1150-1515 `computeLBD`):

- 9 bands x width 7 line-support region sampled along/perpendicular to the
  line, gradients projected on the line direction dL and its clockwise
  orthogonal dO, positive/negative parts split,
- per-row global Gaussian weight (sigma = halfHeight), per-band local
  Gaussian spill into the two neighbouring bands (sigma = (2w+1)/2),
- band means/stds with 1/(2w) edge-band and 1/(3w) inner-band normalisers,
- two-stage normalisation (means and stds separately), 0.4 clipping,
  re-normalisation -> 72-float descriptor,
- 256-bit binarisation by comparing the 32 fixed band pairs (the constant
  table from the LBD paper, binary_descriptor.cpp:74-107).

Matching replaces the reference's Multi-Index-Hashing tables with a dense
XOR+popcount Hamming matrix; it reproduces nearest-neighbour matching with
the reference's dist<25 acceptance (line_lbd_allclass.cpp:352-369) exactly.

The 256-bit codes are (L, 8) int64 tensors holding 32-bit words, values in
[0, 2^32): PyTorch has no shifts for uint32 on the CPU and no popcount, and
int64 carries every intermediate of the 32-bit popcount without wrapping.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_BANDS = 9
BAND_WIDTH = 7

# band-pair comparison table (binary_descriptor.cpp:74-107)
_COMBINATIONS = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6),
    (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
    (2, 3), (2, 4), (2, 5), (2, 6), (2, 7), (2, 8),
    (3, 4), (3, 5), (3, 6), (3, 7), (3, 8),
    (4, 5), (4, 6), (4, 7), (4, 8),
    (5, 6), (5, 7), (5, 8),
    (6, 7), (6, 8),
    (7, 8),
)


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
    return sobel_int(torch.clamp(torch.round(v), 0.0, 255.0))


def sobel_int(blur: torch.Tensor):
    """3x3 Sobel with BORDER_REFLECT_101 of an image of integer levels
    (cv::Sobel CV_16S, binary_descriptor.cpp:374-398): exact integers in the
    image's float dtype.  Returns (gx, gy)."""
    H, W = blur.shape
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


def reference_gradients(gray_u8):
    """OpenCV-equivalent gradient maps for LBD parity: GaussianBlur(5x5,
    sigma=1, BORDER_REFLECT_101) rounded to uint8, then 3x3 Sobel (CV_16S,
    BORDER_REFLECT_101) — BinaryDescriptor::computeSobel
    (binary_descriptor.cpp:352-398) at octave 0.  Host numpy in float64, in
    the JAX package's op order, so the maps are bit-equal to its.

    The Sobel stage is bit-exact against the reference build; the blur
    matches OpenCV's fixed-point 8U Gaussian to +/-1 gray level.  Pass
    oracle-dumped (dx, dy) to `lbd_descriptors(..., gradients=...)` when exact
    parity is required.

    Returns (gx, gy) int32 numpy arrays."""
    g = np.asarray(gray_u8, np.float64)
    x = np.arange(5.0) - 2.0
    k = np.exp(-(x * x) / 2.0)
    k = k / k.sum()
    a = np.pad(g, 2, mode="reflect")  # BORDER_REFLECT_101
    H, W = g.shape
    h = sum(k[i] * a[:, i : i + W] for i in range(5))
    v = sum(k[i] * h[i : i + H, :] for i in range(5))
    blur = np.clip(np.rint(v), 0, 255).astype(np.int64)
    b = np.pad(blur, 1, mode="reflect")
    sm_v = b[0:H, :] + 2 * b[1 : H + 1, :] + b[2 : H + 2, :]
    gx = sm_v[:, 2 : W + 2] - sm_v[:, 0:W]
    sm_h = b[:, 0:W] + 2 * b[:, 1 : W + 1] + b[:, 2 : W + 2]
    gy = sm_h[2 : H + 2, :] - sm_h[0:H, :]
    return gx.astype(np.int32), gy.astype(np.int32)


def lbd_descriptors_ref_exact(
    gray_shape,
    gradients,
    lines,
    angles,
    num_pixels,
    max_len: int = 700,
):
    """Reference-exact LBD path (test/oracle infrastructure).

    computeLBD accumulates its sample coordinates sequentially in float32
    (sCorX += dL[0] per column, sCorX0 -= dL[1] per row,
    binary_descriptor.cpp:1270-1327); near .5-boundaries the accumulated f32
    rounding decides which pixel gets sampled, so bit-faithful parity needs
    that accumulation order.  The C scalar setup and accumulation run as host
    numpy float32 ops (IEEE f32 adds in C program order); the descriptor core
    (`_descriptor_from_samples`) runs on the device of `gradients`.

    gray_shape: (H, W) of the octave image; gradients: (gx, gy) integer-valued
    tensors (e.g. oracle dx/dy dumps or `reference_gradients`); lines (L, 4)
    endpoints, angles (L,) KeyLine.angle (f32), num_pixels (L,)
    KeyLine.numOfPixels, as host arrays.

    Returns desc (L, 72) float32 on the gradients' device."""
    f32 = np.float32
    H, W = gray_shape
    lines = np.asarray(lines, np.float64)
    sx = lines[:, 0].astype(f32)
    sy = lines[:, 1].astype(f32)
    ex = lines[:, 2].astype(f32)
    ey = lines[:, 3].astype(f32)
    angle = np.asarray(angles, f32)
    npix = np.minimum(np.asarray(num_pixels, np.int64), max_len)

    # C scalar setup (:1249-1271), f32 op order
    dL0 = np.cos(angle.astype(np.float64)).astype(f32)
    dL1 = np.sin(angle.astype(np.float64)).astype(f32)
    halfW = ((npix - 1) // 2).astype(f32)
    midx = (np.float64(0.5) * (sx + ex).astype(np.float64)).astype(f32)
    midy = (np.float64(0.5) * (sy + ey).astype(np.float64)).astype(f32)
    height = NUM_BANDS * BAND_WIDTH
    half_h = f32((height - 1) // 2)
    rx = ((-dL0 * halfW).astype(f32) + (dL1 * half_h).astype(f32)).astype(f32) + midx
    ry = ((-dL1 * halfW).astype(f32) - (dL0 * half_h).astype(f32)).astype(f32) + midy
    rx = rx.astype(f32)
    ry = ry.astype(f32)

    L = len(lines)
    max_np = int(npix.max()) if L else 1
    # np.add.accumulate is a strict left fold at the accumulator dtype, i.e.
    # the same IEEE-f32 add sequence as the C loops.
    row_sx = np.add.accumulate(
        np.concatenate([rx[None], np.broadcast_to(-dL1, (height - 1, L))]), axis=0, dtype=f32
    )  # (63, L) row starts
    row_sy = np.add.accumulate(
        np.concatenate([ry[None], np.broadcast_to(dL0, (height - 1, L))]), axis=0, dtype=f32
    )
    cx = np.add.accumulate(
        np.concatenate([row_sx[None], np.broadcast_to(dL0, (max_np - 1, height, L))]),
        axis=0, dtype=f32,
    )  # (max_np, 63, L)
    cy = np.add.accumulate(
        np.concatenate([row_sy[None], np.broadcast_to(dL1, (max_np - 1, height, L))]),
        axis=0, dtype=f32,
    )
    xi = np.clip(np.floor(cx.astype(np.float64) + 0.5), 0, W - 1).astype(np.int64)
    yi = np.clip(np.floor(cy.astype(np.float64) + 0.5), 0, H - 1).astype(np.int64)
    xi = np.ascontiguousarray(np.transpose(xi, (2, 1, 0)))  # (L, 63, max_np)
    yi = np.ascontiguousarray(np.transpose(yi, (2, 1, 0)))

    gx, gy = gradients
    dev = gx.device
    w_valid = np.arange(max_np)[None, :] < npix[:, None]
    packed = _pack_gradients(gx, gy)
    to = lambda a: torch.from_numpy(a).to(dev)
    return _descriptor_from_samples(packed, to(xi), to(yi), to(w_valid), to(dL0), to(dL1))


def lbd_descriptors_octaves(
    gray: torch.Tensor,
    lines: torch.Tensor,
    mask: torch.Tensor,
    octaves: torch.Tensor,
    n_octaves: int,
    max_len: int = 160,
):
    """LBD descriptors computed on each segment's ORIGINATING octave image
    (detect_descrip_lines_octaves semantics, line_lbd_allclass.cpp:296-349:
    the reference runs computeLBD per pyramid level).

    gray (H, W) base image, the pyramid rebuilt with the detector's
    `downsample2`; lines (L, 4) in OCTAVE-0 coordinates and octaves (L,)
    provenance, as `detect_line_segments_octaves(..., return_octaves=True)`
    gives them; n_octaves the pyramid depth.

    Returns (desc (L, 72), valid (L,))."""
    from cube_slam_wu_tpu_torch.ops.detect import downsample2

    if n_octaves == 1:
        return lbd_descriptors(gray, lines, mask, max_len=max_len)
    desc = None
    img = gray
    for o in range(n_octaves):
        scale = float(2**o)
        # inverse of the detector's pixel-centre mapping
        # x_full = scale * x_o + (scale - 1) / 2
        lines_o = (lines - (scale - 1.0) / 2.0) / scale
        sel = octaves == o
        d_o, _ = lbd_descriptors(img, lines_o, mask & sel, max_len=max_len)
        desc = d_o if desc is None else torch.where(sel[:, None], d_o, desc)
        if o + 1 < n_octaves:
            img = downsample2(img)
    return desc, mask


def binarize_lbd(desc: torch.Tensor) -> torch.Tensor:
    """72-float LBD -> 256-bit binary as (L, 8) 32-bit words in int64
    (binaryConversion semantics: bit j of pair p set iff
    band[p0*8+j] > band[p1*8+j])."""
    L = desc.shape[0]
    d = desc.reshape(L, NUM_BANDS, 8)
    a = torch.tensor([c[0] for c in _COMBINATIONS], device=desc.device)
    b = torch.tensor([c[1] for c in _COMBINATIONS], device=desc.device)
    bits = (d[:, a, :] > d[:, b, :]).reshape(L, 8, 32)  # 8 words of 32 bits
    shifts = torch.arange(32, device=desc.device)
    return torch.sum(bits.to(torch.int64) << shifts, dim=-1)


def pack_lbd_bytes(desc_bytes: torch.Tensor) -> torch.Tensor:
    """Reference-layout 32-byte binary descriptors (byte p = the 8 comparison
    bits of band pair p, binaryConversion bit j = 1<<j,
    binary_descriptor.cpp:405-416/:769-773), a (L, 32) integer tensor, ->
    the (L, 8) word layout `binarize_lbd` produces, on the same device."""
    b = desc_bytes.to(torch.int64)
    L = b.shape[0]
    shifts = torch.arange(8, device=b.device)
    bits = (b[:, :, None] >> shifts) & 1  # (L, 32p, 8j)
    bits = bits.reshape(L, 8, 32)  # same flatten order as binarize_lbd
    return torch.sum(bits << torch.arange(32, device=b.device), dim=-1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor (values in
    [0, 2^32)); the uint32 SWAR count, with the final product masked back
    to 32 bits before the shift."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


_INT32_MAX = 2**31 - 1


def _hamming(query_words: torch.Tensor, train_words: torch.Tensor) -> torch.Tensor:
    """(Lq, Lt) int32 Hamming distances of two word sets."""
    xor = query_words[:, None, :] ^ train_words[None, :, :]
    return torch.sum(_popcount32(xor), dim=-1).to(torch.int32)


def hamming_match(
    query_words: torch.Tensor,
    train_words: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    max_dist: int = 25,
):
    """Nearest-neighbour binary matching with the reference's dist<25 filter
    (match_line_descrip, line_lbd_allclass.cpp:352-369).  Masked train rows
    are at int32 max; among equal distances the lower index wins.

    Returns (match_idx (Lq,), match_dist (Lq,) int32, matched (Lq,))."""
    from cube_slam_wu_tpu_torch.ops.topk import first_argmin

    dist = _hamming(query_words, train_words)
    dist = torch.where(train_mask[None, :], dist, _INT32_MAX)
    idx = first_argmin(dist, dim=-1)
    best = torch.gather(dist, -1, idx[:, None])[:, 0]
    matched = query_mask & (best < max_dist)
    return idx, best, matched


def knn_match(
    query_words: torch.Tensor,
    train_words: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    k: int = 2,
):
    """k-nearest-neighbour binary matching
    (BinaryDescriptorMatcher::knnMatch, binary_descriptor_matcher.cpp:216-376,
    the MIH k-NN replaced by one dense XOR+popcount matrix and an order-stable
    top-k: among equal distances the lower index comes first).

    Returns (idx (Lq, k) train indices best-first, dist (Lq, k) int32,
    valid (Lq, k) — False where fewer than k unmasked train rows exist or the
    query is masked out).  k larger than the train capacity Lt pads the
    trailing k - Lt columns with index 0, int32 max and valid=False."""
    from cube_slam_wu_tpu_torch.ops.topk import stable_top_k

    dist = _hamming(query_words, train_words)
    dist = torch.where(train_mask[None, :], dist, _INT32_MAX)
    Lt = train_words.shape[0]
    k_eff = min(k, Lt)
    neg, idx = stable_top_k(-dist, k_eff, dim=-1)
    d = -neg
    if k_eff < k:
        pad = (0, k - k_eff)
        idx = torch.nn.functional.pad(idx, pad)
        d = torch.nn.functional.pad(d, pad, value=_INT32_MAX)
    valid = query_mask[:, None] & (d < _INT32_MAX)
    return idx, d, valid


def radius_match(
    query_words: torch.Tensor,
    train_words: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    max_dist: int = 25,
):
    """All train matches within a Hamming radius per query
    (BinaryDescriptorMatcher::radiusMatch, binary_descriptor_matcher.cpp:
    448-597).  Dense form: the full (Lq, Lt) int32 distance matrix and the
    within-radius mask (masked rows and columns excluded)."""
    dist = _hamming(query_words, train_words)
    within = (dist <= max_dist) & query_mask[:, None] & train_mask[None, :]
    return dist, within


def match_lines_filtered(
    query_words: torch.Tensor,
    train_words: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    max_dist: int = 25,
):
    """Nearest neighbour + mutual-consistency check (the raw `hamming_match`
    mirrors the reference's NN-only behaviour; for frame-to-frame tracking the
    mutual check removes most false positives).

    Returns (match_idx, match_dist, matched)."""
    from cube_slam_wu_tpu_torch.ops.topk import first_argmin

    dist = _hamming(query_words, train_words)
    dist = torch.where(train_mask[None, :] & query_mask[:, None], dist, _INT32_MAX)
    fwd = first_argmin(dist, dim=-1)
    bwd = first_argmin(dist, dim=-2)
    best = torch.gather(dist, -1, fwd[:, None])[:, 0]
    mutual = bwd[fwd] == torch.arange(dist.shape[0], device=dist.device)
    matched = query_mask & (best < max_dist) & mutual
    return fwd, best, matched


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
