"""Batched line-segment detection.

Replaces the reference's sequential detectors — EDLine's anchor/edge-chaining
(line_lbd/libs/binary_descriptor.cpp:1583-2875) and von-Gioi LSD's region
growing (line_lbd/libs/lsd.cpp) — with a fully-batched orientation-aware
Hough formulation with no data-dependent control flow:

  1. Gaussian blur + Sobel gradients (matching the reference pyramid base,
     binary_descriptor.cpp:352-374),
  2. non-maximum-suppressed edge mask with a gradient threshold,
  3. gradient-weighted votes into a (normal-angle, offset) Hough accumulator —
     each pixel votes only near its own gradient orientation, which is what
     makes the transform segment-friendly (one scatter-add),
  4. 3x3 peak NMS + top-P peak extraction,
  5. per-peak inlier binning along the line direction and gap-tolerant run
     extraction (batched 1D scans over a (P, n_bins) occupancy raster) —
     the parallel analogue of LSD's region growing / EDLine's chain walking,
  6. duplicate removal + collinear merging (ops.lines.merge_break_lines).

Every selection is order-stable (`ops.topk.stable_top_k`) and the Hough vote
is accumulated deterministically, so two runs on the same image give the same
bits on the card as well.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cube_slam_wu_tpu_torch.ops import image as image_ops
from cube_slam_wu_tpu_torch.ops import lines as line_ops
from cube_slam_wu_tpu_torch.ops.topk import stable_top_k


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    n_theta: int = 180  # normal-angle bins over [0, pi)
    rho_bin: float = 1.5  # px per offset bin
    t_bin: float = 2.0  # px per along-line bin
    grad_threshold: float = 30.0  # on |gx|+|gy| of the blurred image
    n_peaks: int = 384  # Hough peaks examined
    runs_per_peak: int = 6  # segments extracted per peak
    max_runs: int = 32  # run-id capacity per peak
    # px half-width of the perpendicular inlier window (quality-pinned
    # default; a narrower window trades sequence accuracy for less work)
    inlier_rho_tol: float = 2.0
    inlier_angle_tol_deg: float = 11.0
    min_inliers: float = 7.0  # occupied bins per run (~14 px)
    gap_bins: int = 2  # tolerated empty bins inside a run
    merge_dist: float = 8.0
    merge_angle_deg: float = 5.0
    min_length: float = 15.0  # line_lbd_detect.line_length_thres analogue
    max_merge_iters: int = 400
    max_edge_pixels: int = 32768  # compaction cap for the Hough vote scatter
    max_output: int = 384  # final segment capacity (top-K by length)
    # Helmholtz NFA validation (optional): keep a run only if its aligned
    # support is statistically significant against the image's own occupancy
    # rate — the a-contrario principle of LSD's rect NFA (lsd.cpp:873) and
    # EDLine's LineValidation_ (binary_descriptor.cpp:2793-2875).
    nfa_validation: bool = False
    nfa_log10_eps: float = 0.0  # keep if log10(NFA) < this (eps = 1)
    # Additive short-segment recovery: after the main pass, zero the edge
    # pixels its accepted segments claim and run a second extraction with a
    # lower run gate on the residual (detect_line_segments_recover; the
    # callers that honour the flag route to it).  ~2x detector cost.
    short_recovery: bool = False
    short_min_inliers: float = 4.0  # pass-2 run gate (~8 px)
    short_n_peaks: int = 512
    short_extra_capacity: int = 384  # extra output slots for recovered segs
    claim_rho_px: float = 1.5  # pixel-to-segment claim distance
    claim_angle_deg: float = 8.0


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitting constant for float64


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """a*b = p + e exactly (Dekker's TwoProduct with Veltkamp splitting);
    every operation is its own kernel, so nothing is contracted."""

    def split(x):
        c = _SPLIT * x
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """a+b = s + e exactly (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_round_to_odd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x+y rounded to odd: exact sums stay, an inexact one becomes the
    neighbour of the exact value whose last significand bit is 1."""
    s, e = _two_sum(x, y)
    away = (e != 0) & ((e > 0) != (s > 0))  # s was rounded away from zero
    toward_zero = torch.where(away, torch.nextafter(s, torch.zeros_like(s)), s)
    odd = (toward_zero.view(torch.int64) | 1).view(torch.float64)
    return torch.where(e != 0, odd, s)


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c with ONE rounding, in float64 on any device, emulated by the
    algorithm of Boldo and Melquiond ("Emulation of FMA and correctly rounded
    sums: proved algorithms using rounding to odd", IEEE TC 2008): the exact
    product and sum split into high and low parts, the low parts added with
    rounding to odd, then one rounding to nearest."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_round_to_odd(tl, ul)


def gaussian_blur5(gray: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """5x5 Gaussian blur, replicate border (cv::GaussianBlur(Size(5,5),1)),
    as shifted multiply-adds.

    The five taps of each pass are accumulated in tap order with ONE rounding
    per tap (a chain of fused multiply-adds), which is what XLA's CPU code
    makes of the JAX package's `tensordot`; the taps are normalised by a sum
    in tap order.  For float32 images the chain is evaluated through float64,
    where the product of two float32 values is exact; for float64 images
    each step is an exact fused multiply-add emulated in float64 (`fma64`).
    Neither depends on whether a device's compiler contracts a*b+c: the
    blurred image — and with it every tie the non-maximum suppression breaks
    on flat-shaded plateaus — is the same on the CPU and on the card, and
    equals what the JAX package computes on the CPU bit for bit.
    """
    xs = torch.arange(-2, 3, dtype=gray.dtype, device=gray.device)
    k = torch.exp(-(xs**2) / (2.0 * sigma**2))
    total = k[0]
    for tap in range(1, 5):
        total = total + k[tap]
    k = k / total
    f32 = gray.dtype == torch.float32
    f64 = gray.dtype == torch.float64
    wide = torch.float64 if f32 else gray.dtype
    kw = k.to(wide)

    def conv1(a, dim):
        n = a.shape[dim]
        acc = None
        for tap in range(5):
            idx = torch.clamp(torch.arange(n, device=a.device) + (tap - 2), 0, n - 1)
            g = a.index_select(dim, idx).to(wide)
            if acc is None:
                acc = g * kw[tap]
            elif f64:
                acc = fma64(g, kw[tap].expand_as(g), acc)
            else:
                acc = acc + g * kw[tap]
            if f32:  # round once per tap, as a fused multiply-add does
                acc = acc.to(torch.float32).to(wide)
        return acc.to(gray.dtype)

    return conv1(conv1(gray, 0), 1)


def _angle_dist_pi(a, b):
    d = torch.abs(a - b)
    d = torch.remainder(d, math.pi)
    return torch.minimum(d, math.pi - d)


def hough_dims(H: int, W: int, cfg: DetectConfig):
    """(NT, NR, diag) of the accumulator for an (H, W) image; offsets are
    shifted by `diag` so that rho >= 0."""
    diag = math.hypot(H, W)
    return cfg.n_theta, int(2 * diag / cfg.rho_bin) + 2, diag


def edge_pixels(gray: torch.Tensor, cfg: DetectConfig, suppress: torch.Tensor | None = None):
    """Stages 1-2 and the compaction to the strongest edge pixels; pixels of
    the optional (H, W) bool `suppress` are no edge pixels.

    Returns (flat_w, flat_x, flat_y, flat_psi) of length NE and the dense
    (keep, mag, psi) fields the support raster reads."""
    dtype = gray.dtype
    H, W = gray.shape
    g = gaussian_blur5(gray)
    gx, gy = image_ops.sobel3(g)
    mag = torch.abs(gx) + torch.abs(gy)
    keep = image_ops._nms(mag, gx, gy) & (mag > cfg.grad_threshold)
    if suppress is not None:
        keep = keep & ~suppress

    # normal (gradient) angle folded to [0, pi)
    psi = torch.remainder(torch.atan2(gy, gx), math.pi)

    # compact to the strongest edge pixels: all per-peak work below is
    # O(edge pixels).  The selection is exact and order-stable.
    NE = min(cfg.max_edge_pixels, H * W)
    score_flat = torch.where(keep, mag, torch.zeros_like(mag)).reshape(-1)
    top_w, top_pix = stable_top_k(score_flat, NE)
    flat_w = top_w
    flat_y = (top_pix // W).to(dtype)
    flat_x = (top_pix % W).to(dtype)
    flat_psi = psi.reshape(-1)[top_pix]
    return (flat_w, flat_x, flat_y, flat_psi), (keep, mag, psi)


def hough_accumulate(flat_w, flat_x, flat_y, flat_psi, H: int, W: int, cfg: DetectConfig):
    """Gradient-weighted votes at each pixel's own angle bin +-1 -> (NT, NR).

    The votes are non-integer floats, so the order of summation shows in the
    bits.  All three passes go into ONE accumulate call in a fixed order
    (dt = -1, 0, +1, pixels in list order) and the call runs with
    deterministic algorithms switched on, which on CUDA takes the sorted,
    sequential accumulation instead of atomics.
    """
    dtype = flat_w.dtype
    NT, NR, rho_off = hough_dims(H, W, cfg)
    tbin0 = torch.remainder(
        torch.floor(flat_psi / (math.pi / NT)).to(torch.int32), NT
    )
    idx, val = [], []
    for dt in (-1, 0, 1):
        tb = torch.remainder(tbin0 + dt, NT)
        theta = (tb.to(dtype) + 0.5) * (math.pi / NT)
        rho = flat_x * torch.cos(theta) + flat_y * torch.sin(theta)
        rb = torch.clamp(((rho + rho_off) / cfg.rho_bin).to(torch.int32), 0, NR - 1)
        idx.append(tb.to(torch.int64) * NR + rb.to(torch.int64))
        val.append(flat_w)
    acc = torch.zeros(NT * NR, dtype=dtype, device=flat_w.device)
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        acc.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    return acc.reshape(NT, NR)


def hough_peaks(acc: torch.Tensor, cfg: DetectConfig):
    """3x3 NMS (wrapping on the theta axis only) then the top-P peaks.
    Returns (top_vals (P,), top_idx (P,) flat into (NT, NR))."""
    def max3(a, axis, wrap):
        lo = torch.roll(a, 1, axis)
        hi = torch.roll(a, -1, axis)
        if not wrap:
            # non-wrapping axis: neighbours beyond the edge do not exist
            lo = lo.clone()
            hi = hi.clone()
            lo.narrow(axis, 0, 1).zero_()
            hi.narrow(axis, a.shape[axis] - 1, 1).zero_()
        return torch.maximum(a, torch.maximum(lo, hi))

    neigh = max3(max3(acc, 0, wrap=True), 1, wrap=False)
    is_peak = (acc >= neigh) & (acc > 0)
    peak_score = torch.where(is_peak, acc, torch.zeros_like(acc))
    return stable_top_k(peak_score.reshape(-1), cfg.n_peaks)


def _near_collinear(ref, cand, perp_tol: float, ov_min: float, ang_tol_deg: float):
    """(Lr, Lc) bool: candidate segment c lies along reference segment r
    (both endpoints of c within `perp_tol` of r's line, c covering more than
    `ov_min` of r's span, directions within `ang_tol_deg`)."""
    d1 = ref[:, 2:4] - ref[:, 0:2]
    len1 = torch.linalg.norm(d1, dim=-1) + 1e-9
    u1 = d1 / len1[:, None]
    n1 = torch.stack([-u1[:, 1], u1[:, 0]], dim=-1)
    rel_a = cand[None, :, 0:2] - ref[:, None, 0:2]  # (Lr, Lc, 2)
    rel_b = cand[None, :, 2:4] - ref[:, None, 0:2]
    dot = lambda rel, u: rel[..., 0] * u[:, None, 0] + rel[..., 1] * u[:, None, 1]
    perp = torch.maximum(torch.abs(dot(rel_a, n1)), torch.abs(dot(rel_b, n1)))
    ta = dot(rel_a, u1) / len1[:, None]
    tb = dot(rel_b, u1) / len1[:, None]
    ov = torch.clamp(torch.maximum(ta, tb), max=1.0) - torch.clamp(torch.minimum(ta, tb), min=0.0)
    a1 = torch.atan2(d1[:, 1], d1[:, 0])
    a2 = torch.atan2(cand[:, 3] - cand[:, 1], cand[:, 2] - cand[:, 0])
    d_ang = _angle_dist_pi(a1[:, None], a2[None, :])
    return (perp < perp_tol) & (ov > ov_min) & (d_ang < math.radians(ang_tol_deg))


def nfa_log10(counts, n_run, p0, n_peaks: int, NB: int):
    """log10 of the number of false alarms of runs spanning `n_run` bins with
    `counts` occupied, under occupancy rate `p0` (LSD lsd.cpp:873 / EDLine
    LineValidation_ semantics, re-stated on the run raster):
    NFA = N_tests * P[B(n, p0) >= k], N_tests = every (start, end) bin pair on
    every peak line.  The binomial tail is an exact masked sum over the bin
    axis, one lgamma batch, in p0's dtype."""
    dtype = p0.dtype
    k_run = torch.minimum(counts, n_run)
    js = torch.arange(NB + 1, dtype=dtype, device=p0.device)  # term index
    nf = n_run.to(dtype)[..., None]
    kf = k_run.to(dtype)[..., None]
    logterm = (
        torch.lgamma(nf + 1.0)
        - torch.lgamma(js + 1.0)
        - torch.lgamma(nf - js + 1.0)
        + js * torch.log(p0)
        + (nf - js) * torch.log1p(-p0)
    )
    term_ok = (js >= kf) & (js <= nf)
    tail = torch.sum(torch.where(term_ok, torch.exp(logterm), torch.zeros_like(logterm)), dim=-1)
    return math.log10(n_peaks * NB * NB / 2.0) + torch.log10(torch.clamp(tail, min=1e-300))


def detect_line_segments(
    gray: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    suppress: torch.Tensor | None = None,
):
    """Detect line segments in a float gray image (H, W) on its own device.

    Returns (lines (K, 4) [x1 y1 x2 y2] left-to-right, mask (K,)) with
    K = min(max_output, n_peaks * runs_per_peak) (top-K by length).

    `suppress` (optional (H, W) bool) removes edge pixels from every stage
    (votes AND support sampling) — the recovery pass's claimed-pixel mask.
    `cfg.short_recovery` is not read here: `detect_line_segments_recover`
    is the two-pass detector.
    """
    dtype = gray.dtype
    dev = gray.device
    H, W = gray.shape
    (flat_w, flat_x, flat_y, flat_psi), (keep, mag, psi) = edge_pixels(gray, cfg, suppress)

    # ---- Hough accumulation + peak extraction ------------------------------
    NT, NR, diag = hough_dims(H, W, cfg)
    rho_off = diag
    acc = hough_accumulate(flat_w, flat_x, flat_y, flat_psi, H, W, cfg)
    P = cfg.n_peaks
    top_vals, top_idx = hough_peaks(acc, cfg)
    pk_t = top_idx // NR
    pk_r = top_idx % NR
    pk_valid = top_vals > 0
    theta_p = (pk_t.to(dtype) + 0.5) * (math.pi / NT)  # (P,)
    rho_p = (pk_r.to(dtype) + 0.5) * cfg.rho_bin - rho_off

    # ---- per-peak inlier raster along the line ----------------------------
    # GATHER formulation: walk each peak line through a dense packed field
    # and read the support.  NMS'd gradient magnitude and the quantised
    # normal angle are packed into ONE float per pixel (mag*256 + psi_bin;
    # mag <= 2040 so the product stays inside the 24-bit f32 mantissa) so
    # each sample costs one gather.
    cos_p, sin_p = torch.cos(theta_p), torch.sin(theta_p)
    PSI_Q = 256
    psi_bin_img = torch.floor(psi / math.pi * PSI_Q).to(dtype)
    packed = torch.where(
        keep & (mag > cfg.grad_threshold), torch.floor(mag), torch.zeros_like(mag)
    ) * (PSI_Q * 1.0) + psi_bin_img

    # bins are centred on the projection of the image centre onto the line,
    # so |t_rel| <= diag/2 always covers the visible extent
    NB = int(diag / cfg.t_bin) + 2
    ex_p, ey_p = -sin_p, cos_p  # along-line direction
    t_c = 0.5 * W * ex_p + 0.5 * H * ey_p  # centre projection
    ax_p = rho_p * cos_p + t_c * ex_p  # anchor point on the line
    ay_p = rho_p * sin_p + t_c * ey_p

    t_rel = (torch.arange(NB, dtype=dtype, device=dev) - 0.5 * NB + 0.5) * cfg.t_bin
    n_perp = int(math.ceil(cfg.inlier_rho_tol)) * 2 + 1
    offs = torch.arange(n_perp, dtype=dtype, device=dev) - (n_perp - 1) / 2.0  # (S,)

    # sample positions: anchor + t*dir + o*normal  ->  (P, NB, S)
    sx = (
        ax_p[:, None, None]
        + t_rel[None, :, None] * ex_p[:, None, None]
        + offs[None, None, :] * cos_p[:, None, None]
    )
    sy = (
        ay_p[:, None, None]
        + t_rel[None, :, None] * ey_p[:, None, None]
        + offs[None, None, :] * sin_p[:, None, None]
    )
    xi = torch.round(sx).to(torch.int64)
    yi = torch.round(sy).to(torch.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = packed.reshape(-1)[
        torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
    ]
    s_mag = torch.floor(v / PSI_Q)
    s_psi = (v - s_mag * PSI_Q) * (math.pi / PSI_Q)
    ang_ok = _angle_dist_pi(s_psi, theta_p[:, None, None]) < math.radians(
        cfg.inlier_angle_tol_deg
    )
    w_smp = torch.where(inb & ang_ok & (s_mag > 0), s_mag, torch.zeros_like(s_mag))
    occ = torch.sum(w_smp, dim=-1)  # (P, NB) weighted support per bin
    # perpendicular first moment per bin: lets each run re-fit a local
    # offset+tilt, fixing the ~half-window bias a global Hough line has on
    # slightly-bent structures
    occ_o = torch.sum(w_smp * offs[None, None, :], dim=-1)  # (P, NB)

    # ---- gap-tolerant run extraction on the (P, NB) raster ----------------
    occb = occ > 0
    # close gaps of up to gap_bins via 1D dilation then logical AND trimming
    closed = occb
    for _ in range(cfg.gap_bins):
        closed = closed | torch.roll(closed, 1, -1) | torch.roll(closed, -1, -1)
    # runs of `closed`; trim later using occb
    prev = torch.cat([torch.zeros_like(closed[:, :1]), closed[:, :-1]], dim=1)
    run_start = closed & ~prev
    run_id = torch.cumsum(run_start.to(torch.int32), dim=1) * closed  # 1-based, 0 = background
    run_id = torch.clamp(run_id, max=cfg.max_runs)

    bin_t = t_rel  # per-bin along-line offset relative to the anchor

    # per-peak run statistics with the peak axis written out: (P, R, NB)
    R = cfg.max_runs
    seg_ids = torch.arange(1, R + 1, device=dev)
    member = (run_id[:, None, :] == seg_ids[None, :, None]) & occb[:, None, :]
    counts = torch.sum(member, dim=2)  # (P, R) int
    zero = torch.zeros((), dtype=dtype, device=dev)
    w_bin = torch.where(member, occ[:, None, :], zero)
    o_bin = torch.where(member, occ_o[:, None, :], zero)
    weights = torch.sum(w_bin, dim=2)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    tmin = torch.amin(torch.where(member, bin_t[None, None, :], inf), dim=2)
    tmax = torch.amax(torch.where(member, bin_t[None, None, :], -inf), dim=2)
    # weighted linear re-fit of the perpendicular offset o(t) = c0 + c1*t
    # over the run's bins (normal equations of the 2-param LS problem)
    St = torch.sum(w_bin * bin_t[None, None, :], dim=2)
    Stt = torch.sum(w_bin * bin_t[None, None, :] ** 2, dim=2)
    So = torch.sum(o_bin, dim=2)
    Sto = torch.sum(o_bin * bin_t[None, None, :], dim=2)
    det = weights * Stt - St * St
    safe = det > 1e-6
    c1 = torch.where(
        safe, (weights * Sto - St * So) / torch.where(safe, det, torch.ones_like(det)), zero
    )
    c0 = torch.where(weights > 0, (So - c1 * St) / torch.clamp(weights, min=1e-9), zero)
    c0 = torch.clamp(c0, -cfg.inlier_rho_tol, cfg.inlier_rho_tol)
    c1 = torch.clamp(c1, -0.2, 0.2)
    # pick the longest runs (integer counts: ties are the normal case)
    S = cfg.runs_per_peak
    sel = stable_top_k(counts.to(dtype), S, dim=1)[1]  # (P, S)
    pick = lambda a: torch.gather(a, 1, sel)
    counts, weights, tmin, tmax, c0, c1 = (
        pick(counts), pick(weights), pick(tmin), pick(tmax), pick(c0), pick(c1)
    )

    ok = (
        (counts >= cfg.min_inliers)
        & pk_valid[:, None]
        & torch.isfinite(tmin)
        & torch.isfinite(tmax)
    )

    if cfg.nfa_validation:
        # a-contrario gate on the run raster: every bin is occupied
        # independently with the image's own global occupancy rate p0
        inb_bin = torch.any(inb, dim=-1)  # (P, NB) bins with any valid sample
        n_occ = torch.sum(inb_bin & occb).to(torch.float64)
        p0 = n_occ / torch.clamp(torch.sum(inb_bin), min=1).to(torch.float64)
        p0 = torch.clamp(p0.to(dtype), 1e-6, 1.0 - 1e-6)
        n_run = torch.clamp(
            torch.round((tmax - tmin) / cfg.t_bin).to(torch.int32) + 1, 1, NB
        )  # (P, S) span in bins
        ok = ok & (nfa_log10(counts, n_run, p0, P, NB) < cfg.nfa_log10_eps)

    # endpoints: p = anchor + t*(-sin,cos); extend to bin edges
    ex = ex_p[:, None]
    ey = ey_p[:, None]
    bx = ax_p[:, None]
    by = ay_p[:, None]
    t0 = tmin - 0.5 * cfg.t_bin
    t1 = tmax + 0.5 * cfg.t_bin
    # apply the per-run local re-fit: p(t) = anchor + t*dir + (c0+c1*t)*normal
    o0 = c0 + c1 * t0
    o1 = c0 + c1 * t1
    x1 = bx + t0 * ex + o0 * cos_p[:, None]
    y1 = by + t0 * ey + o0 * sin_p[:, None]
    x2 = bx + t1 * ex + o1 * cos_p[:, None]
    y2 = by + t1 * ey + o1 * sin_p[:, None]
    segs = torch.stack([x1, y1, x2, y2], dim=-1).reshape(-1, 4)
    seg_mask = ok.reshape(-1)
    seg_weight = torch.where(seg_mask, weights.reshape(-1), zero)
    segs = torch.where(seg_mask[:, None], segs, zero)

    # compact to the strongest candidates before the O(K^2) dedupe/merge
    # (most of the n_peaks*runs_per_peak slots fail the min_inliers gate)
    M = min(2 * cfg.max_output + cfg.max_output // 2, segs.shape[0])
    _, sel_idx = stable_top_k(seg_weight, M)
    segs = segs[sel_idx]
    seg_mask = seg_mask[sel_idx]
    seg_weight = seg_weight[sel_idx]

    # one-shot dedupe: drop a segment if a strictly stronger, nearly-parallel
    # segment overlaps it (adjacent Hough peaks produce near-duplicates)
    order = torch.arange(segs.shape[0], device=dev)
    dominated_by = (
        _near_collinear(segs, segs, 2.0, 0.6, 3.0)
        & (
            (seg_weight[None, :] > seg_weight[:, None])
            | (
                (seg_weight[None, :] == seg_weight[:, None])
                & (order[None, :] < order[:, None])
            )
        )
        & seg_mask[None, :]
    )
    seg_mask = seg_mask & ~torch.any(dominated_by, dim=1)

    # compact dedupe survivors to 1.5x the output capacity before the
    # O(K^2)-per-round merge (stable order preserved).  Beyond-capacity
    # survivors are the weakest by support weight, the same candidates the
    # final top-`max_output` cut would shed anyway.
    Mc = min(cfg.max_output + cfg.max_output // 2, segs.shape[0])
    if Mc < segs.shape[0]:
        keep_idx = stable_top_k(
            torch.where(seg_mask, seg_weight, torch.full_like(seg_weight, -1.0)), Mc
        )[1]
        keep_idx = torch.sort(keep_idx).values  # stable relative order for the merge
        segs = segs[keep_idx]
        seg_mask = seg_mask[keep_idx]

    segs = line_ops.align_left_right(segs)
    merged, merged_mask = line_ops.merge_break_lines(
        segs,
        seg_mask,
        cfg.merge_dist,
        cfg.merge_angle_deg,
        cfg.min_length,
        max_iters=cfg.max_merge_iters,
    )

    # final fixed-capacity output: keep the longest max_output segments.
    # This bounds every downstream consumer's line axis (the proposal
    # engine's per-ROI merge is O(L^2) in this capacity).
    K = min(cfg.max_output, merged.shape[0])
    lens = torch.where(merged_mask, line_ops.line_lengths(merged), zero)
    _, out_idx = stable_top_k(lens, K)
    return merged[out_idx], merged_mask[out_idx] & (lens[out_idx] > 0)


def _claimed_mask(shape, psi, lines, mask, rho_tol: float, ang_tol_deg: float):
    """(H, W) bool: pixels geometrically claimed by the accepted segments
    (within `rho_tol` of the segment, inside its span +-2 px, gradient normal
    within `ang_tol_deg` of the segment normal), in the lines' dtype.

    The segments go through in chunks broadcast over (H, W) and OR-reduced:
    one launch per elementwise op per chunk instead of one per segment.  A
    chunk's (chunk, H, W) float64 temporaries stay near 128 MB each."""
    H, W = shape
    dtype = lines.dtype
    dev = lines.device
    ys = torch.arange(H, dtype=dtype, device=dev)[:, None]
    xs = torch.arange(W, dtype=dtype, device=dev)[None, :]
    ang_tol = math.radians(ang_tol_deg)
    chunk = max(1, (1 << 27) // (H * W * 8))
    claimed = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for c0 in range(0, lines.shape[0], chunk):
        seg = lines[c0 : c0 + chunk]
        x1, y1, x2, y2 = (seg[:, k, None, None] for k in range(4))
        dx, dy = x2 - x1, y2 - y1
        L = torch.sqrt(dx * dx + dy * dy) + 1e-9
        ux, uy = dx / L, dy / L
        rx = xs - x1
        ry = ys - y1
        perp = torch.abs(rx * (-uy) + ry * ux)
        t = rx * ux + ry * uy
        normal_ang = torch.remainder(torch.atan2(dy, dx) + math.pi / 2, math.pi)
        ang_ok = _angle_dist_pi(psi, normal_ang) < ang_tol
        hit = (
            mask[c0 : c0 + chunk, None, None]
            & (perp <= rho_tol)
            & (t >= -2.0)
            & (t <= L + 2.0)
            & ang_ok
        )
        claimed = claimed | torch.any(hit, dim=0)
    return claimed


def detect_line_segments_recover(gray: torch.Tensor, cfg: DetectConfig = DetectConfig()):
    """Two-pass detection with ADDITIVE short-segment recovery.

    Pass 1 is exactly `detect_line_segments(gray, cfg)` — its output slots
    are preserved verbatim (same segments, same length-descending order).
    Pass 2 reruns the extraction on the residual edge field (pass-1 claimed
    pixels suppressed) with a lower run gate (`short_min_inliers`) and its
    own peak budget, recovering short structures whose Hough evidence lost to
    long segments (the reference's region growers find these locally,
    lsd.cpp:637).  Pass-2 segments dominated by a pass-1 segment are dropped;
    survivors fill the extra `short_extra_capacity` output slots by length.

    Returns (lines (K + short_extra_capacity, 4), mask) like
    detect_line_segments."""
    l1, m1 = detect_line_segments(gray, cfg)
    H, W = gray.shape
    g = gaussian_blur5(gray)
    gx, gy = image_ops.sobel3(g)
    psi = torch.remainder(torch.atan2(gy, gx), math.pi)
    claimed = _claimed_mask((H, W), psi, l1, m1, cfg.claim_rho_px, cfg.claim_angle_deg)
    cfg2 = dataclasses.replace(cfg, min_inliers=cfg.short_min_inliers, n_peaks=cfg.short_n_peaks)
    l2, m2 = detect_line_segments(gray, cfg2, suppress=claimed)

    # dominance dedupe: drop pass-2 segments a pass-1 segment already covers
    m2 = m2 & ~torch.any(m1[:, None] & _near_collinear(l1, l2, 3.0, 0.5, 5.0), dim=0)

    # pass-1 keeps its slots verbatim (priority offset); pass-2 survivors
    # follow by length, so consumers of the plain detector see an unchanged
    # prefix
    K = l1.shape[0]
    K_out = K + cfg.short_extra_capacity
    all_lines = torch.cat([l1, l2], dim=0)
    all_mask = torch.cat([m1, m2], dim=0)
    zero = torch.zeros((), dtype=all_lines.dtype, device=all_lines.device)
    lens = torch.where(
        all_mask, torch.linalg.norm(all_lines[:, 2:4] - all_lines[:, 0:2], dim=-1), zero
    )
    first = torch.arange(all_lines.shape[0], device=all_lines.device) < K
    prio = lens + torch.where(first, torch.full_like(lens, 1e6), zero)
    prio = torch.where(all_mask, prio, zero)
    _, sel = stable_top_k(prio, min(K_out, all_lines.shape[0]))
    return all_lines[sel], all_mask[sel] & (prio[sel] > 0)


def detector_for(cfg: DetectConfig):
    """The detector the SLAM front ends run for `cfg`: the two-pass
    `detect_line_segments_recover` with `short_recovery`, else the plain
    `detect_line_segments` (JAX slam/online.py:216-225, pipeline.py:426-428)."""
    return detect_line_segments_recover if cfg.short_recovery else detect_line_segments


def downsample2(gray: torch.Tensor) -> torch.Tensor:
    """One pyramid level: Gaussian blur then 2x decimation (the reference's
    per-octave pyramid step, binary_descriptor.cpp:352-372 /
    LSDDetector.cpp:55-102 with reductionRatio = 2)."""
    return gaussian_blur5(gray)[::2, ::2]


def _clip_segments_to_image(lines: torch.Tensor, W: int, H: int):
    """Clip segments to the image rectangle along their own direction (slab
    intersection); returns (clipped lines, still-nonempty mask)."""
    a = lines[:, 0:2]
    d = lines[:, 2:4] - a
    lo = torch.tensor([0.0, 0.0], dtype=lines.dtype, device=lines.device)
    hi = torch.tensor([W - 1.0, H - 1.0], dtype=lines.dtype, device=lines.device)
    safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (lo - a) / safe_d
    t1 = (hi - a) / safe_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=1)
    tmin_c = torch.clamp(tmin, 0.0, 1.0)
    tmax_c = torch.clamp(tmax, 0.0, 1.0)
    p1 = a + tmin_c[:, None] * d
    p2 = a + tmax_c[:, None] * d
    return torch.cat([p1, p2], dim=1), tmax_c > tmin_c


def detect_line_segments_octaves(
    gray: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    n_octaves: int = 1,
    return_octaves: bool = False,
):
    """Multi-octave detection (numOfOctave_ / Octave_ratio = 2 semantics of
    the reference wrapper, line_lbd_allclass.cpp:114-127): detect on each
    pyramid level, scale endpoints back to octave-0 pixels, then a
    cross-octave dedupe with FINE priority (OctaveKeyLines keeps the
    higher-resolution observation of a structure, binary_descriptor.cpp:
    796-1150): a coarser line survives only if no finer, near-collinear line
    covers most of its extent.

    Returns (lines (K, 4), mask) in octave-0 coordinates, K =
    min(max_output, n_octaves * per-octave K); with `return_octaves`, also the
    (K,) int32 octave each segment was detected in (the provenance
    `lbd_descriptors_octaves` takes)."""
    per_octave = []
    img = gray
    for o in range(n_octaves):
        lines_o, mask_o = detect_line_segments(img, cfg)
        scale = float(2**o)
        # pixel-centre mapping: x_full = scale * x + (scale - 1) / 2
        lines_o = lines_o * scale + (scale - 1.0) / 2.0
        if o > 0:
            # coarse-octave bin-edge extension overshoots by up to
            # 2^o * t_bin px once scaled back: clip to the image rectangle
            lines_o, in_img = _clip_segments_to_image(lines_o, gray.shape[1], gray.shape[0])
            mask_o = mask_o & in_img
        per_octave.append((lines_o, mask_o))
        if o + 1 < n_octaves:
            img = downsample2(img)
    if n_octaves == 1:
        lines0, mask0 = per_octave[0]
        if return_octaves:
            octs = torch.zeros((lines0.shape[0],), dtype=torch.int32, device=gray.device)
            return lines0, mask0, octs
        return lines0, mask0
    lines = torch.cat([l for l, _ in per_octave], dim=0)
    mask = torch.cat([m for _, m in per_octave], dim=0)
    oct_id = torch.cat(
        [torch.full((l.shape[0],), o, device=gray.device) for o, (l, _) in enumerate(per_octave)]
    )
    covered_by_finer = (
        _near_collinear(lines, lines, cfg.merge_dist, 0.5, cfg.merge_angle_deg)
        & (oct_id[None, :] < oct_id[:, None])
        & mask[None, :]
    )
    mask = mask & ~torch.any(covered_by_finer, dim=1)
    K = min(cfg.max_output, lines.shape[0])
    zero = torch.zeros((), dtype=lines.dtype, device=lines.device)
    lens = torch.where(mask, line_ops.line_lengths(lines), zero)
    # octave-0 lines always make the cut (a coarse addition never displaces
    # one); coarser octaves fill the remaining slots by length
    BIG = 4.0 * math.hypot(*gray.shape)
    prio = torch.where(lens > 0, lens + BIG * (oct_id == 0).to(lens.dtype), zero)
    _, out_idx = stable_top_k(prio, K)
    out_mask = mask[out_idx] & (lens[out_idx] > 0)
    if return_octaves:
        return lines[out_idx], out_mask, oct_id[out_idx].to(torch.int32)
    return lines[out_idx], out_mask
