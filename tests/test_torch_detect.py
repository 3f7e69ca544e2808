"""Port parity: ops/lines.py and ops/detect.py against the JAX package.

Each stage is fed the SAME inputs in both frameworks rather than chaining
stages: elementary functions (atan2, cos, exp) differ by an ulp between XLA
and PyTorch, so a pixel's angle or offset bin can flip at a boundary, and a
chained comparison would test that noise instead of the port.  For the same
reason the whole detector is compared as a SET of segments.
"""

import math

import numpy as np
import pytest
import torch

from torch_parity import to_j, to_np, to_t

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu.ops import lines as jlines
from cube_slam_wu_tpu_torch.ops import detect as tdet
from cube_slam_wu_tpu_torch.ops import lines as tlines
from cube_slam_wu_tpu_torch.ops.topk import stable_top_k
from cube_slam_wu_tpu_torch.utils import synth


def _line_set(rng, n=40, size=200.0, chains=True):
    """Random padded line set with some collinear broken chains."""
    lines = rng.uniform(0, size, (n, 4))
    if chains:
        for k in range(0, 12, 3):
            p = rng.uniform(20, size - 20, 2)
            d = rng.normal(0, 1, 2)
            d /= np.linalg.norm(d)
            for j in range(3):
                a = p + d * (j * 30.0)
                b = p + d * (j * 30.0 + 26.0) + rng.normal(0, 0.3, 2)
                lines[k + j] = [*a, *b]
    mask = rng.random(n) < 0.8
    return lines.astype(np.float32), mask


@pytest.mark.parametrize("seed", [0, 1])
def test_line_utilities(seed):
    rng = np.random.default_rng(seed)
    lines, mask = _line_set(rng)
    jl, tl = to_j(lines), to_t(lines)
    ja, ta = jlines.align_left_right(jl), tlines.align_left_right(tl)
    np.testing.assert_array_equal(to_np(ja), to_np(ta))
    for f in ("line_angles", "line_lengths", "line_midpoints"):
        np.testing.assert_allclose(
            to_np(getattr(jlines, f)(ja)), to_np(getattr(tlines, f)(ta)), atol=1e-5, rtol=1e-6
        )
    tl_, br_ = (30.0, 40.0), (150.0, 170.0)
    jm = jlines.inside_box_mask(jl, tl_, br_)
    tm = tlines.inside_box_mask(tl, torch.tensor(tl_), torch.tensor(br_))
    np.testing.assert_array_equal(to_np(jm), to_np(tm))
    r1 = rng.uniform(0, 100, (16, 4)).astype(np.float32)
    r2 = rng.uniform(0, 100, (16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(jlines.bbox_overlap_ratio(to_j(r1), to_j(r2))),
        to_np(tlines.bbox_overlap_ratio(to_t(r1), to_t(r2))), atol=1e-5,
    )
    np.testing.assert_allclose(
        to_np(jlines.point_boundary_dist(to_j(r1), to_j(r2[:, :2]))),
        to_np(tlines.point_boundary_dist(to_t(r1), to_t(r2[:, :2]))), atol=1e-5,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_break_lines_same_mask_same_segments(seed):
    rng = np.random.default_rng(seed)
    lines, mask = _line_set(rng)
    lines = to_np(jlines.align_left_right(to_j(lines)))
    jm_l, jm_m = jlines.merge_break_lines(to_j(lines), to_j(mask), 20.0, 5.0, 30.0)
    tm_l, tm_m = tlines.merge_break_lines(to_t(lines), to_t(mask), 20.0, 5.0, 30.0)
    np.testing.assert_array_equal(to_np(jm_m), to_np(tm_m))
    assert to_np(jm_m).sum() < mask.sum()  # something merged or was filtered
    m = to_np(jm_m)
    np.testing.assert_allclose(to_np(jm_l)[m], to_np(tm_l)[m], atol=1e-5)
    # batched call == per-set calls
    lines2, mask2 = _line_set(np.random.default_rng(seed + 10))
    lines2 = to_np(jlines.align_left_right(to_j(lines2)))
    bl, bm = tlines.merge_break_lines(
        to_t(np.stack([lines, lines2])), to_t(np.stack([mask, mask2])), 20.0, 5.0, 30.0
    )
    np.testing.assert_array_equal(to_np(bm[0]), to_np(tm_m))
    np.testing.assert_array_equal(to_np(bl[0]), to_np(tm_l))
    j2_l, j2_m = jlines.merge_break_lines(to_j(lines2), to_j(mask2), 20.0, 5.0, 30.0)
    np.testing.assert_array_equal(to_np(bm[1]), to_np(j2_m))


def test_stable_top_k_lower_index_first():
    x = torch.tensor([3.0, 5.0, 5.0, 0.0, 0.0, 0.0, 5.0])
    vals, idx = stable_top_k(x, 5)
    assert idx.tolist() == [1, 2, 6, 0, 3]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert np.array(ji).tolist() == idx.tolist()


def _frames(n=3, size=(240, 320)):
    seq = synth.make_sequence(n_frames=n, n_objects=3, size=size, seed=1, speed=3.0)
    return [im.astype(np.float32) for im in seq.images]


FRAMES = _frames()


def test_gaussian_blur5():
    """Bit-equal in float32 and float64: the port evaluates the same chain of
    fused multiply-adds (in float64 through the emulated `fma64`); the
    non-maximum suppression downstream breaks exact ties on flat-shaded
    plateaus, so an ulp here moves edge pixels."""
    for img in FRAMES[:2]:
        np.testing.assert_array_equal(
            to_np(jdet.gaussian_blur5(to_j(img))), to_np(tdet.gaussian_blur5(to_t(img)))
        )
        img64 = img.astype(np.float64)
        np.testing.assert_array_equal(
            to_np(jdet.gaussian_blur5(to_j(img64))), to_np(tdet.gaussian_blur5(to_t(img64)))
        )


def _jax_hough(flat_w, flat_x, flat_y, flat_psi, H, W, cfg):
    """The JAX detector's accumulation and peak extraction
    (ops/detect.py:160-196), on given edge-pixel lists."""
    dtype = flat_w.dtype
    NT = cfg.n_theta
    diag = math.hypot(H, W)
    NR = int(2 * diag / cfg.rho_bin) + 2
    tbin0 = jnp.floor(flat_psi / (math.pi / NT)).astype(jnp.int32) % NT
    acc = jnp.zeros((NT, NR), dtype)
    for dt in (-1, 0, 1):
        tb = (tbin0 + dt) % NT
        theta = (tb.astype(dtype) + 0.5) * (math.pi / NT)
        rho = flat_x * jnp.cos(theta) + flat_y * jnp.sin(theta)
        rb = jnp.clip(((rho + diag) / cfg.rho_bin).astype(jnp.int32), 0, NR - 1)
        acc = acc.at[tb, rb].add(flat_w)

    def max3(a, axis, wrap):
        lo = jnp.roll(a, 1, axis)
        hi = jnp.roll(a, -1, axis)
        if not wrap:
            idx = [slice(None)] * a.ndim
            idx[axis] = slice(0, 1)
            lo = lo.at[tuple(idx)].set(0.0)
            idx[axis] = slice(-1, None)
            hi = hi.at[tuple(idx)].set(0.0)
        return jnp.maximum(a, jnp.maximum(lo, hi))

    neigh = max3(max3(acc, 0, wrap=True), 1, wrap=False)
    is_peak = (acc >= neigh) & (acc > 0)
    peak_score = jnp.where(is_peak, acc, 0.0)
    top_vals, top_idx = jax.lax.top_k(peak_score.reshape(-1), cfg.n_peaks)
    return acc, top_vals, top_idx


@pytest.mark.parametrize("k", [0, 1])
def test_hough_accumulator_and_peaks_from_identical_edge_lists(k):
    """Same (flat_w, flat_x, flat_y, flat_psi) into both accumulators.  The
    bin of a vote depends on cos/sin of the bin angle, which may differ by an
    ulp, so a handful of votes may land in the neighbouring offset bin: the
    accumulators must agree exactly on all but 0.1 % of the bins and in total
    mass to 1e-6; the peak lists must share at least 97 % of their peaks."""
    img = FRAMES[k]
    H, W = img.shape
    cfg = tdet.DetectConfig()
    (fw, fx, fy, fpsi), _ = tdet.edge_pixels(to_t(img), cfg)
    assert int((fw > 0).sum()) > 500
    t_acc = tdet.hough_accumulate(fw, fx, fy, fpsi, H, W, cfg)
    t_vals, t_idx = tdet.hough_peaks(t_acc, cfg)
    j_acc, j_vals, j_idx = _jax_hough(
        to_j(to_np(fw)), to_j(to_np(fx)), to_j(to_np(fy)), to_j(to_np(fpsi)),
        H, W, jdet.DetectConfig(),
    )
    ja, ta = to_np(j_acc), to_np(t_acc)
    assert ja.shape == ta.shape
    assert (ja != ta).mean() < 1e-3
    np.testing.assert_allclose(ja.sum(), ta.sum(), rtol=1e-6)
    jp = set(to_np(j_idx)[to_np(j_vals) > 0].tolist())
    tp = set(to_np(t_idx)[to_np(t_vals) > 0].tolist())
    assert len(jp) > 20
    assert len(jp & tp) >= 0.97 * max(len(jp), len(tp))
    # same accumulator in -> same peaks out, exactly (stable selection)
    t2_vals, t2_idx = tdet.hough_peaks(to_t(ja), cfg)
    np.testing.assert_array_equal(to_np(t2_idx)[to_np(t2_vals) > 0], to_np(j_idx)[to_np(j_vals) > 0])
    # accumulating twice gives the same bits
    assert torch.equal(t_acc, tdet.hough_accumulate(fw, fx, fy, fpsi, H, W, cfg))


def _match_fraction(a, b, tol=0.5):
    """Fraction of segments of `a` with a segment of `b` whose both endpoints
    lie within `tol` px (either endpoint order)."""
    if len(a) == 0:
        return 1.0
    d_same = np.maximum(
        np.linalg.norm(a[:, None, 0:2] - b[None, :, 0:2], axis=-1),
        np.linalg.norm(a[:, None, 2:4] - b[None, :, 2:4], axis=-1),
    )
    d_swap = np.maximum(
        np.linalg.norm(a[:, None, 0:2] - b[None, :, 2:4], axis=-1),
        np.linalg.norm(a[:, None, 2:4] - b[None, :, 0:2], axis=-1),
    )
    return float((np.minimum(d_same, d_swap).min(axis=1) < tol).mean())


@pytest.mark.parametrize("k", [0, 1, 2])
def test_detect_line_segments_as_sets(k):
    """Whole detector on a rendered frame, compared as sets (see the module
    docstring for why): >= 95 % of either side's valid segments have a
    counterpart with both endpoints within 0.5 px, counts within 5 %."""
    img = FRAMES[k]
    jl, jm = jdet.detect_line_segments(to_j(img))
    tl, tm = tdet.detect_line_segments(to_t(img))
    assert to_np(jl).shape == to_np(tl).shape == (384, 4)
    a = to_np(jl)[to_np(jm)]
    b = to_np(tl)[to_np(tm)]
    assert len(a) >= 8
    assert abs(len(a) - len(b)) <= 0.05 * len(a)
    assert _match_fraction(a, b) >= 0.95
    assert _match_fraction(b, a) >= 0.95


def test_unported_detector_options_raise():
    """The options refused before they were ported now run (their parity:
    tests/test_torch_detect_options.py).  As in the JAX package,
    `detect_line_segments` does not read `short_recovery` (the two-pass
    detector is `detect_line_segments_recover`); an empty `suppress` mask
    changes nothing and a full one leaves no edge pixel; the NFA gate keeps a
    subset of the candidate runs."""
    img = to_t(FRAMES[0])
    plain = tdet.detect_line_segments(img)
    flag = tdet.detect_line_segments(img, tdet.DetectConfig(short_recovery=True))
    assert torch.equal(plain[0], flag[0]) and torch.equal(plain[1], flag[1])
    none = tdet.detect_line_segments(img, suppress=torch.zeros_like(img, dtype=torch.bool))
    assert torch.equal(plain[0], none[0]) and torch.equal(plain[1], none[1])
    full = tdet.detect_line_segments(img, suppress=torch.ones_like(img, dtype=torch.bool))
    assert not full[1].any()
    nfa_l, nfa_m = tdet.detect_line_segments(img, tdet.DetectConfig(nfa_validation=True))
    assert 0 < int(nfa_m.sum()) <= int(plain[1].sum()) + 2
