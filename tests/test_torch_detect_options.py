"""Port parity: the line detector's options (ops/detect.py) against the JAX
package — the NFA gate, `suppress=`, the claim mask and the octave pyramid
(the two-pass short-segment recovery: tests/test_torch_cli_lines.py, which
shares its JAX compile with `cli detect-lines --short-recovery`).

The detector is a set function between the packages (an atan2 ulp moves a
pixel's bin; see tests/test_torch_detect.py), so whole-detector outputs are
compared as sets (`torch_parity.assert_same_segment_sets`: counts within 5 %,
>= 95 % of either side matched within 0.5 px).  Everything fed identical
inputs is held tighter: the claim mask and the segment clipping bit-equal in
float64, the NFA term to the stated tolerance (the two lgammas differ in the
last bits).  One JAX compile per configuration and image size.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_parity import assert_same_segment_sets, to_j, to_np, to_t

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu_torch.ops import detect as tdet
from cube_slam_wu_tpu_torch.utils import synth

SEQ = synth.make_sequence(n_frames=2, n_objects=3, size=(240, 320), seed=1, speed=3.0)
FRAMES = [im.astype(np.float32) for im in SEQ.images]


def _valid(lines, mask):
    return to_np(lines)[to_np(mask)]


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_nfa_log10(counts, n_run, p0, P, NB):
    """The JAX detector's NFA term (cube_slam_wu_tpu/ops/detect.py:321-340),
    on given counts, spans and occupancy rate."""
    dtype = p0.dtype
    k_run = jnp.minimum(counts, n_run)
    js = jnp.arange(NB + 1, dtype=dtype)
    nf = n_run.astype(dtype)[..., None]
    kf = k_run.astype(dtype)[..., None]
    logterm = (
        gammaln(nf + 1.0) - gammaln(js + 1.0) - gammaln(nf - js + 1.0)
        + js * jnp.log(p0) + (nf - js) * jnp.log1p(-p0)
    )
    term_ok = (js >= kf) & (js <= nf)
    tail = jnp.sum(jnp.where(term_ok, jnp.exp(logterm), 0.0), axis=-1)
    return np.log10(P * NB * NB / 2.0) + jnp.log10(jnp.maximum(tail, 1e-300))


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_nfa_term_against_jax_formula(dt):
    """Identical (counts, n_run, p0): float64 within 1e-9 in log10(NFA).
    float32 within 1e-3 where the tail is a normal float32 (> 1e-37): the
    lgammas differ in the last bits, and their differences cancel terms of
    up to ~860; below that the tail is subnormal or underflows (-inf) on one
    side only, and only its sign against eps is compared.  The gate's
    decision at eps = 1 is the same everywhere."""
    rng = np.random.default_rng(3)
    NB, P = 202, 384
    n_run = rng.integers(1, NB + 1, size=(64, 6)).astype(np.int32)
    counts = np.minimum(rng.integers(0, NB + 1, size=(64, 6)), n_run + 3).astype(np.int64)
    for p0 in (0.02, 0.3, 1e-6):
        t = tdet.nfa_log10(to_t(counts), to_t(n_run), torch.tensor(p0, dtype=getattr(torch, dt)),
                           P, NB)
        j = _jax_nfa_log10(to_j(counts), to_j(n_run), jnp.asarray(p0, getattr(jnp, dt)), P, NB)
        t, j = to_np(t), to_np(j)
        np.testing.assert_array_equal(t < 0.0, j < 0.0)
        if dt == "float64":
            np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        else:
            one = np.isinf(t) != np.isinf(j)
            assert (np.where(np.isinf(t), j, t)[one] < -30.0 + np.log10(P * NB * NB / 2.0)).all()
        fin = np.isfinite(j) & np.isfinite(t)
        if dt == "float32":
            fin &= j > -37.0 + np.log10(P * NB * NB / 2.0)
        np.testing.assert_allclose(t[fin], j[fin], atol=1e-9 if dt == "float64" else 1e-3, rtol=0)


CFG_NFA = dict(nfa_validation=True)


@pytest.mark.parametrize("k", [0, 1])
def test_detect_with_nfa_as_sets(k):
    img = FRAMES[k]
    jl = _valid(*jdet.detect_line_segments(to_j(img), jdet.DetectConfig(**CFG_NFA)))
    tl = _valid(*tdet.detect_line_segments(to_t(img), tdet.DetectConfig(**CFG_NFA)))
    assert_same_segment_sets(jl, tl, min_count=8)


def test_nfa_rejects_noise():
    """Twin of tests/test_detect.py::test_nfa_rejects_noise on the port: on
    pure noise the NFA gate reports (near-)nothing while the run gate alone
    lets spurious alignments through."""
    rng = np.random.default_rng(0)
    img = to_t(rng.uniform(0, 255, size=(160, 200)))
    base = _valid(*tdet.detect_line_segments(img))
    gated = _valid(*tdet.detect_line_segments(img, tdet.DetectConfig(nfa_validation=True)))
    assert len(base) > 0
    assert len(gated) <= max(2, len(base) // 4), (len(base), len(gated))


def _psi(img):
    g = tdet.gaussian_blur5(to_t(img))
    from cube_slam_wu_tpu_torch.ops import image as image_ops

    gx, gy = image_ops.sobel3(g)
    return torch.remainder(torch.atan2(gy, gx), np.pi)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_claimed_mask_bit_equal(dt):
    """Same psi, same segments (the pass-1 output on frame 0, masked slots
    included), same tolerances: the same claimed pixels."""
    img = FRAMES[0]
    H, W = img.shape
    lines, mask = tdet.detect_line_segments(to_t(img))
    lines = to_np(lines).astype(dt)
    mask = to_np(mask)
    psi = to_np(_psi(img)).astype(dt)
    cfg = jdet.DetectConfig()
    j = jdet._claimed_mask((H, W), to_j(psi), to_j(lines), to_j(mask), cfg.claim_rho_px,
                           cfg.claim_angle_deg)
    t = tdet._claimed_mask((H, W), to_t(psi), to_t(lines), to_t(mask), cfg.claim_rho_px,
                           cfg.claim_angle_deg)
    assert to_np(j).sum() > 500
    np.testing.assert_array_equal(to_np(j), to_np(t))


def test_suppress_removes_pixels_from_votes_and_support():
    """`suppress=` on the same mask (the claim mask of frame 1's pass-1
    segments): the edge-pixel list holds no suppressed pixel, and the
    detector's output matches JAX's with the same mask as sets."""
    img = FRAMES[1]
    H, W = img.shape
    l1, m1 = tdet.detect_line_segments(to_t(img))
    claimed = tdet._claimed_mask((H, W), _psi(img), l1, m1, 1.5, 8.0)
    cfg = tdet.DetectConfig(min_inliers=4.0, n_peaks=512)
    (fw, fx, fy, _), (keep, _, _) = tdet.edge_pixels(to_t(img), cfg, claimed)
    on = fw > 0
    assert not claimed[fy[on].long(), fx[on].long()].any()
    assert not (keep & claimed).any()
    jl = _valid(*jdet.detect_line_segments(
        to_j(img), jdet.DetectConfig(min_inliers=4.0, n_peaks=512), suppress=to_j(to_np(claimed))))
    tl = _valid(*tdet.detect_line_segments(to_t(img), cfg, suppress=claimed))
    assert_same_segment_sets(jl, tl, min_count=2)
    plain = _valid(*tdet.detect_line_segments(to_t(img), cfg))
    assert len(tl) < len(plain)


def test_octaves_as_sets():
    """Two octaves with provenance: the valid sets match JAX's, and matched
    segments come from the same octave; the coarse ones lie in the image."""
    img = FRAMES[0]
    H, W = img.shape
    # the JAX function under one jit: eagerly its dedupe compiles op by op
    octaves = jax.jit(jdet.detect_line_segments_octaves,
                      static_argnames=("cfg", "n_octaves", "return_octaves"))
    jl, jm, jo = octaves(to_j(img), jdet.DetectConfig(), n_octaves=2, return_octaves=True)
    tl, tm, to = tdet.detect_line_segments_octaves(to_t(img), tdet.DetectConfig(), n_octaves=2,
                                                   return_octaves=True)
    assert to.dtype == torch.int32 and to.shape == (384,)
    a, b = _valid(jl, jm), _valid(tl, tm)
    assert_same_segment_sets(a, b, min_count=8)
    oa, ob = to_np(jo)[to_np(jm)], to_np(to)[to_np(tm)]
    for o in (0, 1):
        assert abs(int((oa == o).sum()) - int((ob == o).sum())) <= max(1, 0.05 * len(a))
    assert (ob == 1).any()
    c = b[ob == 1]
    assert (c[:, [0, 2]] <= W - 1 + 1e-3).all() and (c[:, [1, 3]] <= H - 1 + 1e-3).all()
    assert (c >= -1e-3).all()


def test_octave_single_equals_base():
    """Twin of tests/test_detect.py::test_octave_single_equals_base."""
    img = np.full((120, 160), 40.0)
    img[30:90, 40:120] = 200.0
    l0, m0 = tdet.detect_line_segments(to_t(img))
    l1, m1, o1 = tdet.detect_line_segments_octaves(to_t(img), n_octaves=1, return_octaves=True)
    assert torch.equal(l0, l1) and torch.equal(m0, m1) and not o1.any()


def test_clip_segments_to_image_bit_equal():
    rng = np.random.default_rng(4)
    lines = rng.uniform(-40, 360, size=(64, 4))
    lines[:4, 2] = lines[:4, 0]  # vertical: a zero direction component
    for j, t in zip(jdet._clip_segments_to_image(to_j(lines), 320, 240),
                    tdet._clip_segments_to_image(to_t(lines), 320, 240)):
        np.testing.assert_array_equal(to_np(j), to_np(t))


def test_detect_config_is_the_jax_one():
    """Same fields and defaults, so a configuration crosses by name."""
    assert dataclasses.asdict(tdet.DetectConfig()) == dataclasses.asdict(jdet.DetectConfig())
