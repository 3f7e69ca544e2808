"""The port's float64 `ops/detect.py::gaussian_blur5` is bit-equal to the
JAX package's on the CPU.

XLA's CPU code for JAX's `tensordot` over the five taps is a chain of fused
multiply-adds in tap order; the port emulates an exact fused multiply-add in
float64 (`fma64`, Boldo and Melquiond's rounding-to-odd algorithm), so the
blurred image, and with it every tie the non-maximum suppression breaks on a
flat-shaded plateau, is the same bits.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu_torch.ops import detect as tdet

_jax_blur = jax.jit(jdet.gaussian_blur5)


def test_gaussian_blur5_float64_bit_equal_to_jax():
    """A seeded random u8 image at 480x640 (the detector tests' frames are
    held the same way by test_torch_detect.py::test_gaussian_blur5)."""
    img = np.random.default_rng(0).integers(0, 256, size=(480, 640)).astype(np.float64)
    ref = np.asarray(_jax_blur(jnp.asarray(img)))
    ours = tdet.gaussian_blur5(torch.from_numpy(img.copy())).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_fma64_rounds_once():
    """fma64 against the exact a*b + c (rational arithmetic) rounded once,
    on products whose low part a plain multiply-add loses."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=3000)
    b = rng.normal(size=3000)
    c = -a * b * (1.0 + rng.normal(size=3000) * 1e-9)  # near-cancelling sums
    c[:1000] = rng.normal(size=1000) * 1e-3
    got = tdet.fma64(*(torch.from_numpy(x.copy()) for x in (a, b, c))).numpy()
    exact = [float(fractions.Fraction(x) * fractions.Fraction(y) + fractions.Fraction(z))
             for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.asarray(exact))
    assert np.any(got != a * b + c)  # the plain two-rounding result differs
