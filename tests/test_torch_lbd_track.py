"""Port parity: the line-track route of the LBD stack (ops/lbd.py:
`int_gradients`, the gradient packing, `lbd_descriptors`, `l2_match`)
against the JAX package, and against the reference C++'s own descriptors in
tests/data/ref_oracle/lbd.npz.

Exact: the integer gradients (blur taps as XLA contracts them), the packing
round trip over its whole contract range, the matched sets and indices.
Tolerances: descriptors 1e-6 against JAX on the same lines and gradients
(float32 band sums in a different order); 3e-3 against the reference C++ with
its 256-bit codes bit-identical (as the JAX package's own oracle test).
"""

import pathlib

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from torch_parity import to_np

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu.ops import lbd as jlbd
from cube_slam_wu_tpu_torch.ops import lbd as tlbd
from cube_slam_wu_tpu_torch.utils import synth as tsynth

FIX = pathlib.Path(__file__).parent / "data" / "ref_oracle" / "lbd.npz"
SEQ = tsynth.make_sequence(n_frames=2, n_objects=3, size=(240, 320), speed=0.5, curve=0.002,
                           noise_px=0.8, seed=6, ground_texture=4.0)


@pytest.fixture(scope="module")
def frames():
    out = []
    for img in SEQ.images:
        g = img.astype(np.float32)
        lines, lmask = jax.device_get(jdet.detect_line_segments(jnp.asarray(g)))
        out.append((g, np.array(lines), np.array(lmask)))
    return out


def test_int_gradients_bit_equal():
    rng = np.random.default_rng(0)
    imgs = [SEQ.images[0].astype(np.float32), rng.integers(0, 256, (37, 53)).astype(np.float32)]
    for g in imgs:
        jgx, jgy = jax.device_get(jax.jit(jlbd.int_gradients)(jnp.asarray(g)))
        tgx, tgy = tlbd.int_gradients(torch.from_numpy(g))
        np.testing.assert_array_equal(jgx, to_np(tgx))
        np.testing.assert_array_equal(jgy, to_np(tgy))
        assert np.abs(to_np(tgx)).max() <= 1020 and np.abs(to_np(tgy)).max() <= 1020


def test_pack_gradients_contract_range():
    """Exact for every integer pair in [-1020, 1020] (sampled across the
    whole square, corners included); bit-equal to the JAX packing.  Beyond
    the contract the packing is not invertible, which is why it is stated,
    not checked on the device path."""
    v = np.arange(-1020, 1021, 7, dtype=np.float32)
    v = np.concatenate([v, [-1020.0, 1020.0]]).astype(np.float32)
    gx, gy = np.meshgrid(v, v, indexing="ij")
    packed = tlbd._pack_gradients(torch.from_numpy(gx), torch.from_numpy(gy))
    np.testing.assert_array_equal(to_np(packed), np.asarray(jlbd._pack_gradients(jnp.asarray(gx), jnp.asarray(gy))))
    dx, dy = tlbd._unpack_gradients(packed)
    np.testing.assert_array_equal(to_np(dx), gx)
    np.testing.assert_array_equal(to_np(dy), gy)
    # one step outside the range: gy = 1021 aliases into gx
    p = tlbd._pack_gradients(torch.tensor([0.0]), torch.tensor([1028.0]))
    assert to_np(tlbd._unpack_gradients(p)[1])[0] != 1028.0


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_lbd_descriptors_match_jax(frames, dtype):
    npd = np.float32 if dtype == "f32" else np.float64
    g, lines, lmask = frames[0]
    jd, jv = jlbd.lbd_descriptors(jnp.asarray(g.astype(npd)), jnp.asarray(lines), jnp.asarray(lmask))
    td, tv = tlbd.lbd_descriptors(torch.from_numpy(g.astype(npd)), torch.from_numpy(lines),
                                  torch.from_numpy(lmask))
    np.testing.assert_array_equal(np.asarray(jv), to_np(tv))
    np.testing.assert_allclose(np.asarray(jd)[lmask], to_np(td)[lmask], atol=1e-6)
    norms = np.linalg.norm(to_np(td)[lmask], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert lmask.sum() >= 20


def _ref_bits(desc256):
    return ((desc256[:, :, None] >> np.arange(8)[None, None, :]) & 1).astype(bool)


def _binarize_np(desc72):
    d9 = np.asarray(desc72).reshape(-1, 9, 8)
    a = np.asarray([c[0] for c in jlbd._COMBINATIONS])
    b = np.asarray([c[1] for c in jlbd._COMBINATIONS])
    return d9[:, a, :] > d9[:, b, :]


def test_lbd_descriptors_against_reference_oracle():
    """The reference C++'s own keylines and Sobel maps (cabinet image):
    descriptors within 3e-3 and the 256-bit codes bit-identical."""
    oracle = np.load(FIX)
    kl = oracle["cabinet_keylines"]
    desc, _ = tlbd.lbd_descriptors(
        torch.zeros((480, 640), dtype=torch.float32),
        torch.from_numpy(kl[:, :4].astype(np.float32)),
        torch.ones(len(kl), dtype=torch.bool),
        max_len=704,
        num_pixels=torch.from_numpy(kl[:, 5].astype(np.float32)),
        gradients=(torch.from_numpy(oracle["cabinet_dx"].astype(np.float32)),
                   torch.from_numpy(oracle["cabinet_dy"].astype(np.float32))),
    )
    d = np.abs(to_np(desc) - oracle["cabinet_desc72"])
    assert d.max() < 3e-3, d.max()
    assert (_binarize_np(to_np(desc)) == _ref_bits(oracle["cabinet_desc256"])).all()


@pytest.mark.parametrize("gate,mutual", [(80.0, True), (None, True), (80.0, False)])
def test_l2_match_frame_to_frame(frames, gate, mutual):
    """Frame 1's lines against frame 0's (the line-track weighting's use),
    with and without the midpoint gate and the mutual check."""
    (g0, l0, m0), (g1, l1, m1) = frames
    jd0, _ = jlbd.lbd_descriptors(jnp.asarray(g0), jnp.asarray(l0), jnp.asarray(m0))
    jd1, _ = jlbd.lbd_descriptors(jnp.asarray(g1), jnp.asarray(l1), jnp.asarray(m1))
    d0, d1 = np.array(jd0), np.array(jd1)
    kw = dict(max_midpoint_dist=gate, mutual=mutual)
    jf, jb, jm = jax.device_get(jlbd.l2_match(
        jnp.asarray(d1), jnp.asarray(d0), jnp.asarray(m1), jnp.asarray(m0),
        query_lines=jnp.asarray(l1), train_lines=jnp.asarray(l0), **kw))
    tf, tb, tm = tlbd.l2_match(
        torch.from_numpy(d1), torch.from_numpy(d0), torch.from_numpy(m1), torch.from_numpy(m0),
        query_lines=torch.from_numpy(l1), train_lines=torch.from_numpy(l0), **kw)
    np.testing.assert_array_equal(jm, to_np(tm))
    np.testing.assert_array_equal(jf[jm], to_np(tf)[jm])
    np.testing.assert_allclose(jb[jm], to_np(tb)[jm], atol=1e-6)
    assert to_np(tm).sum() >= 10 and len(l1) > 25


def test_l2_match_ties_and_gate_errors():
    """Equal distances pick the lower train index (as jnp.argmin); the gate
    needs both line sets."""
    q = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    t = torch.tensor([[0.0, 1.0], [1.0, 0.0], [1.0, 0.0]])
    m2, m3 = torch.ones(2, dtype=torch.bool), torch.ones(3, dtype=torch.bool)
    f, b, m = tlbd.l2_match(q, t, m2, m3, mutual=False)
    jf, jb, jm = jlbd.l2_match(jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.ones(2, bool),
                               jnp.ones(3, bool), mutual=False)
    np.testing.assert_array_equal(to_np(f), np.asarray(jf))
    assert to_np(f).tolist() == [1, 0]
    with pytest.raises(ValueError, match="max_midpoint_dist"):
        tlbd.l2_match(q, t, m2, m3, max_midpoint_dist=10.0)
