"""Port parity: ops/image.py and ops/cuda_kernels.py (the module that holds
the EDT row kernel) against the JAX package.

Everything here is exact integer arithmetic in float32 on u8-valued images,
so the comparisons are BIT-EQUAL, with one stated exception: on an image with
no edge at all the distances are ~1e6 (not exact integers) and the direct and
the reduced (fused multiply-add) forms differ in the last bits: rtol 1e-6.

The JAX row pass is run both ways the JAX package's own tests run it on the
CPU: the Pallas kernel in interpret mode and the dense reference
(`distance_transform(use_pallas=False)`).
"""

import functools

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from torch_parity import to_j, to_np, to_t

import jax.numpy as jnp

from cube_slam_wu_tpu.ops import image as jimg
from cube_slam_wu_tpu.ops.pallas_kernels import edt_row_min as j_edt_row_min
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.ops import cuda_kernels
from cube_slam_wu_tpu_torch.ops import image as timg
from cube_slam_wu_tpu_torch.utils import synth as tsynth


def _rendered(size=(120, 160), seed=0):
    seq = tsynth.make_sequence(n_frames=1, n_objects=3, size=size, seed=seed)
    return seq.images[0].astype(np.float32), seq


@functools.cache
def _images():
    rng = np.random.default_rng(0)
    out = {"render": _rendered()[0]}
    out["random_u8"] = rng.integers(0, 256, (97, 131)).astype(np.float32)
    blobs = ndi.gaussian_filter(rng.random((60, 200)), 3.0)
    blobs = (blobs > np.median(blobs)) * 180.0 + rng.integers(0, 40, (60, 200))
    out["blobs"] = blobs.astype(np.float32)
    return out


@pytest.mark.parametrize("name", ("blobs", "random_u8", "render"))
def test_sobel_nms_canny_bit_equal(name):
    img = _images()[name]
    jg, tg = to_j(img), to_t(img)
    jgx, jgy = jimg.sobel3(jg)
    tgx, tgy = timg.sobel3(tg)
    np.testing.assert_array_equal(to_np(jgx), to_np(tgx))
    np.testing.assert_array_equal(to_np(jgy), to_np(tgy))
    jmag, tmag = jnp.abs(jgx) + jnp.abs(jgy), tgx.abs() + tgy.abs()
    np.testing.assert_array_equal(
        to_np(jimg._nms(jmag, jgx, jgy)), to_np(timg._nms(tmag, tgx, tgy))
    )
    for low, high in ((80.0, 200.0), (30.0, 80.0)):
        je = to_np(jimg.canny(jg, low, high))
        te = to_np(timg.canny(tg, low, high))
        assert je.any(), "test image must have edges"
        np.testing.assert_array_equal(je, te)


def test_canny_batched_equals_per_image():
    imgs = np.stack([_rendered(seed=s)[0] for s in range(3)])
    batched = to_np(timg.canny(to_t(imgs)))
    for k in range(3):
        np.testing.assert_array_equal(batched[k], to_np(timg.canny(to_t(imgs[k]))))
        np.testing.assert_array_equal(batched[k], to_np(jimg.canny(to_j(imgs[k]))))


def test_rgb_to_gray_and_replicate_roi():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.float64)
    np.testing.assert_array_equal(
        to_np(jimg.rgb_to_gray(to_j(rgb))), to_np(timg.rgb_to_gray(to_t(rgb)))
    )
    img = _images()["random_u8"]
    a = to_np(jimg.replicate_roi(to_j(img), 5, 7, 30, 25))
    b = to_np(timg.replicate_roi(to_t(img), 5, 7, 30, 25))
    np.testing.assert_array_equal(a, b)
    bb = to_np(
        timg.replicate_roi(
            to_t(img), torch.tensor([5, 0]), torch.tensor([7, 2]),
            torch.tensor([30, 130]), torch.tensor([25, 96]),
        )
    )
    np.testing.assert_array_equal(bb[0], a)
    np.testing.assert_array_equal(
        bb[1], to_np(jimg.replicate_roi(to_j(img), 0, 2, 130, 96))
    )


@functools.cache
def _edge_maps():
    """Edge masks with edges: ragged shapes, plus a batch."""
    rng = np.random.default_rng(3)
    out = {}
    for name, img in _images().items():
        out[name] = to_np(jimg.canny(to_j(img), 30.0, 80.0))
    out["sparse_50x70"] = rng.random((50, 70)) < 0.03
    one = np.zeros((33, 41), bool)
    one[10, 20] = True
    out["single_pixel"] = one
    return out


def _g2(edge):
    g = to_np(jimg._edt_1d_columns(to_j(edge)))
    return (np.minimum(g, np.float32(1e6)) ** 2).astype(np.float32)


@pytest.mark.parametrize("name", ("blobs", "random_u8", "render", "single_pixel", "sparse_50x70"))
def test_edt_columns_and_row_min_bit_equal(name):
    edge = _edge_maps()[name]
    assert edge.any()
    jcol = to_np(jimg._edt_1d_columns(to_j(edge)))
    tcol = to_np(timg._edt_1d_columns(to_t(edge)))
    np.testing.assert_array_equal(jcol, tcol)
    g2 = _g2(edge)
    plain = to_np(cuda_kernels.edt_row_min_plain(to_t(g2)))
    assert plain.dtype == np.float32
    # JAX route 1: the Pallas kernel in interpret mode
    np.testing.assert_array_equal(plain, to_np(j_edt_row_min(to_j(g2), interpret=True)))
    # JAX route 2: the dense reference
    dense = to_np(jimg.distance_transform(to_j(edge), use_pallas=False))
    np.testing.assert_array_equal(plain, dense)
    # the wrapper on a CPU tensor is the plain version, through the port's
    # distance_transform as well
    np.testing.assert_array_equal(plain, to_np(cuda_kernels.edt_row_min(to_t(g2))))
    np.testing.assert_array_equal(plain, to_np(timg.distance_transform(to_t(edge))))
    # scipy's exact EDT, exactly
    ref = ndi.distance_transform_edt(~edge).astype(np.float32)
    np.testing.assert_array_equal(plain, ref)


def test_edt_row_min_batch():
    shapes = [e for e in _edge_maps().values() if e.shape == (97, 131)]
    rng = np.random.default_rng(5)
    batch = np.stack([shapes[0]] + [rng.random((97, 131)) < p for p in (0.01, 0.2)])
    g2 = np.stack([_g2(e) for e in batch])
    out = to_np(cuda_kernels.edt_row_min_plain(to_t(g2)))
    for k in range(3):
        np.testing.assert_array_equal(
            out[k], to_np(j_edt_row_min(to_j(g2[k]), interpret=True))
        )


def test_edt_no_edge_at_all():
    """No edge anywhere: values ~1e6, compared at rtol 1e-6 (the direct and
    the reduced form round differently there)."""
    edge = np.zeros((40, 52), bool)
    g2 = _g2(edge)
    plain = to_np(cuda_kernels.edt_row_min_plain(to_t(g2)))
    assert np.isfinite(plain).all() and plain.min() > 9e5
    np.testing.assert_allclose(
        plain, to_np(j_edt_row_min(to_j(g2), interpret=True)), rtol=1e-6
    )
    np.testing.assert_allclose(
        plain, to_np(jimg.distance_transform(to_j(edge), use_pallas=False)), rtol=1e-6
    )


def test_roi_canny_distance_map_bit_equal():
    img, seq = _rendered(size=(120, 160), seed=1)
    det = seq.detections[0]
    assert len(det) >= 1
    rois = []
    for x, y, w, h, _ in det:
        rois.append(
            (max(int(x) - 10, 0), max(int(y) - 10, 0),
             min(int(x + w) + 10, 159), min(int(y + h) + 10, 119))
        )
    rois.append((5, 7, 150, 110))
    cols = [torch.tensor(c) for c in zip(*rois)]
    batched = to_np(timg.roi_canny_distance_map(to_t(img), *cols))
    assert batched.shape == (len(rois), 120, 160)
    for k, (x0, y0, x1, y1) in enumerate(rois):
        ref = to_np(jimg.roi_canny_distance_map(to_j(img), x0, y0, x1, y1))
        np.testing.assert_array_equal(batched[k], ref)
        single = to_np(timg.roi_canny_distance_map(to_t(img), x0, y0, x1, y1))
        np.testing.assert_array_equal(single, ref)


def test_synth_generator_bit_equal():
    """The port's own numpy generator equals the JAX package's bit for bit."""
    kw = dict(n_frames=3, n_objects=3, size=(96, 128), noise_px=0.5, seed=4)
    a, b = jsynth.make_sequence(**kw), tsynth.make_sequence(**kw)
    np.testing.assert_array_equal(a.K, b.K)
    np.testing.assert_array_equal(a.T_wc, b.T_wc)
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.detections, b.detections):
        np.testing.assert_array_equal(x, y)
    objs = [tsynth.SynthObject(np.array([0.3, 3.8, 0.42]), 0.45, np.array([0.55, 0.4, 0.42]))]
    jobjs = [jsynth.SynthObject(*o) for o in objs]
    a = jsynth.make_sequence(n_frames=2, size=(96, 128), objects=jobjs, ground_texture=4.0)
    b = tsynth.make_sequence(n_frames=2, size=(96, 128), objects=objs, ground_texture=4.0)
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x, y)


def test_wrapper_refuses_other_devices_and_wide_rows():
    g2 = torch.zeros((2, 4, 8))
    assert cuda_kernels.edt_row_min(g2).shape == (2, 4, 8)
    assert cuda_kernels.LAUNCHES["edt_row_min"] == 0  # CPU: plain, no launch
    with pytest.raises(RuntimeError):
        cuda_kernels.edt_row_min(torch.zeros((4, 8), device="meta"))
