"""Port parity: the binary LBD codes, their Hamming matchers, the
reference-exact descriptor path and the octave descriptors (ops/lbd.py)
against the JAX package, and against the reference C++ dumps in
tests/data/ref_oracle/lbd.npz (the twins of tests/test_lbd_oracle_parity.py).

Tolerances: codes, words, distances, indices and masks bit-equal (integer
arithmetic); reference_gradients bit-equal (the same float64 numpy ops); the
reference-exact descriptors under 2e-6 of the oracle with 0 bit flips;
descriptors of identical inputs within 1e-5 of JAX's (float32 sums in
another order).
"""

import pathlib

import numpy as np
import pytest
import torch

from torch_parity import to_j, to_np, to_t

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu.ops import lbd as jlbd
from cube_slam_wu_tpu_torch.ops import lbd as tlbd

FIX = pathlib.Path(__file__).parent / "data" / "ref_oracle" / "lbd.npz"


@pytest.fixture(scope="module")
def oracle():
    return np.load(FIX)


def _ref_bits(desc256):
    """(L, 32) bytes -> (L, 32, 8) bool bits [pair, j]."""
    return ((desc256[:, :, None] >> np.arange(8)[None, None, :]) & 1).astype(bool)


def _words(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def _u32(x):
    return to_np(x).astype(np.uint32)


def test_popcount32_and_codes_bit_equal():
    rng = np.random.default_rng(0)
    w = _words(rng, 64)
    w[0] = 0
    w[1] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        _u32(tlbd._popcount32(to_t(w.astype(np.int64)))), _u32(jlbd._popcount32(to_j(w)))
    )
    desc = rng.normal(size=(40, 72)).astype(np.float32)
    desc[3, :8] = desc[3, 8:16]  # equal bands: the strict comparison's ties
    tw = tlbd.binarize_lbd(to_t(desc))
    assert tw.dtype == torch.int64 and int(tw.min()) >= 0 and int(tw.max()) < 2**32
    np.testing.assert_array_equal(_u32(tw), _u32(jlbd.binarize_lbd(to_j(desc))))
    b = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    np.testing.assert_array_equal(
        _u32(tlbd.pack_lbd_bytes(to_t(b))), _u32(jlbd.pack_lbd_bytes(to_j(b)))
    )


@pytest.mark.parametrize("seed", [1, 2])
def test_matchers_bit_equal(seed):
    """hamming_match, knn_match (k below, at and above the train capacity),
    radius_match and match_lines_filtered on the same words and masks; the
    query words are train rows with a few bits flipped, plus duplicates so
    that ties occur."""
    rng = np.random.default_rng(seed)
    t = _words(rng, 12)
    t[5] = t[4]  # a tie for every query near row 4
    q = t[rng.integers(0, 12, size=10)].copy()
    flips = rng.integers(0, 32, size=(10, 3))
    for r in range(10):
        for f in flips[r]:
            q[r, f % 8] ^= np.uint32(1) << np.uint32(f)
    qm = rng.random(10) < 0.8
    tm = rng.random(12) < 0.75
    tm[4] = tm[5] = True
    J = lambda a: to_j(a)
    T = lambda a: to_t(a.astype(np.int64)) if a.dtype == np.uint32 else to_t(a)
    args_j, args_t = (J(q), J(t), J(qm), J(tm)), (T(q), T(t), T(qm), T(tm))
    for name, kw in (("hamming_match", dict(max_dist=25)), ("radius_match", dict(max_dist=12)),
                     ("match_lines_filtered", dict(max_dist=25)),
                     ("knn_match", dict(k=3)), ("knn_match", dict(k=12)),
                     ("knn_match", dict(k=15))):
        jo = getattr(jlbd, name)(*args_j, **kw)
        to = getattr(tlbd, name)(*args_t, **kw)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=f"{name} {kw}")
        dist = to[0] if name == "radius_match" else to[1]
        assert dist.dtype == torch.int32


@pytest.mark.parametrize("name,shape", [("cabinet", (480, 640)), ("tum0", (480, 640))])
def test_exact_path_descriptor_parity(oracle, name, shape):
    kl = oracle[f"{name}_keylines"]
    grads = tuple(to_t(oracle[f"{name}_{a}"].astype(np.int32)) for a in ("dx", "dy"))
    desc = tlbd.lbd_descriptors_ref_exact(shape, grads, kl[:, :4], kl[:, 4], kl[:, 5])
    d = np.abs(to_np(desc) - oracle[f"{name}_desc72"])
    assert d.max() < 2e-6, d.max()
    words = tlbd.binarize_lbd(desc)
    ref_words = tlbd.pack_lbd_bytes(to_t(oracle[f"{name}_desc256"]))
    assert torch.equal(words, ref_words)  # 0 bit flips
    jdesc = jlbd.lbd_descriptors_ref_exact(
        shape, tuple(to_np(g) for g in grads), kl[:, :4], kl[:, 4], kl[:, 5]
    )
    np.testing.assert_allclose(to_np(desc), to_np(jdesc), atol=1e-6)


def test_sobel_bit_exact_on_reference_blur(oracle):
    """The port's integer Sobel (the second stage of int_gradients)
    reproduces cv::Sobel(CV_16S) exactly on the reference's own blurred
    image; reference_gradients of that image is the JAX package's."""
    blur = oracle["cabinet_blur"]
    gx, gy = tlbd.sobel_int(to_t(blur.astype(np.float32)))
    np.testing.assert_array_equal(to_np(gx), oracle["cabinet_dx"])
    np.testing.assert_array_equal(to_np(gy), oracle["cabinet_dy"])
    for a, b in zip(tlbd.reference_gradients(blur), jlbd.reference_gradients(blur)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_gradients_on_synthetic_images(seed):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(128, 40, size=(60, 80)), 0, 255).astype(np.uint8)
    img[20:40, 10:50] = 250
    for a, b in zip(tlbd.reference_gradients(img), jlbd.reference_gradients(img)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_matcher_parity(oracle):
    """hamming_match on the oracle's tum0/tum1 codes gives the reference
    MIH matcher's tum_matches: the same distance for every query, the same
    train index wherever the minimum is unique (and JAX's everywhere), the
    same dist<25 acceptance set."""
    qa = tlbd.pack_lbd_bytes(to_t(oracle["tum0_desc256"]))
    tb = tlbd.pack_lbd_bytes(to_t(oracle["tum1_desc256"]))
    mq = torch.ones(qa.shape[0], dtype=torch.bool)
    mt = torch.ones(tb.shape[0], dtype=torch.bool)
    idx, dist, matched = tlbd.hamming_match(qa, tb, mq, mt, max_dist=25)
    ref = oracle["tum_matches"].astype(int)  # (Lq, 3): q t dist
    qb = _ref_bits(oracle["tum0_desc256"]).reshape(len(ref), -1)
    tbits = _ref_bits(oracle["tum1_desc256"]).reshape(tb.shape[0], -1)
    dmat = (qb[:, None, :] != tbits[None, :, :]).sum(-1)
    np.testing.assert_array_equal(to_np(dist), ref[:, 2])
    unique = (dmat == dmat.min(axis=1, keepdims=True)).sum(axis=1) == 1
    np.testing.assert_array_equal(to_np(idx)[unique], ref[unique, 1])
    np.testing.assert_array_equal(to_np(matched), ref[:, 2] < 25)
    jo = jlbd.hamming_match(
        jlbd.pack_lbd_bytes(oracle["tum0_desc256"]), jlbd.pack_lbd_bytes(oracle["tum1_desc256"]),
        jnp.ones(qa.shape[0], bool), jnp.ones(tb.shape[0], bool), max_dist=25,
    )
    for a, b in zip(jo, (idx, dist, matched)):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_packed_bytes_roundtrip(oracle):
    """binarize_lbd of the oracle's float descriptors gives the oracle's
    bytes through pack_lbd_bytes."""
    words = tlbd.binarize_lbd(to_t(oracle["cabinet_desc72"]))
    assert torch.equal(words, tlbd.pack_lbd_bytes(to_t(oracle["cabinet_desc256"])))


def test_octave_descriptors_against_jax():
    """lbd_descriptors_octaves on the same image, lines and provenance:
    within 1e-5 of JAX's, codes bit-equal; the octave-1 rows are the
    descriptors of the port's own downsample2 image at halved coordinates."""
    rng = np.random.default_rng(5)
    img = (rng.normal(size=(128, 192)) * 20 + 120).astype(np.float32)
    img[40:42, 20:120] = 250.0
    img[60:100, 90:92] = 10.0
    L = 6
    lines = np.zeros((L, 4), np.float32)
    lines[0] = [20, 41, 119, 41]
    lines[1] = [90.5, 60, 90.5, 99]
    lines[2] = [20, 41, 118, 41]
    lines[3] = [90.5, 60, 90.5, 98]
    mask = np.zeros(L, bool)
    mask[:4] = True
    octs = np.array([0, 0, 1, 1, 0, 0], np.int32)
    td, tv = tlbd.lbd_descriptors_octaves(to_t(img), to_t(lines), to_t(mask), to_t(octs),
                                          n_octaves=2, max_len=64)
    octaves = jax.jit(jlbd.lbd_descriptors_octaves, static_argnames=("n_octaves", "max_len"))
    jd, jv = octaves(to_j(img), to_j(lines), to_j(mask), to_j(octs), n_octaves=2, max_len=64)
    np.testing.assert_array_equal(to_np(tv), mask)
    np.testing.assert_allclose(to_np(td)[mask], to_np(jd)[mask], atol=1e-5)
    np.testing.assert_array_equal(_u32(tlbd.binarize_lbd(td))[mask],
                                  _u32(jlbd.binarize_lbd(jd))[mask])
    from cube_slam_wu_tpu_torch.ops.detect import downsample2

    half = downsample2(to_t(img))
    np.testing.assert_array_equal(to_np(half), to_np(jdet.downsample2(to_j(img))))
    d1, _ = tlbd.lbd_descriptors(half, to_t((lines - 0.5) / 2.0), to_t(mask), max_len=64)
    np.testing.assert_array_equal(to_np(td)[2:4], to_np(d1)[2:4])
