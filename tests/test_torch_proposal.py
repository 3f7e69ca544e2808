"""Port parity: ops/proposal.py against the JAX package, with JAX's lines
and the same image, intrinsics, pose and boxes as input.

Tolerances: 1e-9 in float64, 1e-4 in float32 on the full hypothesis set
(valid mask exactly equal; chamfer distance, VP-angle error, fused score and
final score on it), same winner, pos/rotY/scale at the same tolerance.

Two places are discrete by construction and are compared accordingly:

- exact ties.  Configuration 1 and 2 produce hypotheses with the SAME
  distance and angle error (a twin pair).  The best-2/3 cut ranks by value
  then index, and its switch `use_angle` compares the two angle errors next
  to the cut: when those are twins, an ulp decides the switch and with it the
  whole kept set.  Where the kept sets differ, the scene must contain twins,
  and the comparison of fused scores and winner is then left to
  `test_fuse_normalized_scores_identical_inputs`, which feeds both
  implementations the same numbers (ties included) and is exact.
- the int-cast chamfer lookup (bilinear_dist=False) floors sample
  coordinates; on rendered scenes the vertical cuboid edges sit exactly on
  integer pixel columns, where an ulp in the corner coordinate (or a
  compiler's choice to contract a*b+c) moves a whole edge's samples to the
  neighbouring column.  Through the pipeline the port's distances are
  therefore held, exactly, against the JAX function evaluated on the port's
  own corners and map.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import DTYPES, to_j, to_np, to_t

from cube_slam_wu_tpu.ops import detect as jdet
from cube_slam_wu_tpu.ops import proposal as jprop
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.ops import proposal as tprop

TOL = {"f64": 1e-9, "f32": 1e-4}
ONLINE = dict(nominal_skew_ratio=2.0, rank_margin=2e-3)


def _demo_scene():
    ins = jsynth.proposal_demo_inputs(np.float64)
    gray, K, T, bbox, lines, mask = (to_np(x) for x in ins)
    return dict(gray=gray, K=K, T=T, bboxes=bbox[None], lines=lines, mask=mask)


def _rendered_scene(seed):
    seq = jsynth.make_sequence(
        n_frames=1, n_objects=3, size=(192, 256), seed=seed, speed=3.0, noise_px=0.3
    )
    gray = seq.images[0].astype(np.float64)
    lines, mask = jdet.detect_line_segments(to_j(gray.astype(np.float32)))
    det = seq.detections[0]
    assert len(det) >= 2
    bboxes = np.column_stack([det[:, 0] - 1.0, det[:, 1] - 1.0, det[:, 2], det[:, 3]])
    return dict(
        gray=gray, K=seq.K, T=seq.T_wc[0], bboxes=bboxes,
        lines=to_np(lines).astype(np.float64), mask=to_np(mask),
    )


@functools.cache
def _scene(name):
    """The scenes of the tests: "demo", "seed3" and "seed5"."""
    if name == "demo":
        return _demo_scene()
    return _rendered_scene({"seed3": 3, "seed5": 5}[name])


def _run_both(scene, dt, box, **kw):
    jd, td, nd = DTYPES[dt]
    L = scene["lines"].shape[0]
    jcfg = jprop.ProposalConfig(max_lines=L, **kw)
    tcfg = tprop.ProposalConfig(max_lines=L, **kw)
    args = [scene["gray"], scene["K"], scene["T"], scene["bboxes"][box], scene["lines"]]
    jres, jint = jprop.detect_cuboid_single(
        *[to_j(a, jd) for a in args], to_j(scene["mask"]), jcfg, return_internals=True
    )
    tres, tint = tprop.detect_cuboid_single(
        *[to_t(a, td) for a in args], to_t(scene["mask"]), tcfg, return_internals=True
    )
    jint = {k: to_np(v) for k, v in jint.items()}
    tint = {k: to_np(v) for k, v in tint.items()}
    return jres, jint, tres, tint


def _twins(d, a, valid, tol):
    """has_twin[i]: another valid hypothesis has the same (dist, angle)."""
    idx = np.flatnonzero(valid)
    dd = np.abs(d[idx, None] - d[None, idx]) < tol
    aa = np.abs(a[idx, None] - a[None, idx]) < tol
    same = dd & aa
    np.fill_diagonal(same, False)
    out = np.zeros_like(valid)
    out[idx] = same.any(axis=1)
    return out


def _check_intcast_dist(tint, diag):
    """The port's int-cast distances == the JAX function on the port's own
    corners and distance map."""
    valid = tint["valid"]
    H = valid.shape[0] // 2
    dt = jnp.asarray(tint["dist_map"]).dtype
    for config_id, sl in ((1, slice(0, H)), (2, slice(H, 2 * H))):
        c = tint["corners"][sl]  # (H, 8, 2)
        ref = jprop._edge_dist_score(
            jnp.asarray(tint["dist_map"]), jnp.asarray(c[:, :, 0].T, dt),
            jnp.asarray(c[:, :, 1].T, dt), config_id, True, False,
        )
        ref = to_np(ref) / diag
        v = valid[sl]
        tol = 1e-12 if tint["dist"].dtype == np.float64 else 1e-5
        np.testing.assert_allclose(tint["dist"][sl][v], ref[v], atol=tol, rtol=0)


def _compare(jres, jint, tres, tint, tol, bilinear, same_winner, diag=None):
    valid = jint["valid"]
    np.testing.assert_array_equal(valid, tint["valid"])
    np.testing.assert_array_equal(jint["cfg_id"], tint["cfg_id"])
    np.testing.assert_array_equal(jint["vp1_pos"][valid], tint["vp1_pos"][valid])
    assert int(jres.cap_overflow) == int(tres.cap_overflow)
    np.testing.assert_allclose(
        jint["corners"][valid], tint["corners"][valid], atol=tol * 10, rtol=0
    )
    np.testing.assert_allclose(jint["angle"][valid], tint["angle"][valid], atol=tol, rtol=0)
    np.testing.assert_allclose(jint["pos"][valid], tint["pos"][valid], atol=tol, rtol=tol)
    np.testing.assert_allclose(jint["scale"][valid], tint["scale"][valid], atol=tol, rtol=tol)
    np.testing.assert_array_equal(jint["merged_mask"], tint["merged_mask"])
    np.testing.assert_array_equal(jint["dist_map"], tint["dist_map"])
    if not valid.any():
        assert not bool(jres.valid) and not bool(tres.valid)
        return
    d_ok = np.abs(jint["dist"] - tint["dist"]) < tol
    if not bilinear:
        _check_intcast_dist(tint, diag)
        return  # scores downstream inherit the discontinuity
    assert d_ok[valid].all()
    twins = _twins(jint["dist"], jint["angle"], valid, 10 * tol)
    kept_diff = jint["kept"] != tint["kept"]
    assert twins.any() or not kept_diff.any(), "kept sets differ without any tie"
    both = jint["kept"] & tint["kept"]
    if not kept_diff.any():
        np.testing.assert_allclose(jint["scores"][both], tint["scores"][both], atol=tol, rtol=0)
        np.testing.assert_allclose(jint["final"][both], tint["final"][both], atol=tol * 10, rtol=0)
    jb, tb = int(jint["best"]), int(tint["best"])
    assert bool(jres.valid) == bool(tres.valid)
    if same_winner and not kept_diff.any():
        assert jb == tb
    if jb == tb and bool(jres.valid):
        for f in ("pos", "rotY", "scale", "edge_angle_error", "normalized_error",
                  "edge_distance_error", "skew_ratio", "camera_roll_delta",
                  "camera_pitch_delta", "corners_2d", "corners_3d_world"):
            np.testing.assert_allclose(
                to_np(getattr(jres, f)), to_np(getattr(tres, f)),
                atol=tol * 10, rtol=tol, err_msg=f,
            )
        np.testing.assert_array_equal(
            to_np(jres.box_config_type), to_np(tres.box_config_type)
        )


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("rp", [False, True], ids=["fixed_rp", "sample_rp"])
@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "intcast"])
def test_demo_full_hypothesis_set(dt, rp, bilinear):
    out = _run_both(
        _scene("demo"), dt, 0, sample_cam_roll_pitch=rp, bilinear_dist=bilinear, **ONLINE
    )
    assert out[1]["valid"].sum() > 20
    w, h = np.floor(_scene("demo")["bboxes"][0][2:4])
    _compare(*out, TOL[dt], bilinear, same_winner=True, diag=np.sqrt(w * w + h * h))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", ["seed3", "seed5"])
def test_rendered_scenes_online_config(name, dt):
    scene = _scene(name)
    n_valid = 0
    for box in range(len(scene["bboxes"])):
        out = _run_both(
            scene, dt, box, sample_cam_roll_pitch=True, bilinear_dist=True, **ONLINE
        )
        n_valid += int(out[1]["valid"].sum())
        _compare(*out, TOL[dt], True, same_winner=True)
    assert n_valid > 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_caps_on_off_and_overflow(dt):
    """Binding caps: same cap_overflow, same surviving set; caps off: the
    full gather.  (Grid 25x16x24 = 9600 per configuration.)"""
    small = dict(dist_gather_cap=300, dist_gather_cap2=100, merge_cap=8)
    off = dict(dist_gather_cap=0, dist_gather_cap2=0, merge_cap=0)
    base = dict(sample_cam_roll_pitch=True, bilinear_dist=True, **ONLINE)
    o_small = _run_both(_scene("demo"), dt, 0, **base, **small)
    assert int(o_small[0].cap_overflow) > 0
    _compare(*o_small, TOL[dt], True, same_winner=True)
    o_off = _run_both(_scene("demo"), dt, 0, **base, **off)
    assert int(o_off[0].cap_overflow) == 0 and int(o_off[2].cap_overflow) == 0
    _compare(*o_off, TOL[dt], True, same_winner=True)
    # default caps do not bind here: identical to caps off inside the port
    o_def = _run_both(_scene("demo"), dt, 0, **base)
    np.testing.assert_array_equal(o_def[3]["valid"], o_off[3]["valid"])
    assert int(o_def[3]["best"]) == int(o_off[3]["best"])


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "intcast"])
@pytest.mark.parametrize("config_id", [1, 2])
def test_edge_dist_score_identical_inputs(config_id, bilinear):
    """Both lookup branches on identical corners and map: 1e-12 in float64."""
    rng = np.random.default_rng(config_id)
    h, w = 60, 80
    dmap = rng.uniform(0, 30, (h, w)).astype(np.float32).astype(np.float64)
    cx = rng.uniform(-5, w + 5, (8, 50))
    cy = rng.uniform(-5, h + 5, (8, 50))
    a = jprop._edge_dist_score(to_j(dmap), to_j(cx), to_j(cy), config_id, True, bilinear)
    b = tprop._edge_dist_score(
        to_t(dmap)[None], to_t(cx)[None], to_t(cy)[None], config_id, True, bilinear
    )[0]
    np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-10, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_normalized_scores_identical_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 200
    d = rng.uniform(0, 5, n)
    a = rng.uniform(0, 2, n)
    a[10:20] = a[30:40]  # exact ties
    valid = rng.random(n) < (0.5 if seed else 0.015)
    js, jk = jprop.fuse_normalized_scores(to_j(d), to_j(a), to_j(valid), 0.8, True)
    ts, tk = tprop.fuse_normalized_scores(to_t(d)[None], to_t(a)[None], to_t(valid)[None], 0.8, True)
    np.testing.assert_array_equal(to_np(jk), to_np(tk)[0])
    k = to_np(jk)
    np.testing.assert_allclose(to_np(js)[k], to_np(ts)[0][k], atol=1e-12)
    assert np.isinf(to_np(ts)[0][~k]).all()


def test_vanishing_points_and_support_angles():
    rng = np.random.default_rng(0)
    KinvR = rng.normal(0, 1, (5, 3, 3)) + np.eye(3) * 300
    yaw = rng.uniform(-1, 1, 5)
    jv = jprop.vanishing_points_h(to_j(KinvR), to_j(yaw))
    tv = tprop.vanishing_points_h(to_t(KinvR), to_t(yaw))
    np.testing.assert_allclose(to_np(jv), to_np(tv), atol=1e-9)
    np.testing.assert_allclose(
        to_np(jprop.vanishing_points(to_j(KinvR), to_j(yaw))),
        to_np(tprop.vanishing_points(to_t(KinvR), to_t(yaw))), rtol=1e-9,
    )
    mids = rng.uniform(0, 300, (30, 2))
    ang = rng.uniform(-1.5, 1.5, 30)
    mask = rng.random(30) < 0.8
    ja = jprop.vp_support_edge_angles(jv, to_j(mids), to_j(ang), to_j(mask), 15.0, 10.0)
    ta = tprop.vp_support_edge_angles(tv, to_t(mids), to_t(ang), to_t(mask), 15.0, 10.0)
    for x, y in zip(ja, ta):
        np.testing.assert_allclose(to_np(x).astype(float), to_np(y).astype(float), atol=1e-12)


def test_detect_cuboids_batch_with_masked_box():
    scene = _scene("seed3")
    jd, td, _ = DTYPES["f32"]
    L = scene["lines"].shape[0]
    kw = dict(max_lines=L, sample_cam_roll_pitch=True, bilinear_dist=True, **ONLINE)
    boxes = np.concatenate([scene["bboxes"][:2], scene["bboxes"][:1]])
    bmask = np.array([True, True, False])
    common = [scene["gray"], scene["K"], scene["T"], boxes]
    jres = jprop.detect_cuboids(
        *[to_j(a, jd) for a in common], to_j(bmask), to_j(scene["lines"], jd),
        to_j(scene["mask"]), jprop.ProposalConfig(**kw),
    )
    tres = tprop.detect_cuboids(
        *[to_t(a, td) for a in common], to_t(bmask), to_t(scene["lines"], td),
        to_t(scene["mask"]), tprop.ProposalConfig(**kw),
    )
    np.testing.assert_array_equal(to_np(jres.valid), to_np(tres.valid))
    assert not bool(tres.valid[2])
    np.testing.assert_array_equal(to_np(jres.cap_overflow), to_np(tres.cap_overflow))
    v = to_np(jres.valid)
    assert v.any()
    for f in ("pos", "rotY", "scale", "normalized_error", "camera_roll_delta"):
        np.testing.assert_allclose(
            to_np(getattr(jres, f))[v], to_np(getattr(tres, f))[v], atol=1e-4, rtol=1e-4,
            err_msg=f,
        )
    # the batch equals the per-box calls inside the port
    single = tprop.detect_cuboid_single(
        to_t(scene["gray"], td), to_t(scene["K"], td), to_t(scene["T"], td),
        to_t(boxes[1], td), to_t(scene["lines"], td), to_t(scene["mask"]),
        tprop.ProposalConfig(**kw),
    )
    np.testing.assert_array_equal(to_np(single.pos), to_np(tres.pos[1]))
