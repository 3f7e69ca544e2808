"""Port parity: the proposal options of ops/proposal.py against the JAX
package — bbox-height sampling, the yaw prior, the ranked ObjectSet
(`max_cuboid_num`) and top-k averaging (`average_top_k`), alone and
`max_cuboid_num` with height sampling together.

Inputs: the rendered demo scene of `proposal_demo_inputs` with its pose tilted
by 0.4 deg roll / 0.7 deg pitch (at an exactly level camera the vertical
vanishing point is at infinity and the support-edge choice is a tie that the
last bit decides, ROADMAP queue 3 entry 2), roll/pitch sampling on, the
online configuration (skew 2, rank margin 2e-3, bilinear chamfer).

Tolerances: the winner's grid index, and the ranks' indices, exactly; every
state field within 1e-9 in float64 and 1e-4 in float32 (absolute and
relative); validity flags, configuration and overflow counts exactly.

`cli detect-cuboid --top-k 3 --sample-height --sample-roll-pitch` through
both packages' `cli.main` (the port's with --float64 --device cpu) on frame 0
of tests/tum_parity.py's world: cuboid_proposal.jpg byte-equal and the same
printed ranks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tum_parity import tilt, write_world
from torch_parity import DTYPES, assert_same_files, run_cli_both, to_j, to_np, to_t

from cube_slam_wu_tpu.ops import proposal as jprop
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.ops import proposal as tprop

TOL = {"f64": 1e-9, "f32": 1e-4}
ONLINE = dict(nominal_skew_ratio=2.0, rank_margin=2e-3, bilinear_dist=True,
              sample_cam_roll_pitch=True)
FIELDS = ("pos", "rotY", "scale", "edge_distance_error", "edge_angle_error",
          "normalized_error", "skew_ratio", "camera_roll_delta", "camera_pitch_delta",
          "corners_2d", "corners_3d_world")
# case -> (ProposalConfig overrides, yaw prior or None)
CASES = {
    "sample_height": (dict(sample_bbox_height=True), None),
    "yaw_prior": (dict(yaw_prior_weight=1.0), 0.25),
    "top_k": (dict(max_cuboid_num=5), None),
    "average_top_k": (dict(average_top_k=3), None),
    "top_k+sample_height": (dict(max_cuboid_num=5, sample_bbox_height=True), None),
}


@pytest.fixture(scope="module")
def scene():
    gray, K, T, bbox, lines, mask = (to_np(x) for x in jsynth.proposal_demo_inputs(np.float64))
    return dict(gray=gray, K=K, T=tilt(T), bbox=bbox, lines=lines, mask=mask)


def _both(scene, dt, over, yaw_prior, internals=True):
    jd, td, _ = DTYPES[dt]
    kw = dict(ONLINE, max_lines=scene["lines"].shape[0], **over)
    args = [scene[k] for k in ("gray", "K", "T", "bbox", "lines")]
    jout = jprop.detect_cuboid_single(
        *[to_j(a, jd) for a in args], to_j(scene["mask"]), jprop.ProposalConfig(**kw),
        return_internals=internals,
        yaw_prior=None if yaw_prior is None else jnp.asarray(yaw_prior, jd),
    )
    tout = tprop.detect_cuboid_single(
        *[to_t(a, td) for a in args], to_t(scene["mask"]), tprop.ProposalConfig(**kw),
        return_internals=internals,
        yaw_prior=None if yaw_prior is None else to_t(np.asarray(yaw_prior), td),
    )
    return jax.device_get(jout), tout


def _assert_results_equal(jres, tres, tol):
    np.testing.assert_array_equal(to_np(jres.valid), to_np(tres.valid))
    np.testing.assert_array_equal(to_np(jres.box_config_type), to_np(tres.box_config_type))
    np.testing.assert_array_equal(to_np(jres.cap_overflow), to_np(tres.cap_overflow))
    v = to_np(jres.valid)
    assert v.any()
    for f in FIELDS:
        np.testing.assert_allclose(
            to_np(getattr(jres, f))[v], to_np(getattr(tres, f))[v], atol=tol, rtol=tol,
            err_msg=f,
        )


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(scene, case, dt):
    over, yaw_prior = CASES[case]
    (jres, jint), (tres, tint) = _both(scene, dt, over, yaw_prior)
    np.testing.assert_array_equal(to_np(jint["best"]), to_np(tint["best"]))
    np.testing.assert_array_equal(jint["valid"], to_np(tint["valid"]))
    k = over.get("max_cuboid_num", 1)
    if k > 1:
        assert to_np(tres.valid).shape == (k,)
    _assert_results_equal(jres, tres, TOL[dt])
    # the option is not a no-op on this scene
    plain = plain_port(scene, dt)
    if k > 1:
        ranked = to_np(tint["final"])[to_np(tint["best"])]
        assert len(set(to_np(tint["best"]).tolist())) == k and np.all(np.diff(ranked) >= 0)
    elif case == "sample_height":
        assert tint["valid"].shape[0] == 3 * plain[1]["valid"].shape[0]
    else:
        assert not np.array_equal(to_np(tres.pos), to_np(plain[0].pos))


_PLAIN = {}


def plain_port(scene, dt):
    """The port's result without any option (cached per dtype)."""
    if dt not in _PLAIN:
        _PLAIN[dt] = _both(scene, dt, {}, None)[1]
    return _PLAIN[dt]


def _rank_order(jidx, jfinal, tidx, tol):
    """The port's ranks in the JAX ranks' order: the same hypotheses, where
    two ranks may trade places only when their final scores are a tie within
    `tol` (two distinct hypotheses a few ulps apart are ordered by the last
    bit, differently in the two packages)."""
    jidx, tidx = list(jidx), list(tidx)
    assert sorted(jidx) == sorted(tidx), (jidx, tidx)
    perm = [tidx.index(i) for i in jidx]
    for r, q in enumerate(perm):
        assert abs(jfinal[jidx[r]] - jfinal[jidx[q]]) <= tol, (r, q, jidx, tidx)
    return perm


@pytest.mark.parametrize("over", [dict(max_cuboid_num=4), dict(sample_bbox_height=True)],
                         ids=["top_k", "sample_height"])
def test_detect_cuboids_batch_with_options(scene, over):
    """The batched entry point with a masked padding box: per-box valid is
    (B, N) for the ObjectSet; height sampling over two boxes and the yaw
    prior as a (B,) tensor agree with JAX's single-box calls (ranks within
    a tie of 1e-12 may trade places, see `_rank_order`)."""
    jd, td, _ = DTYPES["f64"]
    kw = dict(ONLINE, max_lines=scene["lines"].shape[0], **over)
    boxes = np.stack([scene["bbox"], scene["bbox"] + np.array([-4.0, -3.0, 8.0, 6.0]),
                      scene["bbox"]])
    bmask = np.array([True, True, False])
    prior = np.array([0.25, -0.4, 0.0])
    tres, tint = tprop.detect_cuboids(
        *[to_t(scene[k], td) for k in ("gray", "K", "T")], to_t(boxes, td), to_t(bmask),
        to_t(scene["lines"], td), to_t(scene["mask"]), tprop.ProposalConfig(**kw),
        return_internals=True, yaw_prior=to_t(prior, td),
    )
    N = over.get("max_cuboid_num", 1)
    assert to_np(tres.valid).shape == ((3, N) if N > 1 else (3,))
    assert not to_np(tres.valid)[2].any()
    for b in range(2):
        jres, jint = jax.device_get(jprop.detect_cuboid_single(
            *[to_j(scene[k], jd) for k in ("gray", "K", "T")], to_j(boxes[b], jd),
            to_j(scene["lines"], jd), to_j(scene["mask"]), jprop.ProposalConfig(**kw),
            return_internals=True, yaw_prior=jnp.asarray(prior[b], jd),
        ))
        tb = type(tres)(*(t[b] for t in tres))
        if N > 1:
            perm = _rank_order(jint["best"], jint["final"], to_np(tint["best"][b]), 1e-12)
            tb = tb._replace(**{f: getattr(tb, f)[perm] for f in tb._fields if f != "cap_overflow"})
        else:
            assert int(jint["best"]) == int(tint["best"][b])
        _assert_results_equal(jres, tb, TOL["f64"])


def test_cli_detect_cuboid_writes_what_jax_writes(tmp_path, capsys):
    folder, seq = write_world(tmp_path / "data")
    det = seq.detections[0][0]
    pose = tmp_path / "pose.txt"
    np.savetxt(pose, seq.T_wc[0])
    K = seq.K
    argv = [
        "detect-cuboid", "--image", str(folder / "raw_imgs" / "0000_rgb_raw.jpg"),
        "--bbox", ",".join(str(v) for v in (det[0] - 1.0, det[1] - 1.0, det[2], det[3])),
        "--calib", f"{K[0, 0]},{K[1, 1]},{K[0, 2]},{K[1, 2]}", "--pose", str(pose),
        "--top-k", "3", "--sample-height", "--sample-roll-pitch",
    ]
    (j, jtext), (p, ptext) = run_cli_both(tmp_path, capsys, argv)
    assert_same_files(j, p, ("cuboid_proposal.jpg",))
    ranks = lambda text: [ln for ln in text.splitlines() if ln.startswith(("rank", "pos", "rotY"))]
    assert ranks(jtext) == ranks(ptext) and len(ranks(ptext)) == 5
    assert "valid=True" in ptext


def test_detect_cuboid_default_intrinsics_are_jax_s():
    """`cli detect-cuboid` without --calib: the demo camera of the JAX
    package's `config.DEMO_DETECT_3D`."""
    from cube_slam_wu_tpu.config import DEMO_DETECT_3D
    from cube_slam_wu_tpu_torch import cli as tcli

    cam = DEMO_DETECT_3D.camera
    assert tcli.DEMO_CALIB == (cam.fx, cam.fy, cam.cx, cam.cy)
