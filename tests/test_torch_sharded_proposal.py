"""Port parity: parallel/sharded_proposal.py against the JAX package's
`detect_cuboid_sharded`, and the port's own `detect_cuboid_single`.

Inputs: the port's `proposal_demo_inputs` (bit-equal to JAX's,
`test_proposal_demo_inputs_bit_equal_to_jax`) with the pose tilted by
tum_parity.TILT_DEG (an exactly level camera makes the vertical VP's
support-edge choice a tie, ROADMAP queue 3 entry 2), in float64.  With
roll/pitch sampling RP = 25, padded to 26 on 2 ranks and to 27 on 3; without
it RP = 1, padded to 2 and 3.  JAX runs the sampled grid on a 2-device
virtual mesh, the port both grids on 2 and 3 gloo ranks (spawned processes,
tests/parallel_parity.py); the RP = 1 grid is held, as JAX's own
`test_sharded_rp1_grid` holds it, against the single-device run (one JAX
compile less in the suite's budget).

Tolerances (test_torch_proposal.py's float64 TOL): valid and box_config_type
exactly, pos, rotY, scale, corners_2d and normalized_error within 1e-9.
Against the port's single-device run the result is bit-equal, roll and pitch
deltas included.  JAX's sharded roll/pitch deltas are not compared: its
gather lays the configurations of each device side by side while it tiles
the roll/pitch grid device-major, so a winner from configuration 2 reads
another device's roll/pitch (ROADMAP queue 3 entry 13,
`test_jax_sharded_roll_pitch_delta_misaligned`).
"""

import numpy as np
import pytest
import torch

from jax.sharding import Mesh

import jax
from parallel_parity import RankRun, proposal_rank
from torch_parity import to_j, to_np
from tum_parity import tilt

from cube_slam_wu_tpu.ops import proposal as jprop
from cube_slam_wu_tpu.parallel.sharded_proposal import detect_cuboid_sharded as jsharded
from cube_slam_wu_tpu.utils import synth as jsynth
from cube_slam_wu_tpu_torch.utils import synth as tsynth

TOL = 1e-9
CASES = {
    "rp25": dict(max_lines=16, sample_cam_roll_pitch=True),
    "rp1": dict(max_lines=16, sample_cam_roll_pitch=False),
}
EXACT = ("valid", "box_config_type")
CLOSE = ("pos", "rotY", "scale", "corners_2d", "normalized_error")


@pytest.fixture(scope="module")
def inputs():
    gray, K, T, bbox, lines, mask = tsynth.proposal_demo_inputs(np.float64)
    return gray, K, tilt(T), bbox, lines, mask


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(the port's ranks at 2 and 3, JAX's results); the ranks run while JAX
    compiles."""
    ranks = RankRun(proposal_rank, (2, 3), (inputs, CASES), tmp_path_factory.mktemp("prop"))
    mesh = Mesh(np.array(jax.devices()[:2]), ("hyp",))
    args = [to_j(a) for a in inputs]
    ref = {k: to_np(v) for k, v in
           jsharded(*args, jprop.ProposalConfig(**CASES["rp25"]), mesh)._asdict().items()}
    return ranks.result(), ref


@pytest.fixture(scope="module")
def port_ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_results(runs):
    return runs[1]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_proposal_matches_jax(port_ranks, jax_results, world):
    case = "rp25"
    got, ref = port_ranks[world][0], jax_results
    assert bool(ref["valid"]), "the demo scene must give a valid winner"
    for f in EXACT:
        np.testing.assert_array_equal(got[f"{case}/sharded/{f}"], ref[f], err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(got[f"{case}/sharded/{f}"], ref[f], rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_proposal_equals_single(port_ranks, world, case):
    """Every rank's result is the port's single-device result, bit for bit."""
    single = {k.split("/")[-1]: v for k, v in port_ranks[world][0].items()
              if k.startswith(f"{case}/single/")}
    for rank_out in port_ranks[world]:
        for f, v in single.items():
            np.testing.assert_array_equal(rank_out[f"{case}/sharded/{f}"], v, err_msg=f)


def test_jax_sharded_roll_pitch_delta_misaligned(jax_results):  # noqa: ARG001 (compiles first)
    """ROADMAP queue 3 entry 13: JAX's sharded winner is the single-device
    one, but for a winner in the second configuration block of device 0 (or
    the first of device 1) its reported roll/pitch deltas are another
    device's.  On the untilted demo scene (the compile of `jax_results` is
    reused) JAX's sharded run reports a roll delta a whole number of 3-degree
    sampling steps away from the single-device run's, which the port's
    sharded run reproduces (`test_sharded_proposal_equals_single`)."""
    from cube_slam_wu_tpu_torch.ops import proposal as tprop

    gray, K, T, bbox, lines, mask = tsynth.proposal_demo_inputs(np.float64)
    cfg = CASES["rp25"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("hyp",))
    ref = jsharded(*(to_j(a) for a in (gray, K, T, bbox, lines, mask)),
                   jprop.ProposalConfig(**cfg), mesh)
    single = tprop.detect_cuboid_single(*(torch.as_tensor(a) for a in (gray, K, T, bbox, lines, mask)),
                                        tprop.ProposalConfig(**cfg))
    assert bool(ref.valid) and bool(single.valid)
    np.testing.assert_allclose(to_np(ref.pos), to_np(single.pos), rtol=0, atol=TOL)
    steps = (to_np(ref.camera_roll_delta) - to_np(single.camera_roll_delta)) / np.radians(3.0)
    assert abs(steps - np.round(steps)) < 1e-6 and abs(np.round(steps)) >= 1, steps


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", [dict(), dict(img_hw=(480, 640), n_lines=16)],
                         ids=["default", "480x640"])
def test_proposal_demo_inputs_bit_equal_to_jax(dt, shape):
    np_dtype = np.float64 if dt == "f64" else np.float32
    jax_dtype = jax.numpy.float64 if dt == "f64" else jax.numpy.float32
    ours = tsynth.proposal_demo_inputs(np_dtype, **shape)
    theirs = jsynth.proposal_demo_inputs(jax_dtype, **shape)
    on_cpu = tsynth.proposal_demo_inputs(torch.float64 if dt == "f64" else torch.float32,
                                         device="cpu", **shape)
    for a, b, c in zip(ours, theirs, on_cpu):
        b = to_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(to_np(c), a)
