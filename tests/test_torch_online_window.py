"""Port parity: the fixed-lag slice as a whole — the fused online step with
`window=4` and `capacity=12` over 8 frames of the 240x320 three-object
sequence of test_torch_online.py (tilted pose, see there), through the JAX
package and through the port on the CPU.  Frames 4-7 each absorb a departing
frame into the landmark prior.

Tolerances (float32 production dtype), as in test_torch_online.py: identical
`cube_valid`, `prior_valid` and integer report counters; trajectory 1e-3 m
and 1e-3 on the quaternion; cuboids 5e-3.
"""

import numpy as np
import pytest
import torch

import jax_runs
from torch_parity import to_np
from torch_window_parity import jax_run_online_frames_windowed

import jax.numpy as jnp

from test_torch_online import O, _assert_runs_agree, _objects, _port_mem, _tilt
from cube_slam_wu_tpu_torch.slam import online as tonline
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy
from cube_slam_wu_tpu_torch.utils import synth as tsynth

NW, WINDOW, CAPW = 8, 4, 12


@pytest.fixture(scope="module")
def seq8():
    """Eight frames of the same scene for the fixed-lag path."""
    s = tsynth.make_sequence(
        objects=_objects(tsynth), n_frames=NW, size=(240, 320), noise_px=0.5, speed=0.3
    )
    assert all(len(d) == O for d in s.detections)
    return s._replace(T_wc=_tilt(s.T_wc))


@pytest.fixture(scope="module")
def jax_win(seq8):
    return jax_runs.run("online_window", lambda: jax_run_online_frames_windowed(
        seq8, NW, O, O, window=WINDOW, capacity=CAPW, dtype=jnp.float32, return_state_at={5}
    ))


def test_windowed_slice_in_memory_matches_jax(seq8, jax_win):
    """The fixed-lag path as a whole: `make_online_step(window=4,
    capacity=12)` over 8 frames through `run_online_frames`."""
    res = _port_mem(seq8, n=NW, window=WINDOW, capacity=CAPW)
    assert res.cube_valid.all() and res.report["n_measurements"] == NW * O
    assert res.prior_valid is not None and res.prior_valid.all(), "frames 4-7 absorb"
    np.testing.assert_array_equal(jax_win["prior_valid"], res.prior_valid)
    n = NW
    _assert_runs_agree(
        jax_win["traj"][:n], jax_win["cubes"], jax_win["cube_valid"], jax_win["report"],
        res._replace(traj_Twc_xyzq=res.traj_Twc_xyzq[:n]),
    )
    np.testing.assert_allclose(jax_win["chi2"], res.chi2, rtol=2e-2, atol=1e-3)
    # the window changes the result: the full-graph run differs
    full = _port_mem(seq8, n=NW, capacity=CAPW)
    assert full.prior_valid is None
    assert np.abs(full.traj_Twc_xyzq[:n, :3] - res.traj_Twc_xyzq[:n, :3]).max() > 1e-6


def test_windowed_state_handed_over_from_jax_after_6_frames(seq8, jax_win):
    """JAX runs frames 0-5 (two absorptions), its state with the CubePrior
    crosses as numpy, the port runs frames 6 and 7: same end state as JAX
    running all eight."""
    state = state_from_numpy(jax_win["states"][5], "cpu", torch.float32)
    assert state.prior is not None and bool(state.prior.valid.all())
    step = tonline.make_online_step(
        seq8.K, seq8.T_wc[0], CAPW, torch.float32, max_objects=O, max_detections=O,
        sample_cam_roll_pitch=True, window=WINDOW, device="cpu",
    )
    frames = list(tonline.sequence_frames(seq8.images, seq8.detections, O))
    for i in (6, 7):
        gray, boxes, dmask = frames[i]
        state, _ = step(
            state, torch.from_numpy(gray), torch.from_numpy(boxes).float(),
            torch.from_numpy(dmask), i,
        )
    traj = to_np(state.graph.cam_Twc().to_xyzq())
    np.testing.assert_allclose(jax_win["traj"][:NW, :3], traj[:NW, :3], atol=1e-3)
    np.testing.assert_allclose(jax_win["cubes"], to_np(state.graph.cube.to_minimal()), atol=5e-3)
    np.testing.assert_array_equal(jax_win["prior_valid"], to_np(state.prior.valid))
