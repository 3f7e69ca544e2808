"""Port parity: the fixed-lag step (tracker.make_windowed_step) against the
JAX package over a random graph long enough for the window to slide, made as
`torch_window_parity.graph()` is.

Tolerances: float64 1e-6 on poses and landmarks after a run, 1e-8 on the
prior's blocks; float32 1e-3 on poses and landmarks after a run.
"""

import functools

import numpy as np
import pytest
import torch

import jax_runs
from torch_parity import DTYPES, assert_tree_close, jax_tree_to_numpy, to_np, tree_np
from torch_window_parity import empty_graphs, first_poses, frame_inputs, graph, random_graph_np

import jax
import jax.numpy as jnp

from test_torch_window import assert_prior_close
from cube_slam_wu_tpu.slam import tracker as jtracker
from cube_slam_wu_tpu.slam import window as jwindow
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
from cube_slam_wu_tpu_torch.slam import window as twindow


@functools.cache
def graph12():
    """12 slots, 10 of them measured: long enough for a window of 4 to slide."""
    return jax_runs.run("graph12",
                        lambda: random_graph_np(np.random.default_rng(1), F=12, O=2, n_active=10))


def _run_windowed(tree, dt, window, n_frames, F, inactive=()):
    jd, td, _ = DTYPES[dt]
    O = 2
    # jitted: the JAX step run op by op takes seconds per frame on the CPU
    jstep = jax.jit(jtracker.make_windowed_step(window, 5, None, 1.0, 1.0, None))
    tstep = ttracker.make_windowed_step(window, 5, None, 1.0, 1.0, None)
    jg, tg = empty_graphs(F, O, dt, tree["K"], tree["cube"])
    jp, tp = jwindow.CubePrior.empty(O, jd), twindow.CubePrior.empty(O, td)
    jfirst, tfirst = first_poses(tree, dt)
    rng = np.random.default_rng(5)
    for i in range(n_frames):
        has = tree["cube_meas_mask"][i] | (i == 0)
        q = rng.uniform(0.5, 1.0, O)
        jframe, tframe = frame_inputs(tree, i, dt, q, has, active=i not in inactive)
        (jg, jp), (jchi2, jcubes) = jstep((jg, jp), (jnp.asarray(i, jnp.int32), jframe, jfirst))
        (tg, tp), (tchi2, tcubes) = tstep((tg, tp), (i, tframe, tfirst))
        np.testing.assert_allclose(
            float(jchi2), float(tchi2), rtol=1e-6 if dt == "f64" else 5e-3, atol=1e-9,
            err_msg=f"frame {i}",
        )
        np.testing.assert_allclose(
            to_np(jcubes), to_np(tcubes), atol=1e-6 if dt == "f64" else 1e-3, err_msg=f"frame {i}"
        )
    return (jg, jp), (tg, tp)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_windowed_step_over_10_frames(dt):
    """Ten frames through the fixed-lag step with a window of 4: frames 4-9
    each absorb a departing frame.  Landmarks are pre-seeded (a landmark's
    first observation is a coin toss in the JAX package, see
    test_torch_tracker.py)."""
    (jg, jp), (tg, tp) = _run_windowed(graph12(), dt, window=4, n_frames=10, F=12)
    assert to_np(tp.valid).all(), "both landmarks must have been absorbed"
    assert to_np(tg.frame_mask).sum() == 10
    assert_tree_close(jax_tree_to_numpy(jg), tree_np(tg), atol=1e-6 if dt == "f64" else 1e-3)
    # after a float32 run the prior is a function of poses that agree to 1e-3,
    # and b = J^T r is a sum of cancelling terms: 1e-2 of each block's scale
    assert_prior_close(jp, tp, dt, rel32=1e-2)


def test_padded_frame_keeps_graph_and_prior():
    """An inactive (padded) frame leaves graph and prior as they were, down to
    the Cuboid inside the prior."""
    tstep = ttracker.make_windowed_step(4, 5, None, 1.0, 1.0, None)
    _, tg = empty_graphs(12, 2, "f64", graph12()["K"], graph12()["cube"])
    tp = twindow.CubePrior.empty(2, torch.float64)
    _, tfirst = first_poses(graph12(), "f64")
    for i in range(6):
        _, tframe = frame_inputs(graph12(), i, "f64", np.full(2, 0.8), np.ones(2, bool))
        (tg, tp), _ = tstep((tg, tp), (i, tframe, tfirst))
    _, tframe = frame_inputs(graph12(), 6, "f64", np.full(2, 0.8), np.ones(2, bool), active=False)
    (g2, p2), _ = tstep((tg, tp), (6, tframe, tfirst))
    assert_tree_close(tree_np(tg), tree_np(g2), atol=0.0)
    assert_tree_close(tree_np(tp), tree_np(p2), atol=0.0)
    assert to_np(tp.valid).any()


def test_window_covering_the_graph_equals_full_graph_step():
    """No frame ever departs from a window as long as the graph: the
    fixed-lag step then is the full-graph step."""
    F, O, dt = 8, 2, "f64"
    wstep = ttracker.make_windowed_step(F, 5, None, 1.0, 1.0, None)
    fstep = ttracker.make_incremental_step(5, None, 1.0, 1.0, None)
    _, g_w = empty_graphs(F, O, dt, graph()["K"], graph()["cube"])
    g_f = g_w
    prior = twindow.CubePrior.empty(O, torch.float64)
    _, tfirst = first_poses(graph(), dt)
    for i in range(6):
        _, tframe = frame_inputs(graph(), i, dt, np.full(O, 0.8), graph()["cube_meas_mask"][i] | (i == 0))
        (g_w, prior), (chi2_w, _) = wstep((g_w, prior), (i, tframe, tfirst))
        g_f, (chi2_f, _) = fstep(g_f, (i, tframe, tfirst))
        np.testing.assert_allclose(float(chi2_w), float(chi2_f), rtol=1e-8)
    assert not to_np(prior.valid).any()
    # the window's graph carries the prior's zero rows: other sums, same values
    assert_tree_close(tree_np(g_f), tree_np(g_w), atol=1e-8)
