"""Port parity: `tracker.run_incremental` in float64 against the JAX
package on the drive of test_torch_point_step.py: the full-graph and the
windowed branch here, the windowed branch with point observations in
test_torch_run_incremental_points.py.  Final graph to 1e-6, chi2 to 1e-6
relative, cube history to 1e-6, landmark validity exactly.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_tree_close, to_j, to_np, to_t, tree_np

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import tracker as jtracker
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
from test_torch_point_step import K, N, O, SCENE, W, _frames


def check_branch(branch):
    """`run_incremental` in each branch: final graph, chi2 and cube history."""
    jfr, tfr, jfirst, tfirst = _frames("f64")
    s = SCENE
    kw = dict(iterations=3, soft_gate_alpha=1.0)
    if branch != "full":
        kw["window"] = W
    jkw, tkw = dict(kw), dict(kw)
    if branch == "points":
        jkw.update(K=to_j(K, jnp.float64), point_weight=0.3,
                   point_obs=(s["obs_uv"], s["obs_mask"], s["ground"]))
        tkw.update(K=to_t(K, torch.float64), point_weight=0.3,
                   point_obs=(s["obs_uv"], s["obs_mask"], s["ground"]))
    jg, jchi2, jhist = jtracker.run_incremental(jfirst, jfr, **jkw)
    tg, tchi2, thist = ttracker.run_incremental(tfirst, tfr, **tkw)
    assert_tree_close(tree_np(jg.cam_Tcw), tree_np(tg.cam_Tcw), atol=1e-6)
    assert_tree_close(tree_np(jg.cube), tree_np(tg.cube), atol=1e-6)
    np.testing.assert_array_equal(to_np(jg.cube_valid), to_np(tg.cube_valid))
    np.testing.assert_allclose(to_np(jchi2), to_np(tchi2), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(to_np(jhist), to_np(thist), atol=1e-6)
    assert to_np(thist).shape == (N, O, 9)
    gt_xyz = s["gt"][:, :3, 3]
    err = np.abs(to_np(tg.cam_Twc().trans) - gt_xyz).max()
    assert err < 0.5, f"{branch}: trajectory off by {err} m"


@pytest.mark.parametrize("branch", ["full", "window"])
def test_run_incremental_branches_f64(branch):
    check_branch(branch)
