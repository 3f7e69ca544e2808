"""The port's checkpoints (slam/checkpoint.py): round trips, the refusals,
and files exchanged with the JAX package's `save_pytree` / `load_pytree` in
both directions (same .npz keys)."""

import numpy as np
import pytest
import torch

from torch_parity import assert_tree_close, jax_tree_to_numpy, tree_np
from test_torch_state import _randomize

import jax.numpy as jnp

from cube_slam_wu_tpu.slam import checkpoint as jckpt
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph as JGraph
from cube_slam_wu_tpu.slam.online import OnlineBook as JBook
from cube_slam_wu_tpu.slam.online import OnlineState as JState
from cube_slam_wu_tpu.slam.window import CubePrior as JPrior
from cube_slam_wu_tpu_torch.slam import checkpoint as tckpt
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy, state_to_numpy
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.slam.online import OnlineBook, OnlineState
from cube_slam_wu_tpu_torch.slam.window import CubePrior


def _empty_state(F=5, O=3, dtype=torch.float32, windowed=True):
    return OnlineState(
        CameraObjectGraph.empty(F, O, dtype), OnlineBook.empty(O, dtype),
        CubePrior.empty(O, dtype) if windowed else None,
    )


def _random_state(seed, **kw):
    tmpl = _empty_state(**kw)
    tree = _randomize(state_to_numpy(tmpl), np.random.default_rng(seed))
    return state_from_numpy(tree, "cpu", tmpl.graph.K.dtype), tree


@pytest.mark.parametrize("windowed", [True, False])
def test_round_trip(tmp_path, windowed):
    state, tree = _random_state(0, windowed=windowed)
    tckpt.save_pytree(tmp_path / "state", state)  # no suffix: lands as state.npz
    assert (tmp_path / "state.npz").exists()
    back = tckpt.load_pytree(tmp_path / "state", _empty_state(windowed=windowed))
    assert isinstance(back, OnlineState) and isinstance(back.graph, CameraObjectGraph)
    assert (back.prior is None) == (not windowed)
    assert_tree_close(tree, state_to_numpy(back), atol=0.0)
    assert back.book.last.dtype == torch.int32 and back.graph.frame_mask.dtype == torch.bool
    keys = set(np.load(tmp_path / "state.npz").keys())
    assert "graph/cam_Tcw/quat" in keys and "book/last" in keys
    assert ("prior/lin/pose/trans" in keys) == windowed


def test_round_trip_of_tuples_dicts_and_dtype(tmp_path):
    """Positional and keyed containers; the template's dtype wins."""
    tree = {"a": (torch.arange(3.0), [torch.ones(2, 2), None]), "n": np.arange(4)}
    tckpt.save_pytree(tmp_path / "t.npz", tree)
    keys = set(np.load(tmp_path / "t.npz").keys())
    assert keys == {"a/0", "a/1/0", "n"}
    tmpl = {"a": (torch.zeros(3, dtype=torch.float64), [torch.zeros(2, 2), None]), "n": np.zeros(4, np.int32)}
    back = tckpt.load_pytree(tmp_path / "t.npz", tmpl)
    assert back["a"][0].dtype == torch.float64 and back["n"].dtype == np.int32
    np.testing.assert_array_equal(back["a"][0].numpy(), [0.0, 1.0, 2.0])
    assert back["a"][1][1] is None and isinstance(back["a"], tuple) and isinstance(back["a"][1], list)


def test_capacity_mismatch_is_refused(tmp_path):
    state, _ = _random_state(1)
    tckpt.save_pytree(tmp_path / "s.npz", state)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(tmp_path / "s.npz", _empty_state(F=6))


def test_missing_leaf_is_refused(tmp_path):
    state, _ = _random_state(2, windowed=False)
    tckpt.save_pytree(tmp_path / "s.npz", state)
    with pytest.raises(KeyError, match="missing leaf 'prior/H'"):
        tckpt.load_pytree(tmp_path / "s.npz", _empty_state(windowed=True))


def _jax_state(F=5, O=3):
    return JState(JGraph.empty(F, O, jnp.float32), JBook.empty(O, jnp.float32), JPrior.empty(O, jnp.float32))


def test_file_written_by_jax_loads_into_the_port_and_back(tmp_path):
    """A windowed OnlineState saved by the JAX package's `save_pytree` loads
    into the port's types; `state_to_numpy` / `state_from_numpy` carry it;
    the port's file loads back into the JAX package's types."""
    rng = np.random.default_rng(3)
    tree = _randomize(jax_tree_to_numpy(_jax_state()), rng)
    jstate = JState(
        graph=JGraph(**{k: _to_jax(v) for k, v in tree["graph"].items()}),
        book=JBook(**{k: jnp.asarray(v) for k, v in tree["book"].items()}),
        prior=JPrior(**{k: _to_jax(v) for k, v in tree["prior"].items()}),
    )
    jckpt.save_pytree(tmp_path / "from_jax", jstate)
    state = tckpt.load_pytree(tmp_path / "from_jax", _empty_state())
    assert isinstance(state.prior, CubePrior)
    assert_tree_close(tree, state_to_numpy(state), atol=0.0)
    again = state_from_numpy(state_to_numpy(state), "cpu", torch.float32)
    assert isinstance(again.prior, CubePrior) and isinstance(again.prior.lin.pose.quat, torch.Tensor)
    assert_tree_close(tree, state_to_numpy(again), atol=0.0)
    # and the other way round
    tckpt.save_pytree(tmp_path / "from_port", again)
    jback = jckpt.load_pytree(tmp_path / "from_port", _jax_state())
    assert_tree_close(tree, jax_tree_to_numpy(jback), atol=0.0)
    # both packages write the same keys
    assert set(np.load(tmp_path / "from_jax.npz").keys()) == set(np.load(tmp_path / "from_port.npz").keys())
    with pytest.raises(ValueError):
        jckpt.load_pytree(tmp_path / "from_port", _jax_state(F=4))


def _to_jax(v):
    """Nested dict tree of numpy -> the JAX package's SE3 / Cuboid / arrays."""
    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.core.se3 import SE3

    if isinstance(v, dict):
        if set(v) == {"quat", "trans"}:
            return SE3(jnp.asarray(v["quat"]), jnp.asarray(v["trans"]))
        return Cuboid(_to_jax(v["pose"]), jnp.asarray(v["scale"]))
    return jnp.asarray(v)
