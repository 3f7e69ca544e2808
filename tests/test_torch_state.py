"""The function that carries state across (slam/convert.py) round-trips, and
the static check that the port imports nothing of JAX."""

import pathlib
import re

import numpy as np
import torch

from torch_parity import assert_tree_close, jax_tree_to_numpy, tree_np

import jax.numpy as jnp

from cube_slam_wu_tpu.slam.graph import CameraObjectGraph as JGraph
from cube_slam_wu_tpu.slam.online import OnlineBook as JBook
from cube_slam_wu_tpu.slam.online import OnlineState as JState
from cube_slam_wu_tpu.slam.window import CubePrior as JPrior
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy, state_to_numpy
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.slam.online import OnlineBook, OnlineState
from cube_slam_wu_tpu_torch.slam.window import CubePrior

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _randomize(tree, rng):
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype == bool:
        return rng.random(a.shape) < 0.5
    if a.dtype.kind in "iu":
        return rng.integers(-1, 9, a.shape).astype(a.dtype)
    return rng.normal(0, 1, a.shape).astype(a.dtype)


def test_online_state_round_trip_from_jax_layout():
    rng = np.random.default_rng(0)
    jstate = JState(JGraph.empty(5, 3, jnp.float32), JBook.empty(3, jnp.float32), None)
    tree = _randomize(jax_tree_to_numpy(jstate), rng)
    state = state_from_numpy(tree, "cpu", torch.float32)
    assert isinstance(state, OnlineState)
    assert isinstance(state.graph, CameraObjectGraph) and isinstance(state.book, OnlineBook)
    assert isinstance(state.graph.cube_meas, Cuboid) and isinstance(state.graph.odom, SE3)
    assert state.prior is None
    assert state.graph.cube_meas.pose.quat.shape == (5, 3, 4)
    assert state.book.last.dtype == torch.int32 and state.book.alive.dtype == torch.bool
    assert state.graph.K.dtype == torch.float32
    back = state_to_numpy(state)
    assert_tree_close(tree, back, atol=0.0)
    # field names and order are the JAX package's
    assert OnlineState._fields == JState._fields
    assert CameraObjectGraph._fields == JGraph._fields
    assert OnlineBook._fields == JBook._fields


def test_windowed_online_state_round_trip_from_jax_layout():
    """A windowed state carries a CubePrior, whose `lin` is a Cuboid."""
    rng = np.random.default_rng(2)
    jstate = JState(
        JGraph.empty(5, 3, jnp.float32), JBook.empty(3, jnp.float32), JPrior.empty(3, jnp.float32)
    )
    tree = _randomize(jax_tree_to_numpy(jstate), rng)
    state = state_from_numpy(tree, "cpu", torch.float32)
    assert isinstance(state.prior, CubePrior) and isinstance(state.prior.lin, Cuboid)
    assert isinstance(state.prior.lin.pose, SE3) and state.prior.valid.dtype == torch.bool
    assert state.prior.H.shape == (3, 9, 9) and state.prior.lin.pose.quat.shape == (3, 4)
    assert_tree_close(tree, state_to_numpy(state), atol=0.0)
    assert CubePrior._fields == JPrior._fields
    prior = state_from_numpy(tree["prior"], "cpu", torch.float64)
    assert isinstance(prior, CubePrior) and prior.S.dtype == torch.float64


def test_round_trip_of_parts_and_dtype():
    rng = np.random.default_rng(1)
    g = CameraObjectGraph.empty(4, 2, torch.float64)
    tree = _randomize(state_to_numpy(g), rng)
    g2 = state_from_numpy(tree, "cpu", torch.float64)
    assert_tree_close(tree, state_to_numpy(g2), atol=0.0)
    g32 = state_from_numpy(tree, "cpu", torch.float32)
    assert g32.cam_Tcw.quat.dtype == torch.float32
    assert_tree_close(tree, state_to_numpy(g32), atol=1e-6, rtol=1e-6)
    se3 = state_from_numpy({"quat": np.array([1.0, 0, 0, 0]), "trans": np.zeros(3)}, "cpu")
    assert isinstance(se3, SE3)
    cub = state_from_numpy(
        ((np.array([1.0, 0, 0, 0]), np.zeros(3)), np.ones(3)), "cpu", kind=Cuboid
    )
    assert isinstance(cub, Cuboid) and isinstance(cub.pose, SE3)
    assert_tree_close(tree_np(cub), state_to_numpy(cub), atol=0.0)


_FORBIDDEN = re.compile(r"(^|[^\w.])(import\s+jax|from\s+jax)|cube_slam_wu_tpu(?!_torch)")


def test_port_imports_nothing_of_jax():
    """No file of the port, nor chip_smoke.py, mentions `import jax`,
    `from jax` or the JAX package's name (other than as the prefix of the
    port's own name)."""
    files = sorted((ROOT / "cube_slam_wu_tpu_torch").rglob("*"))
    files = [f for f in files if f.is_file() and f.suffix in (".py", ".cu", ".cuh", ".h")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            if _FORBIDDEN.search(line):
                bad.append(f"{f.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)
