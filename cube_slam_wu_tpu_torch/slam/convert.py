"""Carrying state across: numpy trees <-> the port's NamedTuples of tensors.

The system has no learned weights; its state is the graph, the tracklet book
and, on the fixed-lag path, the landmark prior, and on the KITTI path with
point landmarks the point state: the KITTI driver's carry is the tuple
(graph, CubePrior, PointState); the loop-closure back end's is the
`Sim3PoseGraph`.  `state_from_numpy` takes an `OnlineState`,
`CameraObjectGraph`, `OnlineBook`, `CubePrior`, `PointState`,
`Sim3PoseGraph`, `SE3`, `Sim3` or `Cuboid` given as nested dicts (or
positional tuples) of numpy arrays — e.g. another implementation's state
after `._asdict()` — and builds the port's type on a device; `kind` may
also be a tuple of types, for a tuple of such trees (a carry).
`state_to_numpy` goes back.  The front-end's `FrontendReport` is host-side
bookkeeping (lists and ints), not device state, and needs no conversion.
Floating arrays take `dtype`; bool and integer arrays keep theirs (int32
where the port uses int32).
"""

from __future__ import annotations

import numpy as np
import torch

from cube_slam_wu_tpu_torch.core.cuboid import Cuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3
from cube_slam_wu_tpu_torch.core.sim3 import Sim3
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu_torch.slam.online import OnlineBook, OnlineState
from cube_slam_wu_tpu_torch.slam.pose_graph import Sim3PoseGraph
from cube_slam_wu_tpu_torch.slam.tracker import PointState
from cube_slam_wu_tpu_torch.slam.window import CubePrior

# nested field types, by NamedTuple and field name
_SCHEMA = {
    SE3: {},
    Sim3: {},
    Cuboid: {"pose": SE3},
    CameraObjectGraph: {
        "cam_Tcw": SE3, "cube": Cuboid, "odom": SE3, "cube_meas": Cuboid,
    },
    OnlineBook: {},
    CubePrior: {"lin": Cuboid},
    PointState: {},
    OnlineState: {"graph": CameraObjectGraph, "book": OnlineBook, "prior": CubePrior},
    Sim3PoseGraph: {"poses": Sim3, "meas": Sim3},
}


def _leaf(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int32)).to(device)
    return torch.as_tensor(a).to(device)


def _build(cls, tree, device, dtype):
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    values = tree if isinstance(tree, dict) else dict(zip(cls._fields, tree))
    out = []
    for name in cls._fields:
        v = values.get(name)
        sub = _SCHEMA[cls].get(name)
        if sub is not None:
            out.append(_build(sub, v, device, dtype))
        elif v is None:
            out.append(None)
        else:
            out.append(_leaf(v, device, dtype))
    return cls(*out)


def _guess_type(tree):
    keys = set(tree.keys()) if isinstance(tree, dict) else None
    if keys is None:
        raise TypeError("state_from_numpy: pass a dict tree or name the type with `kind`")
    for cls in (OnlineState, CameraObjectGraph, OnlineBook, CubePrior, PointState,
                Sim3PoseGraph, Cuboid, SE3, Sim3):
        if keys == set(cls._fields) or (cls is OnlineState and {"graph", "book"} <= keys):
            return cls
    raise TypeError(f"state_from_numpy: unrecognised fields {sorted(keys)}")


def state_from_numpy(tree, device, dtype=torch.float32, kind=None):
    """Build the port's state from a nested tree of numpy arrays.

    `tree` is a dict keyed by field name (nested NamedTuples as nested dicts
    or as objects with `_asdict`), or a positional tuple when `kind` names the
    type (`OnlineState`, `CameraObjectGraph`, `OnlineBook`, `CubePrior`,
    `PointState`, `Sim3PoseGraph`, `SE3`, `Sim3`, `Cuboid`).  With `kind` a
    tuple of types, `tree` is a sequence of that many trees and a tuple comes
    back.
    """
    if isinstance(kind, tuple):
        return tuple(state_from_numpy(t, device, dtype, k) for t, k in zip(tree, kind))
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    cls = kind if kind is not None else _guess_type(tree)
    return _build(cls, tree, torch.device(device), dtype)


def state_to_numpy(state):
    """Nested dicts of numpy arrays from one of the port's NamedTuples."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if not hasattr(state, "_asdict"):  # a tuple of states (a carry)
        return [state_to_numpy(v) for v in state]
    return {k: state_to_numpy(v) for k, v in state._asdict().items()}
