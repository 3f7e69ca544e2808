"""Helpers of the port's parity tests for the fixed-lag path and the options
of the bundle adjuster: the same landmark prior and the same frames in both
packages' types, made from numpy."""

import numpy as np
import torch

import jax.numpy as jnp

from torch_parity import DTYPES, jax_tree_to_numpy, to_j, to_t

from cube_slam_wu_tpu.core.cuboid import Cuboid as JCuboid
from cube_slam_wu_tpu.core.se3 import SE3 as JSE3
from cube_slam_wu_tpu.slam import tracker as jtracker
from cube_slam_wu_tpu.slam import window as jwindow
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph as JGraph
from cube_slam_wu_tpu_torch.core.cuboid import Cuboid as TCuboid
from cube_slam_wu_tpu_torch.core.se3 import SE3 as TSE3
from cube_slam_wu_tpu_torch.slam import tracker as ttracker
from cube_slam_wu_tpu_torch.slam import window as twindow
from cube_slam_wu_tpu_torch.slam.convert import state_from_numpy
from cube_slam_wu_tpu_torch.slam.graph import CameraObjectGraph as TGraph


def jcuboid(tree, jd, idx=None):
    """JAX Cuboid from a {"pose": {"quat", "trans"}, "scale"} numpy tree."""
    pick = (lambda a: a) if idx is None else (lambda a: a[idx])
    return JCuboid(
        JSE3(to_j(pick(tree["pose"]["quat"]), jd), to_j(pick(tree["pose"]["trans"]), jd)),
        to_j(pick(tree["scale"]), jd),
    )


def tcuboid(tree, td, idx=None):
    pick = (lambda a: a) if idx is None else (lambda a: a[idx])
    return TCuboid(
        TSE3(to_t(pick(tree["pose"]["quat"]), td), to_t(pick(tree["pose"]["trans"]), td)),
        to_t(pick(tree["scale"]), td),
    )


def jprior(tree, jd):
    """JAX CubePrior from its numpy tree."""
    f = lambda k: to_j(tree[k], jd)
    return jwindow.CubePrior(
        H=f("H"), b=f("b"), S=f("S"), c_vec=f("c_vec"), lin=jcuboid(tree["lin"], jd),
        valid=to_j(tree["valid"]),
    )


def tprior(tree, td):
    prior = state_from_numpy(tree, "cpu", td)
    assert isinstance(prior, twindow.CubePrior)
    return prior


def absorb_args(graph_tree, frame, dt, prior_tree=None, cube_tree=None):
    """The arguments of `absorb_frame` for one frame of a graph tree, in both
    packages' types: (jax args, torch args)."""
    jd, td, _ = DTYPES[dt]
    O = graph_tree["cube_valid"].shape[0]
    cam = graph_tree["cam_Tcw"]
    jT = JSE3(to_j(cam["quat"][frame], jd), to_j(cam["trans"][frame], jd)).inverse()
    tT = TSE3(to_t(cam["quat"][frame], td), to_t(cam["trans"][frame], td)).inverse()
    cube_tree = graph_tree["cube"] if cube_tree is None else cube_tree
    w = graph_tree["cube_meas_weight"][frame]
    m = graph_tree["cube_meas_mask"][frame]
    jp = jwindow.CubePrior.empty(O, jd) if prior_tree is None else jprior(prior_tree, jd)
    tp = twindow.CubePrior.empty(O, td) if prior_tree is None else tprior(prior_tree, td)
    jargs = (jp, jT, jcuboid(graph_tree["cube_meas"], jd, frame), to_j(w, jd), to_j(m),
             jcuboid(cube_tree, jd))
    targs = (tp, tT, tcuboid(graph_tree["cube_meas"], td, frame), to_t(w, td), to_t(m),
             tcuboid(cube_tree, td))
    return jargs, targs


def prior_tree_from_graph(graph_tree, frames=(0, 1)):
    """A landmark prior as a numpy tree: the JAX package's `absorb_frame` over
    some frames of a graph tree, in float64."""
    prior = None
    for f in frames:
        jargs, _ = absorb_args(graph_tree, f, "f64", prior)
        prior = jax_tree_to_numpy(jwindow.absorb_frame(*jargs))
    assert prior["valid"].any()
    return prior


def empty_graphs(F, O, dt, K, cube_tree=None):
    """Empty graphs of both packages with intrinsics `K`; with `cube_tree`
    the landmarks are pre-seeded and valid."""
    jd, td, _ = DTYPES[dt]
    jg = JGraph.empty(F, O, jd)._replace(K=to_j(K, jd))
    tg = TGraph.empty(F, O, td)._replace(K=to_t(K, td))
    if cube_tree is not None:
        jg = jg._replace(cube_valid=jnp.ones(O, bool), cube=jcuboid(cube_tree, jd))
        tg = tg._replace(cube_valid=torch.ones(O, dtype=torch.bool), cube=tcuboid(cube_tree, td))
    return jg, tg


def frame_inputs(graph_tree, i, dt, quality, has_meas, active=True):
    """FrameInput of frame `i` of a graph tree for both packages."""
    jd, td, _ = DTYPES[dt]
    bbox = graph_tree["bbox_meas"][i]
    bw = np.where(has_meas, 0.005, 0.0)
    jframe = jtracker.FrameInput(
        meas=jcuboid(graph_tree["cube_meas"], jd, i), quality=to_j(quality, jd),
        has_meas=to_j(has_meas), active=jnp.asarray(bool(active)),
        bbox=to_j(bbox, jd), bbox_weight=to_j(bw, jd),
    )
    tframe = ttracker.FrameInput(
        meas=tcuboid(graph_tree["cube_meas"], td, i), quality=to_t(quality, td),
        has_meas=to_t(has_meas), active=torch.tensor(bool(active)),
        bbox=to_t(bbox, td), bbox_weight=to_t(bw, td),
    )
    return jframe, tframe


def first_poses(graph_tree, dt):
    """The fixed frame-0 camera-to-world pose in both packages' types."""
    jd, td, _ = DTYPES[dt]
    cam = graph_tree["cam_Tcw"]
    first = np.linalg.inv(
        np.array(JSE3(to_j(cam["quat"][0]), to_j(cam["trans"][0])).matrix())
    )
    return JSE3.from_matrix(to_j(first, jd)), TSE3.from_matrix(to_t(first, td))


def jax_run_online_frames_windowed(
    seq, n_frames, max_objects, max_detections, window, capacity, dtype=jnp.float32,
    return_state_at=None, T0=None, **step_kwargs,
):
    """The JAX package's fused online loop with `window=W` (the fixed-lag
    step) over an in-memory synthetic sequence with the sequence's own
    intrinsics and first pose: the loop of its `run_online_slam_fused`, whose
    state starts with an empty `CubePrior`.

    Returns dict(traj (N, 7) [x y z qx qy qz qw], cubes (O, 9), cube_valid,
    prior_valid, chi2 (N,), report, states) where `states[k]` is the
    OnlineState after frame k, as numpy, for each k in `return_state_at`."""
    import functools

    import jax

    from torch_parity import pad_detections

    from cube_slam_wu_tpu.slam.online import OnlineBook, OnlineState, make_online_step

    n = int(n_frames)
    assert window < capacity
    mk = functools.partial(
        make_online_step, seq.K, seq.T_wc[0] if T0 is None else T0, capacity, dtype,
        max_objects=max_objects, max_detections=max_detections, window=window, **step_kwargs,
    )
    step0, stepN = mk(sample_cam_roll_pitch=False), mk(sample_cam_roll_pitch=True)
    graph = JGraph.empty(capacity, max_objects, dtype)._replace(K=jnp.asarray(seq.K, dtype))
    state = OnlineState(
        graph, OnlineBook.empty(max_objects, dtype), jwindow.CubePrior.empty(max_objects, dtype)
    )
    outs, states = [], {}
    for i in range(n):
        boxes_c, dmask = pad_detections(seq.detections[i], max_detections)
        step = step0 if i == 0 else stepN
        state, out = step(
            state, jnp.asarray(seq.images[i]), jnp.asarray(boxes_c, dtype),
            jnp.asarray(dmask), jnp.asarray(i, jnp.int32),
        )
        outs.append(jax.device_get(out))
        if return_state_at and i in return_state_at:
            # the step donates its input state: copy out before the next call
            states[i] = jax_tree_to_numpy(state)
    traj, cubes, cube_valid, prior_valid = jax.device_get(
        (state.graph.cam_Twc().to_xyzq(), state.graph.cube.to_minimal(),
         state.graph.cube_valid, state.prior.valid)
    )
    report = dict(
        cap_overflow=int(sum(int(o[1].cap_overflow) for o in outs)),
        cap_fallbacks=int(sum(bool(o[1].cap_fallback) for o in outs)),
        no_valid_proposal=int(sum(bool(o[1].no_valid_proposal) for o in outs)),
        n_measurements=int(sum(int(o[1].n_matched) for o in outs)),
        dropped=int(sum(int(o[1].dropped) for o in outs)),
    )
    return dict(
        traj=np.array(traj), cubes=np.array(cubes), cube_valid=np.array(cube_valid),
        prior_valid=np.array(prior_valid),
        chi2=np.array([float(o[1].chi2) for o in outs]), report=report, states=states,
    )
