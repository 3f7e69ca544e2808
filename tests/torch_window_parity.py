"""Helpers of the port's parity tests for the back end, the fixed-lag path
and the options of the bundle adjuster: the random camera-object graph they
run on, the same landmark prior and the same frames in both packages' types,
made from numpy.  The graph and its prior are read by the first test of a
process that asks for them (`graph()`, `prior()`), never at import."""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import jax_runs
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


def random_graph_np(rng, F=8, O=2, n_active=6, np_dtype=np.float64):
    """A filled graph as nested dicts of numpy arrays: a camera driving
    forward, O cuboids ahead, noisy measurements, a few masked slots."""
    jd = jnp.float64
    K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])
    R0 = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])  # camera looks along +y
    Twc = []
    for i in range(F):
        T = np.eye(4)
        T[:3, :3] = R0
        T[:3, 3] = [0.05 * i, 0.25 * i, 1.6]
        Twc.append(T)
    Twc = JSE3.from_matrix(to_j(np.stack(Twc), jd))
    noise = JSE3.exp(to_j(rng.normal(0, 0.02, (F, 6)), jd))
    Tcw_true = Twc.inverse()
    Tcw_est = noise.compose(Tcw_true)
    cubes_min = np.stack(
        [[-1.0 + 2.2 * o, 6.0 + 1.5 * o, 0.5, 0, 0, 0.4 + 0.9 * o, 0.6, 0.4, 0.5] for o in range(O)]
    )
    cube_true = JCuboid.from_minimal(to_j(cubes_min, jd))
    cube_est = JCuboid.from_minimal(to_j(cubes_min + rng.normal(0, 0.05, cubes_min.shape), jd))
    Twc_b = JSE3(
        jnp.broadcast_to(Twc.quat[:, None, :], (F, O, 4)),
        jnp.broadcast_to(Twc.trans[:, None, :], (F, O, 3)),
    )
    cube_b = JCuboid(
        JSE3(
            jnp.broadcast_to(cube_true.pose.quat[None], (F, O, 4)),
            jnp.broadcast_to(cube_true.pose.trans[None], (F, O, 3)),
        ),
        jnp.broadcast_to(cube_true.scale[None], (F, O, 3)),
    )
    meas = cube_b.transform_to(Twc_b)
    meas = meas.exp_update(to_j(rng.normal(0, 0.03, (F, O, 9)), jd))
    bbox = cube_b.project_bbox(
        JSE3(
            jnp.broadcast_to(Tcw_true.quat[:, None, :], (F, O, 4)),
            jnp.broadcast_to(Tcw_true.trans[:, None, :], (F, O, 3)),
        ),
        to_j(K, jd),
    ) + to_j(rng.normal(0, 1.0, (F, O, 4)), jd)
    prev = np.maximum(np.arange(F) - 1, 0)
    odom = Tcw_true.compose(JSE3(Tcw_true.quat[prev], Tcw_true.trans[prev]).inverse())
    odom = JSE3.exp(to_j(rng.normal(0, 0.01, (F, 6)), jd)).compose(odom)
    frame_mask = np.arange(F) < n_active
    meas_mask = (rng.random((F, O)) < 0.85) & frame_mask[:, None]
    g = JGraph(
        cam_Tcw=Tcw_est, cube=cube_est,
        frame_mask=to_j(frame_mask), cube_valid=to_j(np.ones(O, bool)),
        odom=odom, odom_mask=to_j(frame_mask & (np.arange(F) > 0)),
        cube_meas=meas,
        cube_meas_weight=to_j(rng.uniform(1.0, 2.0, (F, O)), jd),
        cube_meas_mask=to_j(meas_mask),
        bbox_meas=bbox, bbox_weight=to_j(np.full((F, O), 0.005), jd),
        bbox_mask=to_j(meas_mask), K=to_j(K, jd),
    )
    return jax_tree_to_numpy(g)


def graphs(tree, dt):
    """A graph tree as the graphs of both packages in dtype `dt`: (JAX, port)."""
    jd, td, _ = DTYPES[dt]
    cast = lambda a: jnp.asarray(a, jd) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
    jg = JGraph(
        cam_Tcw=JSE3(**{k: cast(v) for k, v in tree["cam_Tcw"].items()}),
        cube=JCuboid(JSE3(**{k: cast(v) for k, v in tree["cube"]["pose"].items()}), cast(tree["cube"]["scale"])),
        frame_mask=cast(tree["frame_mask"]), cube_valid=cast(tree["cube_valid"]),
        odom=JSE3(**{k: cast(v) for k, v in tree["odom"].items()}),
        odom_mask=cast(tree["odom_mask"]),
        cube_meas=JCuboid(JSE3(**{k: cast(v) for k, v in tree["cube_meas"]["pose"].items()}), cast(tree["cube_meas"]["scale"])),
        cube_meas_weight=cast(tree["cube_meas_weight"]), cube_meas_mask=cast(tree["cube_meas_mask"]),
        bbox_meas=cast(tree["bbox_meas"]), bbox_weight=cast(tree["bbox_weight"]),
        bbox_mask=cast(tree["bbox_mask"]), K=cast(tree["K"]),
    )
    tg = state_from_numpy(tree, "cpu", td)
    assert isinstance(tg, TGraph)
    return jg, tg


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


@functools.cache
def graph():
    """The random graph of the back-end parity tests (seed 0: 8 slots, 6 of
    them active, 2 landmarks), as a numpy tree (committed: jax_runs).
    Callers copy before they change a leaf."""
    return jax_runs.run("graph", lambda: random_graph_np(np.random.default_rng(0)))


@functools.cache
def prior():
    """The landmark prior of frames 0 and 1 of `graph()` (committed: jax_runs)."""
    return jax_runs.run("prior", lambda: prior_tree_from_graph(graph()))


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
