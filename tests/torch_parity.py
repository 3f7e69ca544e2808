"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the JAX function on
the CPU backend and its counterpart of the PyTorch port with device="cpu",
and compares at a stated tolerance.  Data crosses between the two frameworks
as numpy COPIES (never zero-copy views of the other framework's buffers).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

# one intra-op thread per test process: the suite runs several workers
torch.set_num_threads(1)

DTYPES = {
    "f64": (jnp.float64, torch.float64, np.float64),
    "f32": (jnp.float32, torch.float32, np.float32),
}


def to_np(x):
    """numpy copy of a jax array, a torch tensor or anything array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def to_t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_j(x, dtype=None):
    return jnp.asarray(np.array(x), dtype)


def tree_np(tree):
    """Nested NamedTuples/tuples/dicts of arrays -> same nesting of numpy."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        return {k: tree_np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_np(v) for v in tree]
    return to_np(tree)


def assert_tree_close(a, b, atol, rtol=0.0, path=""):
    """Compare two `tree_np` results leaf by leaf."""
    if a is None or b is None:
        assert a is None and b is None, path
        return
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_close(a[k], b[k], atol, rtol, f"{path}.{k}")
        return
    if isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_close(x, y, atol, rtol, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == bool or a.dtype.kind in "iu":
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=path)


def jax_tree_to_numpy(tree):
    """A JAX NamedTuple state as nested dicts of numpy (what the port's
    slam.convert.state_from_numpy takes)."""
    return tree_np(jax.device_get(tree))


def pad_detections(rows, n_max):
    """Detection rows `x y w h conf` -> ((n_max, 4) corner boxes, (n_max,)
    mask), highest confidence first when there are more than n_max (the
    contract of the JAX package's utils.io.read_detections_txt)."""
    rows = np.asarray(rows, np.float64).reshape(-1, 5)
    boxes = np.column_stack(
        [rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2], rows[:, 1] + rows[:, 3]]
    )
    if len(rows) >= n_max:
        order = np.argsort(-rows[:, 4])[:n_max]
        return boxes[order], np.ones(n_max, bool)
    pad = n_max - len(rows)
    return (
        np.vstack([boxes, np.zeros((pad, 4))]),
        np.concatenate([np.ones(len(rows), bool), np.zeros(pad, bool)]),
    )


def jax_run_online_frames(
    seq, n_frames, max_objects, max_detections, dtype=jnp.float32, capacity=None,
    return_state_at=None, T0=None, **step_kwargs,
):
    """The JAX package's fused online loop over an in-memory synthetic
    sequence with the sequence's OWN intrinsics and first pose `T0` (default:
    the sequence's; the JAX folder reader hard-codes the TUM intrinsics).  Same loop as
    `cube_slam_wu_tpu.slam.online.run_online_slam_fused`, built from its
    public `make_online_step`.

    Returns dict(traj (N, 7) [x y z qx qy qz qw], cubes (O, 9), cube_valid,
    chi2 (N,), report, states) where `states[k]` is the OnlineState after
    frame k for each k in `return_state_at`."""
    import functools

    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph
    from cube_slam_wu_tpu.slam.online import OnlineBook, OnlineState, make_online_step
    n = int(n_frames)
    capacity = capacity or n
    D = max_detections
    mk = functools.partial(
        make_online_step, seq.K, seq.T_wc[0] if T0 is None else T0, capacity, dtype,
        max_objects=max_objects, max_detections=D, **step_kwargs,
    )
    step0, stepN = mk(sample_cam_roll_pitch=False), mk(sample_cam_roll_pitch=True)
    graph = CameraObjectGraph.empty(capacity, max_objects, dtype)._replace(
        K=jnp.asarray(seq.K, dtype)
    )
    state = OnlineState(graph, OnlineBook.empty(max_objects, dtype), None)
    outs, states = [], {}
    for i in range(n):
        boxes_c, dmask = pad_detections(seq.detections[i], D)
        step = step0 if i == 0 else stepN
        state, out = step(
            state, jnp.asarray(seq.images[i]), jnp.asarray(boxes_c, dtype),
            jnp.asarray(dmask), jnp.asarray(i, jnp.int32),
        )
        outs.append(jax.device_get(out))
        if return_state_at and i in return_state_at:
            # the step donates its input state: copy out before the next call
            states[i] = jax_tree_to_numpy(state)
    traj, cubes, cube_valid = jax.device_get(
        (state.graph.cam_Twc().to_xyzq(), state.graph.cube.to_minimal(),
         state.graph.cube_valid)
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
        chi2=np.array([float(o[1].chi2) for o in outs]), report=report, states=states,
    )


def cached_pair(folder, ck, tmp_path, name, **kw):
    """Both packages' `run_online_slam` in float64 over the front end saved in
    the completed checkpoint `ck` (either package's; each run on its own
    copy): the back ends on the same measurements.  The JAX package's run is
    the committed run `name` (jax_runs).  Returns (JAX SlamOutput, the
    port's)."""
    import shutil

    import jax_runs
    from cube_slam_wu_tpu.slam import pipeline as jpipe
    from cube_slam_wu_tpu_torch.slam import pipeline as tpipe

    def run(tag, driver, **extra):
        copy = tmp_path / f"{tag}_{ck.name}"
        shutil.copy(ck, copy)
        return driver(folder, checkpoint_path=copy, **kw, **extra)

    return (jax_runs.run(name, lambda: run("j", jpipe.run_online_slam, dtype=jnp.float64)),
            run("p", tpipe.run_online_slam, dtype=torch.float64, device="cpu"))


def run_cli_both(tmp_path, capsys, argv, port_flags=("--float64", "--device", "cpu")):
    """The same command line through both packages' `cli.main`, each writing
    into its own directory under `tmp_path` (the port's with `port_flags`).
    Returns [(JAX out dir, its stdout), (port out dir, its stdout)]."""
    from cube_slam_wu_tpu import cli as jcli
    from cube_slam_wu_tpu_torch import cli as tcli

    outs = []
    for name, main, extra in (("jax", jcli.main, ()), ("port", tcli.main, port_flags)):
        out = tmp_path / name
        main([*argv, "--out", str(out), *extra])
        outs.append((out, capsys.readouterr().out))
    return outs


def jax_driver_memo(monkeypatch, name, result, *args, **kwargs):
    """Make the JAX package's `slam.pipeline.<name>` return `result`, a run
    of that driver on `args` and `kwargs` (every other argument at its
    default) in float64 made earlier, so that the JAX command line writes its
    files from that run instead of computing it again.  Each call must be
    that call: the same arguments (paths compared as paths), apart from the
    checkpoint (which does not change the result) and a float64 dtype."""
    import inspect
    import pathlib

    from cube_slam_wu_tpu.slam import pipeline as jpipe

    sig = inspect.signature(getattr(jpipe, name))
    want = sig.bind(*args, **kwargs)
    want.apply_defaults()
    path_like = (str, pathlib.PurePath)

    def memo(*args, **kwargs):
        got = sig.bind(*args, **kwargs)
        got.apply_defaults()
        for key, value in want.arguments.items():
            have = got.arguments[key]
            if isinstance(value, path_like) and isinstance(have, path_like):
                assert pathlib.Path(have) == pathlib.Path(value), (key, have, value)
            elif key == "dtype":
                assert have in (None, jnp.float64) and jax.config.jax_enable_x64
            elif not key.startswith("checkpoint"):
                assert have == value, (key, have, value)
        return result

    monkeypatch.setattr(jpipe, name, memo)


def assert_same_files(a, b, names):
    """Every named file under directories `a` and `b` byte-equal."""
    import filecmp

    for f in names:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


# the TUM commands' files (output_cam_poses.txt ... trajectory_top_view.png)
TUM_FILES = ("output_cam_poses.txt", "output_obj_poses.txt", "trajectory_top_view.png")


def assert_same_segment_sets(a, b, min_count=1):
    """The detector's parity contract between the packages (an atan2 ulp
    moves a pixel's bin, so the detector is a set function): counts within
    5 %, and >= 95 % of either side's segments matched within 0.5 px."""
    from tum_parity import segment_match_fraction

    assert len(a) >= min_count, len(a)
    assert abs(len(a) - len(b)) <= 0.05 * len(a), (len(a), len(b))
    assert segment_match_fraction(a, b) >= 0.95, segment_match_fraction(a, b)
    assert segment_match_fraction(b, a) >= 0.95, segment_match_fraction(b, a)
