"""Committed outputs of the frozen JAX package's heaviest runs in the port's
parity tests: whole drivers, the back end's solves, and the random graph and
landmark prior the back-end tests start from.

Most of the time of those tests went to compiling and running the JAX side,
again in every worker process that ran them.  The JAX package is frozen, so
its outputs on the tests' inputs are data: `run(name, make)` returns the
output committed in tests/data/jax_runs/<name>.npz, and the test runs the
port live against it, as before.

With the environment variable OUT_ENV set to a directory, `run` calls
`make()` instead, writes its output there and returns it as `run` would read
it back.  `python tests/make_jax_runs.py [dir]` runs the test files of
`FILES` that way to write every file, and the slow test of
test_torch_jax_runs.py holds a fresh set to the committed one.

A file holds the output's arrays and, under `SKELETON`, its structure as
JSON: NamedTuples of the JAX package by class, dicts, lists, tuples, and
Python scalars and None by value.
"""

import importlib
import json
import os
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / "data" / "jax_runs"
OUT_ENV = "CUBESLAM_JAX_RUNS_OUT"
SKELETON = "__skeleton__"

# the test files whose JAX runs are committed: make_jax_runs.py runs them
FILES = (
    "test_torch_backend.py",
    "test_torch_ba_options.py",
    "test_torch_ba_prior.py",
    "test_torch_cli_kitti.py",
    "test_torch_online.py",
    "test_torch_online_window.py",
    "test_torch_pipeline_kitti.py",
    "test_torch_pipeline_kitti_f32.py",
    "test_torch_pipeline_kitti_lines.py",
    "test_torch_pipeline_kitti_two_phase.py",
    "test_torch_pipeline_tum.py",
    "test_torch_pipeline_tum_offline.py",
    "test_torch_point_ba.py",
    "test_torch_point_ba_f32.py",
    "test_torch_point_ba_optimize.py",
    "test_torch_window.py",
    "test_torch_windowed_step.py",
)


def run(name, make):
    """The JAX package's output `make()` under `name`: committed, or made
    and written where OUT_ENV points."""
    out_dir = os.environ.get(OUT_ENV)
    if out_dir:
        import jax

        path = pathlib.Path(out_dir) / f"{name}.npz"
        save(path, jax.device_get(make()))
        return load(path)
    return load(DATA / f"{name}.npz")


def save(path, tree):
    """Write `tree` (numpy leaves) to the .npz file `path`."""
    arrays = {}

    def encode(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            cls = type(x)
            return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                    "fields": {k: encode(v) for k, v in x._asdict().items()}}
        if isinstance(x, dict):
            return {"dict": [[k, encode(v)] for k, v in x.items()]}
        if isinstance(x, (list, tuple)):
            return {type(x).__name__: [encode(v) for v in x]}
        if x is None or isinstance(x, (bool, int, float, str)):
            return {"value": x}
        key = f"a{len(arrays)}"
        arrays[key] = np.asarray(x)
        return {"array": key}

    skeleton = encode(tree)
    # several test processes may write the same run: each file appears whole
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **{SKELETON: np.array(json.dumps(skeleton))}, **arrays)
    os.replace(tmp, path)


def load(path):
    """The tree that `save` wrote to `path`."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}

    def decode(s):
        if "namedtuple" in s:
            module, qualname = s["namedtuple"].split(":")
            if not module.startswith("cube_slam_wu_tpu."):
                raise ValueError(f"{path}: not a class of the JAX package: {module}")
            cls = getattr(importlib.import_module(module), qualname)
            return cls(**{k: decode(v) for k, v in s["fields"].items()})
        if "dict" in s:
            return {k: decode(v) for k, v in s["dict"]}
        if "list" in s:
            return [decode(v) for v in s["list"]]
        if "tuple" in s:
            return tuple(decode(v) for v in s["tuple"])
        if "value" in s:
            return s["value"]
        return arrays[s["array"]]

    return decode(json.loads(str(arrays.pop(SKELETON))))
