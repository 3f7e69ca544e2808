"""ATE of the JAX package's two-phase TUM driver, on the CPU, on the synthetic
sequence that chip_smoke.py drives the port's `tum_two_phase_path` on.
Quality, not time: it gives the bound that chip_smoke.py holds the port's
two-phase ATE to.

    JAX_PLATFORMS=cpu python tests/reference_ate_jax_two_phase.py [n_frames] [f32|f64] [first|first-near|last-near]

The sequence is the main path's world (480x640, 3 objects, seed 0), written in
the reference's TUM folder layout by the JAX package's `write_tum_sequence`
and run through `run_online_slam(window=16, point_weight=0.3)`, the `cli
online --window 16 --point-weight 0.3` command line (one object slot, one
detection per frame, the TUM intrinsics the folder reader fixes).  Prints one
JSON line with the ATE (direct, unaligned RMSE against the sequence's own
T_wc), the front-end report, cube_valid and the last chi2.

The last argument says how the JAX package's ZNCC tracker breaks ties:
`first` (its own rule) takes the first exact maximum of the score in its
row-major (dy, dx) order; `first-near` and `last-near` take the first or the
last candidate whose score lies within TIE_EPS of the best.  On this
flat-shaded world straight edges make the correlation a plateau, and which
point of it a tracker takes is decided by float32 rounding (ROADMAP queue 3
entry 9); the three runs give the JAX package's figures across that choice,
with no code of the port in any.
"""

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
F64 = len(sys.argv) > 2 and sys.argv[2] == "f64"
if F64:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cube_slam_wu_tpu.slam import pipeline  # noqa: E402
from cube_slam_wu_tpu.utils import synth  # noqa: E402
from cube_slam_wu_tpu.utils.metrics import ate_rmse  # noqa: E402

# the world and the driver settings of chip_smoke.py's tum_two_phase_path
WORLD = dict(size=(480, 640), n_objects=3, seed=0)
SETTINGS = dict(window=16, point_weight=0.3)


# float32 rounding of the box-sum ZNCC: the two packages' scores of one
# candidate differ by up to 5e-5 at the plateau of ROADMAP queue 3 entry 9
TIE_EPS = 1e-5


def break_ties(rule):
    """Make the JAX package's tracker take, of the candidates within TIE_EPS
    of the best score, the first (`first-near`) or the last (`last-near`)
    (its own `jnp.argmax` takes the first exact maximum).  Applies to every
    trace of `cube_slam_wu_tpu.slam.features` after the call; that module
    calls `jnp.argmax` only for the ZNCC peak."""
    import types

    from cube_slam_wu_tpu.slam import features

    def argmax_near_max(x, axis=-1):
        near = x >= jnp.max(x, axis=axis, keepdims=True) - TIE_EPS
        if rule == "first-near":
            return jnp.argmax(near, axis=axis)
        return x.shape[axis] - 1 - jnp.argmax(jnp.flip(near, axis=axis), axis=axis)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.argmax = argmax_near_max
    features.jnp = proxy


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    ties = sys.argv[3] if len(sys.argv) > 3 else "first"
    if ties != "first":
        break_ties(ties)
    seq = synth.make_sequence(n_frames=n, **WORLD)
    with tempfile.TemporaryDirectory() as tmp:
        folder = synth.write_tum_sequence(seq, os.path.join(tmp, "tum"))
        dtype = jnp.float64 if F64 else jnp.float32
        t0 = time.perf_counter()
        res = pipeline.run_online_slam(folder, dtype=dtype, **SETTINGS)
        seconds = time.perf_counter() - t0
    truth = seq.T_wc[:, :3, 3]
    rep = res.frontend_report
    print(json.dumps({
        "backend": "jax-cpu", "dtype": "float64" if F64 else "float32",
        "n_frames": n, "world": {**WORLD, "size": list(WORLD["size"])},
        "settings": SETTINGS, "zncc_ties": ties,
        "ate_m": ate_rmse(res.traj_Twc_xyzq[:n, :3], truth),
        "report": rep.summary(),
        "cube_valid": res.cube_valid.tolist(),
        "chi2_last": float(res.chi2[-1]),
        "seconds": seconds,
    }))


if __name__ == "__main__":
    main()
