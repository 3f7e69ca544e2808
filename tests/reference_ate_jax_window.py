"""ATE of the JAX package's fixed-lag (windowed) online step, on the CPU, on
the synthetic sequence that chip_smoke.py drives the port's windowed path
on.  Quality, not time: it gives the bound that chip_smoke.py holds the
port's windowed ATE to.

    JAX_PLATFORMS=cpu python tests/reference_ate_jax_window.py [n_frames] [window]

Prints one JSON line with the ATE (direct, unaligned RMSE against the
sequence's own T_wc), the report counters, cube_valid and prior_valid.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from torch_window_parity import jax_run_online_frames_windowed  # noqa: E402

from cube_slam_wu_tpu.utils import synth  # noqa: E402
from cube_slam_wu_tpu.utils.metrics import ate_rmse  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    window = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    seq = synth.make_sequence(n_frames=n, size=(480, 640), n_objects=3, seed=0)
    out = jax_run_online_frames_windowed(
        seq, n, max_objects=3, max_detections=3, window=window, capacity=64,
        dtype=jnp.float32,
    )
    truth = seq.T_wc[:, :3, 3]
    print(json.dumps({
        "backend": "jax-cpu", "n_frames": n, "size": [480, 640], "window": window,
        "ate_m": ate_rmse(out["traj"][:n, :3], truth),
        "report": out["report"],
        "cube_valid": out["cube_valid"].tolist(),
        "prior_valid": out["prior_valid"].tolist(),
        "chi2_last": float(out["chi2"][-1]),
    }))


if __name__ == "__main__":
    main()
