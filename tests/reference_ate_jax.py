"""ATE of the JAX package, on the CPU, on the synthetic sequence that
chip_smoke.py drives the port on.  Quality, not time: it gives the bound
that chip_smoke.py holds the port's ATE to.

    JAX_PLATFORMS=cpu python tests/reference_ate_jax.py [n_frames] [short-recovery]

With `short-recovery` the step runs the two-pass line detector
(`DetectConfig(short_recovery=True)`), the configuration of chip_smoke.py's
`line_layer` phase.  Prints one JSON line with the ATE (direct, unaligned RMSE
against the sequence's own T_wc), the report counters and cube_valid.
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

from torch_parity import jax_run_online_frames  # noqa: E402

from cube_slam_wu_tpu.utils import synth  # noqa: E402
from cube_slam_wu_tpu.utils.metrics import ate_rmse  # noqa: E402


def main():
    from cube_slam_wu_tpu.ops.detect import DetectConfig

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    recover = len(sys.argv) > 2 and sys.argv[2] == "short-recovery"
    seq = synth.make_sequence(n_frames=n, size=(480, 640), n_objects=3, seed=0)
    out = jax_run_online_frames(
        seq, n, max_objects=3, max_detections=3, dtype=jnp.float32, capacity=64,
        detect_cfg=DetectConfig(short_recovery=recover),
    )
    truth = seq.T_wc[:, :3, 3]
    print(json.dumps({
        "backend": "jax-cpu", "n_frames": n, "size": [480, 640], "short_recovery": recover,
        "ate_m": ate_rmse(out["traj"][:n, :3], truth),
        "report": out["report"],
        "cube_valid": out["cube_valid"].tolist(),
        "chi2_last": float(out["chi2"][-1]),
    }))


if __name__ == "__main__":
    main()
