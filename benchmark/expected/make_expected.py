"""Writes a cell's expected answers (`expected/<name>.npz`) with the JAX
package, the implementation that the port was written from, on the CPU.

    JAX_PLATFORMS=cpu python3 benchmark/expected/make_expected.py \
        --workload tum_detect_cuboid [--size H W --n-frames N --name NAME]

It renders the cell's fixed world with the benchmark's frozen generator and
runs the single-image cuboid detector of `cube_slam_wu_tpu` (line segments,
then the ranked cuboids of every box of a frame in one batch) in the cell's
precision, frame by frame.  A tool to run on a host: the benchmark's runs
never import it, and nothing of the PyTorch port is loaded here.  About 7 s
a frame at 480x640 on one CPU core.
"""

import argparse
import pathlib
import sys
import time

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--size", type=int, nargs=2, default=None)
    ap.add_argument("--n-frames", type=int, default=None)
    ap.add_argument("--name", default=None, help="file name (default: the traffic's)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from cube_slam_wu_tpu.ops.detect import detect_line_segments
    from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboids
    from harness import cell, expected
    from harness.frames import FIELDS, detect_inputs, proposal_config
    from harness.world import make_world

    overrides = {}
    if args.size:
        overrides["size"] = list(args.size)
    if args.n_frames:
        overrides["n_frames"] = args.n_frames
    c = cell.load_cell(args.workload, overrides=overrides)
    s = c.settings
    name = args.name or s["expected"]
    dtype = getattr(jnp, s["dtype"])
    world = make_world(s, s["world_seed"])
    answers = []
    t0 = time.perf_counter()
    for i in range(len(world.images)):
        gray_u8, xywh, mask, T_wc = detect_inputs(world, i, s["max_detections"])
        gray = jnp.asarray(gray_u8, dtype)
        lines, lmask = detect_line_segments(gray)
        cfg = proposal_config(ProposalConfig, s, int(lines.shape[0]))
        res = detect_cuboids(gray, jnp.asarray(world.K, dtype), jnp.asarray(T_wc, dtype),
                             jnp.asarray(xywh, dtype), jnp.asarray(mask), lines, lmask, cfg)
        answers.append({"lines": np.asarray(lines), "lmask": np.asarray(lmask),
                        **{f: np.asarray(getattr(res, f)) for f in FIELDS}})
        print(f"frame {i}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    path = expected.file_of(c.dir, name)
    expected.save(path, world, answers, s, made_by="cube_slam_wu_tpu (JAX) on the CPU, "
                  f"{s['dtype']}")
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
