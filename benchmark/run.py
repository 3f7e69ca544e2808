"""The benchmark of the PyTorch/CUDA port on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of its standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device` and, with `--trace 1`, `breakdown`; under `checks`, last, each number
compared with the expected answers beside its limit (also the last lines of
standard error).  Exits with another code than 0, and prints no result, when
the card is missing, a file of the cell is missing, or JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# one thread for every host math library: the program's host work is
# dispatch, and idle pool threads that spin take cores from it
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# the kernel caches sit at fixed paths inside the checkout, so that only the
# first run of a checkout builds (the port's nvcc build goes to build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import cell

    torch.set_num_threads(1)
    try:
        result = cell.run(args.workload, abs(args.seed), args.seconds, bool(args.trace),
                          T_PROCESS)
    except cell.Refused as e:
        print(f"run refused: {e}", file=sys.stderr, flush=True)
        return 2
    # what the port loaded in this process, once the window and the
    # comparison are over
    found = cell.forbidden_modules()
    if found:
        print(f"run refused: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
