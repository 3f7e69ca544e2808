"""Write the committed outputs of the JAX package's driver runs
(tests/jax_runs.py) by running the tests that make them, on the CPU:

    python tests/make_jax_runs.py [out_dir]

out_dir defaults to tests/data/jax_runs.  The tests run as in the suite, the
port's side included, so a run is written only where the port agrees with
it.  7-13 minutes on 8 CPU cores.
"""

import os
import pathlib
import subprocess
import sys

from jax_runs import DATA, FILES, OUT_ENV

TESTS = pathlib.Path(__file__).resolve().parent


def main(out_dir=DATA, timeout_s=2400):
    out_dir = pathlib.Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", **{OUT_ENV: str(out_dir)})
    subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "xdist", "-n", "6", "--dist", "loadfile", *(f"tests/{f}" for f in FILES)],
        cwd=TESTS.parent, env=env, check=True, timeout=timeout_s,
    )
    missing = sorted(p.name for p in DATA.glob("*.npz") if not (out_dir / p.name).exists())
    if out_dir != DATA.resolve() and missing:
        raise RuntimeError(f"committed but not made: {missing}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
