"""The control of a cell's comparison: the program run in the next precision
below the configuration's float32, judged by the cell's own numbers and
limits against the expected answers.  A sound comparison finds the control
not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

The lower precision: TF32 products (the port's own switch, which it turns
off at import, turned on) and the line detector's blurred image stored in
bfloat16 (`ops/detect.py::gaussian_blur5` wrapped here).  The expected
answers cannot be computed again in a lower precision, since they are data
made by another implementation; so the program takes the reference's place.
On the card, at the cell's own size: every frame of the fixed world once, in
the order the seed draws.  Prints one JSON line per seed with every number
beside its limit, and whether the control was found not correct.  Not run
by the benchmark's own runs.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

BENCH_DIR = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


@contextlib.contextmanager
def lower_precision():
    import torch

    import cube_slam_wu_tpu_torch.ops.detect as detect

    blur = detect.gaussian_blur5
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())

    def blur_bf16(gray, *a, **k):
        return blur(gray, *a, **k).to(torch.bfloat16).to(gray.dtype)

    detect.gaussian_blur5 = blur_bf16
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        detect.gaussian_blur5 = blur
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class EveryFrame:
    """A window that hands the entry `n` frames and then closes."""

    clock = staticmethod(time.perf_counter)

    def __init__(self, n: int):
        self.n, self.taken = n, 0

    def open(self, now=None) -> bool:
        return self.taken < self.n

    def take(self, now=None) -> int:
        self.taken += 1
        return self.taken - 1

    def done(self, frame, now=None) -> None:
        pass


def control_readings(name: str, seed: int, device: str = "cuda",
                     overrides: dict | None = None) -> dict:
    from types import SimpleNamespace

    import torch

    from harness import cell as cell_mod
    from harness.spans import Spans

    cell = cell_mod.load_cell(name, overrides=overrides)
    world, answers = cell_mod.load_world(cell, seed)
    ctx = SimpleNamespace(cell=cell, settings=cell.settings, traffic=cell.traffic,
                          world=world, expected=answers, seed=seed,
                          device=torch.device(device), spans=Spans())
    entry = cell_mod.load_module(cell.dir / "entries" / f"{cell.entry}.py")
    reference = cell_mod.load_module(cell.dir / "references" / f"{cell.entry}.py")
    with lower_precision():
        program = entry.Program(ctx)
        produced = program.drive(EveryFrame(len(world.images)))
        program.close()
    checks, failed, n = cell_mod.compare(reference, ctx, produced, cell.limits)
    return {"workload": name, "seed": seed, "frames": n, "checks": checks,
            "control_not_correct": failed > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(args.workload, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
