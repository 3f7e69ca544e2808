"""What the compiler made of the EDT row kernel, and its time on the card.

    python -m cube_slam_wu_tpu_torch.tools.edt_sass [--out DIR]

Builds csrc/edt_row_min.cu with `-Xptxas -v` (registers and spills go to
DIR/edt_row_min.ptxas.txt), dumps its SASS with cuobjdump
(DIR/edt_row_min.sass) and counts the instructions the design is about (FFMA,
FMNMX, the three-input integer min, FADD, LDS).  Then it holds the kernel
against the plain version (bit-equal) and times it at the production shapes,
reads the SM clock and power draw under that load, and prints one JSON object
per line.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import threading
import time

import torch

from cube_slam_wu_tpu_torch.ops import cuda_kernels
from cube_slam_wu_tpu_torch.tools.cardtime import g2_from_rendered, nvidia_smi_line, time_ms

SHAPES = ((3, 480, 640), (1, 375, 1242))
COUNTED = ("FFMA", "FMNMX", "VIMNMX3", "VIMNMX", "IMNMX", "FADD", "LDS", "BRA")


def build_verbose(out: pathlib.Path) -> str:
    """Build the library where the wrapper looks for it, with ptxas's report."""
    cmd = cuda_kernels.nvcc_command("edt_row_min")
    lib = pathlib.Path(cmd[-2])
    lib.parent.mkdir(parents=True, exist_ok=True)
    run = [cuda_kernels._find_nvcc(), "-Xptxas", "-v", *cmd[1:]]
    done = subprocess.run(run, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}\n{done.stderr}")
    (out / "edt_row_min.ptxas.txt").write_text(done.stdout + done.stderr)
    return str(lib)


def sm_clock_under_load(fn, seconds: float = 1.5) -> dict:
    """SM clock and power draw read by nvidia-smi while `fn` is launched back
    to back."""
    samples = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                capture_output=True, text=True,
            )
            if r.returncode == 0:
                mhz, watt = r.stdout.strip().splitlines()[0].split(",")
                samples.append((float(mhz), float(watt)))

    t = threading.Thread(target=poll)
    t.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    stop.set()
    t.join()
    body = samples[1:] or samples
    return {"sm_mhz_median": statistics.median(m for m, _ in body),
            "power_draw_w_median": statistics.median(w for _, w in body), "samples": len(body)}


def sass_counts(lib: str, out: pathlib.Path) -> dict:
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(cuda_kernels._find_nvcc()).with_name("cuobjdump")
    )
    done = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {done.stderr}")
    (out / "edt_row_min.sass").write_text(done.stdout)
    counts: dict = {}
    name = None
    for line in done.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.search(r"^\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)", line)
        if m and name:
            op = m.group(1)
            if op in COUNTED:
                counts[name][op] += 1
    return {k: dict(v) for k, v in counts.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("edt_sass: needs a CUDA device")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": nvidia_smi_line(), "torch": torch.__version__}), flush=True)
    lib = build_verbose(out)
    ptxas = (out / "edt_row_min.ptxas.txt").read_text()
    regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers", ptxas, re.S)
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    print(json.dumps({"registers": {n: int(r) for n, r in regs},
                      "max_spill_bytes": max([int(s) for s in spills] or [0])}), flush=True)
    print(json.dumps({"sass_counts": sass_counts(lib, out)}), flush=True)

    for k, shape in enumerate(SHAPES):
        g2 = g2_from_rendered(shape, seed=k)
        got = cuda_kernels.edt_row_min(g2)
        torch.cuda.synchronize()
        if not torch.equal(got, cuda_kernels.edt_row_min_plain(g2)):
            raise RuntimeError(f"edt_row_min != plain at {shape}")
        ms = [time_ms(lambda: cuda_kernels.edt_row_min(g2), graph=True) for _ in range(2)]
        clock = sm_clock_under_load(lambda: cuda_kernels.edt_row_min(g2))
        print(json.dumps({"shape": list(shape), "bit_equal": True, "ms": ms,
                          "under_load": clock}), flush=True)


if __name__ == "__main__":
    main()
