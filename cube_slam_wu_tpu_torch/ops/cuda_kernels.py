"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

`edt_row_min` replaces the Pallas TPU kernel `ops/pallas_kernels.py::
edt_row_min` of the JAX package: the row pass of the exact Euclidean distance
transform, `out[y, x] = sqrt(max(0, min_x' ((x - x')^2 + g2[y, x'])))`,
batched over boxes.

Bound on an H100: `B*H*W^2` candidates of one fused multiply-add and one min
against `2*B*H*W*4` bytes, i.e. about `W/2` operations per byte; the
instruction rate of the SMs bounds it, not device memory.  The kernel
(csrc/edt_row_min.cu) therefore stages each row once in shared memory, keeps
the running minima of several output columns per thread in registers, and
folds two candidates into the minimum with one three-input integer min on the
bit patterns (all candidates are made non-negative by a constant that comes
off at the end).  None of the TPU kernel's (8, 128) padding or its 128-column
chunk loop is carried over; the ragged edge is handled by bounds.

The kernel is compiled with nvcc at first use into a shared library with a
plain C interface and loaded with ctypes.  The wrapper takes the plain version
only for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
MAX_WIDTH = 2048  # the row of `a` is staged in shared memory
# The kernel adds the constant K = Wp * max(Wp, 64) (Wp: W rounded up to 4) to
# every candidate; its integer terms reach K + W^2 + H^2, which must stay
# exactly representable in float32 for the result to keep the plain version's
# bits.  That also needs an integer-valued g2 (see `edt_row_min`).
EXACT_LIMIT = 2**24

# Launch counts, one per kernel: a wrapper adds one where it launches its
# kernel and nowhere else (under `_count_lock`: the pipelined front end
# launches from two threads).  LAUNCH_SHAPES holds the input shape of each
# kernel's last launch.
LAUNCHES = {"edt_row_min": 0}
LAUNCH_SHAPES: dict = {}
_count_lock = threading.Lock()
# What the last build did: the nvcc command and the seconds it took.
BUILD_LOG: dict = {}

_libs: dict = {}
_load_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def build_dir() -> pathlib.Path:
    """Where compiled kernels go: `build/` beside the package."""
    return pathlib.Path(__file__).resolve().parents[2] / "build"


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(name: str, out_path=None) -> list:
    """The command that builds csrc/<name>.cu (without running it)."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    if out_path is None:
        out_path = build_dir() / f"lib{name}_{digest}.so"
    return ["nvcc", *NVCC_FLAGS, "-o", str(out_path), str(src)]


def start_build(name: str):
    """Start nvcc for csrc/<name>.cu without waiting (so that several sources
    compile side by side).  Returns a handle for `finish_build`, or None when
    the library is already built."""
    cmd = nvcc_command(name)
    final = pathlib.Path(cmd[-2])
    if final.exists():
        BUILD_LOG[name] = {"cmd": " ".join(cmd), "seconds": 0.0, "cached": True}
        return None
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".tmp{os.getpid()}.so")
    run = [_find_nvcc(), *cmd[1:-2], str(tmp), cmd[-1]]
    proc = subprocess.Popen(run, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return name, cmd, proc, tmp, final, time.perf_counter()


def finish_build(handle) -> None:
    if handle is None:
        return
    name, cmd, proc, tmp, final, t0 = handle
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n{out.decode(errors='replace')}"
        )
    os.replace(tmp, final)
    BUILD_LOG[name] = {
        "cmd": " ".join(cmd),
        "seconds": time.perf_counter() - t0,
        "cached": False,
    }


def _load(name: str) -> ctypes.CDLL:
    with _load_lock:  # threads that launch at once build and load it once
        lib = _libs.get(name)
        if lib is None:
            finish_build(start_build(name))
            lib = ctypes.CDLL(nvcc_command(name)[-2])
            _libs[name] = lib
    return lib


def _edt_lib() -> ctypes.CDLL:
    lib = _load("edt_row_min")
    fn = lib.edt_row_min_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def edt_row_min_plain(g2: torch.Tensor, row_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version: the dense reduction
    `sqrt(min_x' (g2[..., y, x'] + (x - x')^2))`, a chunk of rows at a time."""
    g2 = g2.to(torch.float32)
    h, w = g2.shape[-2:]
    xs = torch.arange(w, dtype=g2.dtype, device=g2.device)
    dx2 = (xs[:, None] - xs[None, :]) ** 2  # (w out, w src)
    out = torch.empty_like(g2)
    for y0 in range(0, h, row_chunk):
        blk = g2[..., y0 : y0 + row_chunk, :]
        out[..., y0 : y0 + row_chunk, :] = torch.amin(
            blk[..., :, None, :] + dx2, dim=-1
        )
    if out.device.type == "cpu":
        # A CPU math library's vectorised float32 sqrt need not be correctly
        # rounded (builds that route it through a low-accuracy vector mode are
        # an ulp off); through float64 it is, and the distance map stays
        # bit-equal to the card's sqrtf.
        return torch.sqrt(out.to(torch.float64)).to(torch.float32)
    return torch.sqrt(out)


def edt_row_min(g2: torch.Tensor) -> torch.Tensor:
    """Row pass of the exact EDT for `g2 (..., H, W)`; float32 out.

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    (built on first use) or raises.

    Precondition on the card: `g2` is what `distance_transform` gives, squared
    column distances that are integer-valued and at most H^2, or the 1e12 of a
    column without an edge.  Then the kernel's result has the plain version's
    bits (the shape is checked against `EXACT_LIMIT`).  A fractional `g2` is
    rounded to the float32 spacing at K + W^2, up to 0.5 at `MAX_WIDTH`.
    """
    if g2.device.type == "cpu":
        return edt_row_min_plain(g2)
    if g2.device.type != "cuda":
        raise RuntimeError(f"edt_row_min: unsupported device {g2.device}")
    if g2.ndim < 2:
        raise ValueError("edt_row_min: need (..., H, W)")
    h, w = g2.shape[-2:]
    if w > MAX_WIDTH:
        raise ValueError(f"edt_row_min: width {w} above {MAX_WIDTH}")
    wp = (w + 3) // 4 * 4
    if wp * max(wp, 64) + w * w + h * h > EXACT_LIMIT:
        raise ValueError(
            f"edt_row_min: K + W^2 + H^2 above 2^24 at {h}x{w}: the result "
            "would not be exact"
        )
    g2 = g2.to(torch.float32).contiguous()
    out = torch.empty_like(g2)
    rows = g2.numel() // w if w else 0
    if rows == 0:
        return out
    lib = _edt_lib()
    with torch.cuda.device(g2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_row_min_launch(g2.data_ptr(), out.data_ptr(), rows, w, stream)
    with _count_lock:
        LAUNCHES["edt_row_min"] += 1
        LAUNCH_SHAPES["edt_row_min"] = tuple(g2.shape)
    if err != 0:
        raise RuntimeError(f"edt_row_min: kernel launch failed (cudaError {err})")
    return out
