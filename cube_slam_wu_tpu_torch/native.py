"""ctypes bindings for the native runtime library (csrc/cubeslam_native.cpp).

Exposes fast table parsing, the aggregating tictoc profiler and the threaded
file prefetcher of the C++ runtime; host code, no device kernel.  The
library is built at first use with `$CXX` (default `g++`) into the
git-ignored `build/` beside the package (`ops.cuda_kernels.build_dir`),
under a name keyed by a hash of the source, so a changed source builds anew
and nothing outside `build/` is written.  Where no compiler is found or the
build fails, every entry point falls back to Python (`utils.io`,
`utils.profiler.GLOBAL`), as the JAX package's `native.py` does; `BUILD_LOG`
records why (compiler, command, stderr), and `available()` says which side
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import numpy as np

from cube_slam_wu_tpu_torch.ops.cuda_kernels import build_dir

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "cubeslam_native.cpp"
# the flags of the JAX package's native/Makefile
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
# What the last build did: compiler, command, seconds, and on failure the
# compiler's output.
BUILD_LOG: dict = {}

_lib = None
_build_failed = False


def lib_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libcubeslam_native_{digest}.so"


def build_command(out_path=None) -> list:
    """The command that builds the library (without running it)."""
    cxx = os.environ.get("CXX", "g++")
    out = lib_path() if out_path is None else out_path
    return [cxx, *CXXFLAGS, "-shared", "-o", str(out), str(SOURCE), "-lpthread"]


def _build() -> pathlib.Path:
    final = lib_path()
    cmd = build_command()
    if final.exists():
        BUILD_LOG.update(compiler=cmd[0], cmd=" ".join(cmd), seconds=0.0, cached=True)
        return final
    if shutil.which(cmd[0]) is None:
        BUILD_LOG.update(compiler=cmd[0], cmd=" ".join(cmd), error="compiler not found")
        raise OSError(f"native: compiler {cmd[0]!r} not found")
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        BUILD_LOG.update(compiler=cmd[0], cmd=" ".join(cmd), error=f"exit {proc.returncode}",
                         stderr=proc.stderr)
        tmp.unlink(missing_ok=True)
        raise OSError(f"native: build failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, final)
    BUILD_LOG.update(compiler=cmd[0], cmd=" ".join(cmd), seconds=time.perf_counter() - t0,
                     cached=False)
    return final


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except OSError as e:
        BUILD_LOG.setdefault("error", str(e))
        _build_failed = True
        return None

    lib.csn_parse_table.restype = ctypes.c_int
    lib.csn_parse_table.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.csn_prof_tictoc.argtypes = [ctypes.c_char_p]
    lib.csn_prof_report.restype = ctypes.c_long
    lib.csn_prof_report.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.csn_loader_create.restype = ctypes.c_void_p
    lib.csn_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.csn_loader_get.restype = ctypes.c_long
    lib.csn_loader_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.csn_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_table(text: str | bytes, max_rows: int = 100000, max_cols: int = 16) -> np.ndarray:
    """Parse a whitespace numeric table (native fast path with Python
    fallback); matches utils.io.read_number_txt semantics."""
    lib = _load()
    if isinstance(text, str):
        text = text.encode()
    if lib is None:
        from cube_slam_wu_tpu_torch.utils.io import read_number_txt

        with tempfile.NamedTemporaryFile(suffix=".txt", delete=False) as f:
            f.write(text)
            name = f.name
        try:
            return read_number_txt(name)
        finally:
            pathlib.Path(name).unlink()
    out = np.zeros((max_rows, max_cols), dtype=np.float64)
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    lib.csn_parse_table(
        text,
        len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows,
        max_cols,
        ctypes.byref(rows),
        ctypes.byref(cols),
    )
    return out[: rows.value, : cols.value].copy()


def read_table(path) -> np.ndarray:
    return parse_table(pathlib.Path(path).read_bytes())


def prof_tictoc(name: str) -> None:
    lib = _load()
    if lib is None:
        from cube_slam_wu_tpu_torch.utils.profiler import GLOBAL

        GLOBAL.tictoc(name)
        return
    lib.csn_prof_tictoc(name.encode())


def prof_report() -> str:
    lib = _load()
    if lib is None:
        from cube_slam_wu_tpu_torch.utils.profiler import GLOBAL

        return GLOBAL.report()
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.csn_prof_report(buf, len(buf))
    return buf.raw[:n].decode()


def prof_reset() -> None:
    lib = _load()
    if lib is None:
        from cube_slam_wu_tpu_torch.utils.profiler import GLOBAL

        GLOBAL.reset()
        return
    lib.csn_prof_reset()


class FilePrefetcher:
    """Threaded read-ahead over a list of files (native loader when
    available).  Use for overlapping dataset IO with device compute."""

    def __init__(self, paths, n_threads: int = 4):
        self.paths = [str(p) for p in paths]
        self._lib = _load()
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._keepalive = arr
            self._handle = self._lib.csn_loader_create(arr, len(self.paths), n_threads)
        else:
            self._handle = None

    def get(self, idx: int) -> bytes:
        if self._handle is None:
            return pathlib.Path(self.paths[idx]).read_bytes()
        n = self._lib.csn_loader_get(self._handle, idx, None, 0)
        if n < 0:
            raise IOError(f"prefetch failed: {self.paths[idx]}")
        buf = ctypes.create_string_buffer(n)
        self._lib.csn_loader_get(self._handle, idx, buf, n)
        return buf.raw

    def close(self) -> None:
        if self._handle is not None:
            self._lib.csn_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return len(self.paths)
