"""What the harness and the reference load, by whole top-level module name:
the port's name begins with the JAX package's, so a prefix test would not
do."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH

ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cube_slam_wu_tpu"}
PORT = "cube_slam_wu_tpu_torch"

LOAD_ALL = """
import json, sys
sys.path[:0] = [BENCH, ROOT]
from harness import cell
for kind in KINDS:
    for p in sorted(cell.BENCH_DIR.joinpath(kind).glob("*.py")):
        cell.load_module(p)
EXTRA
CONTROL
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_levels(kinds, extra="", control=True) -> set:
    code = (LOAD_ALL.replace("BENCH, ROOT", f"{str(BENCH)!r}, {str(ROOT)!r}")
            .replace("KINDS", repr(kinds)).replace("EXTRA", extra)
            .replace("CONTROL", "import control" if control else ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_program_it_drives_load_no_jax():
    """Every file of the harness, every entry with the port modules it drives,
    every reference and the control: nothing of JAX or the JAX package."""
    port = "\n".join(f"import {PORT}.{m}" for m in (
        "ops.detect", "ops.proposal", "ops.cuda_kernels", "utils.hostsync"))
    loaded = _top_levels(("entries", "references", "metrics", "e2e"), port)
    assert PORT in loaded and "harness" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = _top_levels(("references",), "", control=False)
    assert PORT not in loaded and not loaded & FORBIDDEN


# the one file under benchmark/ that imports the JAX package: the maker of
# the expected answers, a tool run on a host that no run of the benchmark
# loads
MAKER = BENCH / "expected" / "make_expected.py"


def _imports(p):
    for node in ast.walk(ast.parse(p.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_the_old_drivers():
    """bench.py and chip_smoke.py measure other things; the benchmark reads
    neither, nor the JAX package (but for the maker of the expected
    answers, which nothing imports); the references and the expected
    answers' maker import nothing of the port."""
    for p in BENCH.rglob("*.py"):
        banned = {"bench", "chip_smoke", "make_expected"}
        if p != MAKER:
            banned |= FORBIDDEN
        if "references" in p.parts or p == MAKER:
            banned.add(PORT)
        assert not {n.split(".")[0] for n in _imports(p)} & banned, p
    assert {"cube_slam_wu_tpu.ops.detect", "cube_slam_wu_tpu.ops.proposal"} <= set(_imports(MAKER))


def test_forbidden_names_are_compared_whole(monkeypatch):
    from harness import cell

    monkeypatch.setitem(sys.modules, "cube_slam_wu_tpu_torch_probe", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cube_slam_wu_tpu.probe", sys)
    assert cell.forbidden_modules() == ["cube_slam_wu_tpu"]


def test_run_without_a_card_prints_no_result():
    """Here there is no CUDA device: the command exits with another code
    than 0 and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "tum_detect_cuboid", "--seed", str(2**31 + 9), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
