"""The port's runtime tools on the CPU: `native.py` against the JAX package's
on the same tables, profiler sections and files; its library built under
`build/` and never under `native/`; its Python fallbacks; `utils/profiler.py`
against the JAX package's; and `utils.hostsync.stage` splitting the host
reads of a run of the fused step by stage, summing to the totals.
"""

import functools
import hashlib
import json
import pathlib
import subprocess
import time

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from cube_slam_wu_tpu import native as jnative
from cube_slam_wu_tpu.utils import profiler as jprof
from cube_slam_wu_tpu_torch import native
from cube_slam_wu_tpu_torch.ops import cuda_kernels
from cube_slam_wu_tpu_torch.utils import hostsync
from cube_slam_wu_tpu_torch.utils import profiler as tprof

REPO = pathlib.Path(__file__).resolve().parents[1]
TABLES = {
    "comments_ragged": "# header line\n1 2 3\n\n4 5\n6 7 8 9\n",
    "signs_exponents": "  -1.5e-3\t+2 3.25E2\n# x\n7\n",
    "empty": "",
}


@pytest.fixture(scope="module", autouse=True)
def _bounded_build():
    """The `$CXX` build of the library (3-8 s), wherever a test of this
    module first needs it, fails after 60 s instead of running on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native.subprocess, "run", functools.partial(subprocess.run, timeout=60))
        yield


def _native_dir_state():
    """(git status of native/ or None without git, name -> sha256 and mtime)."""
    files = {p.name: (hashlib.sha256(p.read_bytes()).hexdigest(), p.stat().st_mtime_ns)
             for p in sorted((REPO / "native").iterdir())}
    try:
        out = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=REPO,
                             capture_output=True, text=True, timeout=60)
        status = out.stdout if out.returncode == 0 else None
    except OSError:
        status = None
    return status, files


def test_source_is_byte_equal_to_the_jax_packages():
    assert native.SOURCE.read_bytes() == (REPO / "native" / "cubeslam_native.cpp").read_bytes()


def test_library_builds_under_build_dir_and_never_under_native(tmp_path, monkeypatch):
    before = _native_dir_state()
    # the default place: the git-ignored build/ of the kernels, keyed by the
    # source's hash
    assert native.lib_path().parent == cuda_kernels.build_dir()
    assert native.lib_path().name.startswith("libcubeslam_native_")
    assert native.available(), native.BUILD_LOG
    assert native.lib_path().exists()
    # a fresh build (into an empty build dir) with the Makefile's flags
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(native, "BUILD_LOG", {})
    built = native._build()
    assert built.parent == tmp_path / "build" and built.exists()
    assert native.BUILD_LOG["cached"] is False
    for flag in ("-O3", "-std=c++17", "-fPIC", "-shared", "-lpthread"):
        assert flag in native.BUILD_LOG["cmd"].split()
    after = _native_dir_state()
    assert after == before
    if after[0] is not None:
        assert after[0] == ""


@pytest.mark.parametrize("name", sorted(TABLES))
def test_parse_table_matches_jax(name):
    text = TABLES[name]
    ours, ref = native.parse_table(text), jnative.parse_table(text)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_read_table_matches_jax_and_numpy(tmp_path):
    arr = np.random.default_rng(0).normal(size=(37, 8))
    p = tmp_path / "t.txt"
    np.savetxt(p, arr)
    ours = native.read_table(p)
    np.testing.assert_array_equal(ours, jnative.read_table(p))
    np.testing.assert_allclose(ours, arr, rtol=1e-12)


def _section_line(report, name):
    return [line.split() for line in report.splitlines() if line.split()[:1] == [name]][0]


def test_profilers_aggregate_like_jax():
    """The native profiler of both packages, and the Python profiler of
    both, list a section timed 3 times with the same columns."""
    for mod in (native, jnative):
        mod.prof_reset()
        for _ in range(3):
            mod.prof_tictoc("unit-test-section")
            time.sleep(0.002)
            mod.prof_tictoc("unit-test-section")
    ours, ref = (_section_line(m.prof_report(), "unit-test-section") for m in (native, jnative))
    assert ours[1] == ref[1] == "3" and len(ours) == len(ref)
    for mod in (native, jnative):
        mod.prof_reset()
        assert "unit-test-section" not in mod.prof_report()

    reports = []
    for mod in (tprof, jprof):
        p = mod.Profiler()
        for _ in range(3):
            with p.section("outer"):
                p.tictoc("inner")
                p.tictoc("inner")
        reports.append(p.report())
        p.reset()
        assert p.report() == reports[-1].splitlines()[0]
    assert reports[0].splitlines()[0] == reports[1].splitlines()[0]  # same columns
    assert [r.split()[:2] for r in reports[0].splitlines()[1:]] == [["outer", "3"], ["inner", "3"]]
    assert sorted(r.split()[:2] for r in reports[1].splitlines()[1:]) == \
        sorted(r.split()[:2] for r in reports[0].splitlines()[1:])


def test_prefetcher_matches_jax(tmp_path):
    paths = []
    for i in range(10):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (1000 + i))
        paths.append(p)
    ours, ref = native.FilePrefetcher(paths, n_threads=3), jnative.FilePrefetcher(paths, n_threads=3)
    assert len(ours) == len(ref) == 10
    for i in [7, 0, 9, 3]:  # out of order
        assert ours.get(i) == ref.get(i) == bytes([i]) * (1000 + i)
    ours.close()
    ref.close()
    for mod in (native, jnative):
        pf = mod.FilePrefetcher([tmp_path / "nope.bin"])
        with pytest.raises(IOError):
            pf.get(0)
        pf.close()


def test_python_fallback(tmp_path, monkeypatch):
    """Without the library every entry point still works, through the
    port's utils.io and utils.profiler.GLOBAL."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    assert not native.available()
    for text in TABLES.values():
        if text:
            np.testing.assert_array_equal(native.parse_table(text), jnative.parse_table(text))
    native.prof_reset()
    native.prof_tictoc("fallback-section")
    native.prof_tictoc("fallback-section")
    assert _section_line(tprof.GLOBAL.report(), "fallback-section")[1] == "1"
    assert "fallback-section" in native.prof_report()
    native.prof_reset()
    p = tmp_path / "a.bin"
    p.write_bytes(b"abc")
    pf = native.FilePrefetcher([p, tmp_path / "nope.bin"])
    assert pf.get(0) == b"abc"
    with pytest.raises(IOError):
        pf.get(1)


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with tprof.torch_trace(tmp_path / "trace"):
        (torch.ones(8) * 2).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_host_reads_by_stage_sum_to_the_totals():
    """The fused step over 3 frames at 240x320 on the CPU: the reads, uploads
    and downloads booked by stage sum to the totals, the stages that read
    flags are the ones that hold them, and the run's own reads per frame are
    the totals' (the stages add no read)."""
    from cube_slam_wu_tpu_torch.slam.online import run_online_frames, sequence_frames
    from cube_slam_wu_tpu_torch.utils import synth

    seq = synth.make_sequence(n_frames=3, size=(240, 320), n_objects=3, seed=0)
    s0 = hostsync.snapshot()
    res = run_online_frames(sequence_frames(seq.images, seq.detections, 3), seq.K, seq.T_wc[0], 3,
                            max_objects=3, max_detections=3, capacity=4, device="cpu")
    d = hostsync.delta(s0, hostsync.snapshot())
    for key in ("syncs", "d2h_bytes", "h2d_bytes"):
        assert sum(v[key] for v in d["by_stage"].values()) == d[key] > 0
    assert res.syncs_per_frame == d["syncs"] / 3
    assert d["by_stage"]["lines/merge"]["syncs"] > 0  # the merge loop's flags
    assert d["by_stage"]["proposals/canny"]["syncs"] > 0  # Canny's hysteresis flags
    assert d["by_stage"]["online/cap_check"]["syncs"] == 3  # one per frame
    assert d["by_stage"][hostsync.OUTSIDE]["h2d_bytes"] > 0  # the frames' uploads
    with hostsync.stage("outer"):
        with hostsync.stage("inner"):
            hostsync.host_bool(torch.ones((), dtype=torch.bool))
        hostsync.pull((torch.zeros(4),))
    by = hostsync.snapshot()["by_stage"]
    assert by["inner"]["syncs"] == 1 and by["outer"]["syncs"] == 1  # innermost only
