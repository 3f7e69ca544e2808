"""One run of one cell: set-up, the timed window, the profiled stretch, the
comparison with the reference, and the result line.

Everything that belongs to one cell is found by name under `benchmark/`:
the configuration's file (named in `BENCHMARK.json`), the traffic mix
(`traffic/<traffic>.json`), the cell's limits (`limits/<cell>.json`), the
entry that drives the program (`entries/<entry>.py`) and its reference
(`references/<entry>.py`), the expected answers where the traffic names a
file of them (`expected/<name>.npz`), the end-to-end metrics
(`e2e/<metric>.py`) and the per-layer metrics (`metrics/<metric>.py`).  The
entry is the one the traffic names.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from types import SimpleNamespace

import torch

from harness import expected as expected_mod
from harness import world as world_mod
from harness.spans import Spans
from harness.trace import STRETCH, busy_ns, collect, idle_by_stage, top_ops
from harness.window import Tracer, Window, clock

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# compared by the whole top-level name: the port's name begins with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "cube_slam_wu_tpu")


class Refused(Exception):
    """The run cannot measure: no result is printed and the exit code is not 0."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: pathlib.Path):
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def one(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise Refused(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def load_cell(name: str, root: pathlib.Path = ROOT, overrides: dict | None = None) -> SimpleNamespace:
    """The cell's entries and files, without the world."""
    manifest = read_json(root / "BENCHMARK.json")
    wl = one(manifest["workloads"], name, "workload")
    cfg_entry = one(manifest["configs"], wl["config"], "configuration")
    config = read_json(root / cfg_entry["file"])
    bench = root / BENCH_DIR.name
    traffic = read_json(bench / "traffic" / f"{wl['traffic']}.json")
    settings = {**config, **traffic.get("settings", {}), **(overrides or {})}
    return SimpleNamespace(
        name=name, manifest=manifest, workload=wl, config=config, traffic=traffic,
        settings=settings, limits=read_json(bench / "limits" / f"{name}.json"),
        entry=traffic["entry"], dir=bench,
    )


def load_world(cell, seed: int) -> tuple:
    """(the world, the expected answers): read from the traffic's `expected`
    file where it names one, else the world rendered from the seed and no
    answers."""
    name = cell.settings.get("expected")
    if not name:
        return world_mod.make_world(cell.settings, seed), None
    path = expected_mod.file_of(cell.dir, name)
    if not path.is_file():
        raise Refused(f"missing {path}")
    world, answers, differ = expected_mod.load(path, cell.settings)
    if differ:
        raise Refused(f"{path.name} was made with other settings: {', '.join(differ)}")
    return world, answers


def metric_entries(cell) -> tuple:
    """The cell's end-to-end metrics, and its per-layer metrics: those that
    list the cell, and those without a list whose moved metric it reports."""
    m = cell.manifest
    e2e = [e for e in m["end_to_end"] if cell.name in e.get("workloads", [cell.name])]
    names = {e["name"] for e in e2e}
    layer = [e for e in m["per_layer"]
             if (cell.name in e["workloads"] if "workloads" in e else e["moves"] in names)]
    return e2e, layer


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _per_frame(delta: dict, spans_before: dict, spans_after: dict, frames: int) -> dict:
    """Host seconds and counts per frame by stage label: the program's stages
    (`utils.hostsync`) and the harness's own spans."""
    stages = {label: dict(c) for label, c in delta["by_stage"].items()}
    for label, c in spans_after.items():
        b = spans_before.get(label, {"entries": 0, "host_s": 0.0})
        stages[label] = {k: (c[k] - b[k]) / frames for k in c}
    return stages


def run(name: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", overrides: dict | None = None, root: pathlib.Path = ROOT,
        log=None) -> dict:
    """One run of the cell `name`; returns the result line (a dict), or
    raises `Refused`.  `device="cpu"` and `overrides` are for the tests of
    the harness (a small world on the CPU); the command runs the card."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    cell = load_cell(name, root, overrides)
    chips = int(cell.workload["chips"])
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise Refused(f"needs {chips} CUDA device(s); "
                      f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from cube_slam_wu_tpu_torch.ops import cuda_kernels
    from cube_slam_wu_tpu_torch.utils import hostsync

    t_import = clock()
    world, answers = load_world(cell, seed)
    t_render = clock()
    spans = Spans()
    run_ctx = SimpleNamespace(cell=cell, settings=cell.settings, traffic=cell.traffic,
                              world=world, expected=answers, device=torch.device(device),
                              seed=seed, spans=spans)
    entry = load_module(cell.dir / "entries" / f"{cell.entry}.py")
    program = entry.Program(run_ctx)
    program.warmup()
    _sync(device)
    t_ready = clock()
    setup_s = t_ready - t_process

    tracer = None
    if trace:
        tracer = Tracer(float(cell.traffic["trace_seconds"]), hostsync.snapshot, spans, cuda)
    window = Window(seconds, tracer)
    counts0, spans0 = hostsync.snapshot(), spans.copy()
    window.start()
    produced = program.drive(window)
    _sync(device)
    window.open()  # ends the profiled stretch if the entry returned inside the window
    t_drained = clock()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    notes = program.notes(produced)
    program.close()
    del program
    if cuda:
        torch.cuda.empty_cache()

    counted = window.counted()
    if not counted:
        raise Refused("no frame's result reached the host inside the window")
    run_ctx.window, run_ctx.setup_s = window, setup_s
    e2e, layer = metric_entries(cell)
    if trace:
        readers, ctx = "metrics", _layer_context(cell, tracer, counts0, spans0, cuda_kernels)
    else:
        readers, ctx = "e2e", run_ctx
    metrics = {}
    for m in (layer if trace else e2e):
        value = load_module(cell.dir / readers / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the comparison with the reference, after the window and with the
    # program's state freed
    t_ref = clock()
    reference = load_module(cell.dir / "references" / f"{cell.entry}.py")
    checks, failed, n_compared = compare(reference, run_ctx, produced, cell.limits)
    ref_s = clock() - t_ref
    correct = failed == 0

    lat = window.latencies_s()
    log(f"cell {name} seed {seed}: {len(counted)} frames counted in {seconds} s "
        f"(frame_ms_p90 over {len(lat)} latencies), {window.taken_in_window()} taken, "
        f"{n_compared} of {len(produced)} produced item(s) compared")
    log(f"set-up {setup_s:.4f} s: import {t_import - t_process:.4f} s, frames "
        f"{t_render - t_import:.4f} s, nvcc build "
        f"{cuda_kernels.BUILD_LOG.get('edt_row_min', {}).get('seconds', 0.0):.4f} s, "
        f"warm-up {t_ready - t_render:.4f} s; after the window {t_drained - window.deadline:.4f} s, "
        f"reference {ref_s:.4f} s")
    log("notes " + json.dumps(notes))
    if cuda:
        log(f"device {torch.cuda.get_device_name(0)}; memory peak {memory_peak} bytes; "
            f"kernel launch shapes {dict(cuda_kernels.LAUNCH_SHAPES)}")
    for k, v in checks.items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": window.taken_in_window(), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and tracer is not None and tracer.state == "stopped":
        tr = tracer.trace
        device_info["busy_s"] = busy_ns(tr) / 1e9
        device_info["window_s"] = (tr.end_ns - tr.start_ns) / 1e9
        result["breakdown"] = {"device_ops": top_ops(tr), "idle_gaps": idle_by_stage(tr)}
    result["checks"] = checks
    return result


def _layer_context(cell, tracer, counts0, spans0, cuda_kernels) -> dict:
    """What the per-layer readers read: host seconds and reads per frame by
    stage over the window's frames before the profiled stretch, and the
    stretch's device trace with its frame count."""
    from cube_slam_wu_tpu_torch.utils import hostsync

    ctx = {"cell": cell.name, "entry": cell.entry, "stages": {}, "frames_outside": 0,
           "reads_per_frame": None, "trace": None, "frames_traced": 0,
           "launch_shapes": dict(cuda_kernels.LAUNCH_SHAPES)}
    if tracer is None or tracer.state != "stopped":
        return ctx
    if not hasattr(tracer, "trace"):
        tracer.trace = _stretch(tracer)
    frames = tracer.frames_before
    if frames > 0:
        delta = hostsync.delta(counts0, tracer.counts_before, per=frames)
        ctx.update(stages=_per_frame(delta, spans0, tracer.spans_before, frames),
                   frames_outside=frames, reads_per_frame=delta["syncs"])
    ctx.update(trace=tracer.trace, frames_traced=tracer.frames_traced)
    return ctx


def _stretch(tracer):
    marks = [e for e in tracer.prof.profiler.kineto_results.events()
             if e.name() == STRETCH and e.is_user_annotation()
             and e.device_type() == torch.autograd.DeviceType.CPU]
    s = marks[0].start_ns()
    return collect(tracer.prof, s, s + marks[0].duration_ns())


def compare(reference, run_ctx, produced, limits: dict) -> tuple:
    """Each number the reference reads over the produced items, beside its
    limit; the items with a miss where a number broke its limit (else 0);
    and how many items were compared."""
    values, missed, n = reference.readings(run_ctx, produced)
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])} for k in sorted(values)}
    ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return checks, 0 if ok else max(missed, 1), n
