"""`BENCHMARK.json` against the benchmark's contract, and the harness's
finding of its files by name."""

import hashlib
import json
import pathlib
import re
import shutil
import time

from conftest import BENCH, SMALL

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_MAX = 200
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def manifest(root=ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= TEXT_MAX and "\n" not in s and "\t" not in s


def test_manifest_follows_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32 and all(_text(w) for w in m["command"])
    for w in m["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p.rstrip("/") + "/") for p in m["paths"])
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = []
    for kind, keys in KEYS.items():
        assert 1 <= len(m[kind]) <= {"configs": 24, "workloads": 24, "end_to_end": 16,
                                     "per_layer": 128}[kind]
        for e in m[kind]:
            assert set(e) - {"workloads"} == keys, (kind, e["name"])
            assert NAME.match(e["name"])
            names.append(e["name"])
    assert len(names) == len(set(names))
    for c in m["configs"]:
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in m["workloads"]} == {c["name"] for c in m["configs"]}
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    setup = [e for e in m["end_to_end"] if e["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(e["layer"])
    layers = {}
    for e in m["per_layer"]:
        layers.setdefault(e["layer"].lower(), set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_moved_metric_is_reported_where_it_is_read():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    e2e_of = {c: {e["name"] for e in m["end_to_end"] if c in e.get("workloads", cells)}
              for c in cells}
    for e in m["per_layer"]:
        for c in e.get("workloads", cells):
            assert c in cells
            assert e["moves"] in e2e_of[c], (e["name"], c)
    for c in cells:
        assert "setup_s" in e2e_of[c] and len(e2e_of[c]) >= 2
        assert any(c in e.get("workloads", cells) for e in m["per_layer"])


def test_every_file_is_found_by_name():
    m = manifest()
    for c in m["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.parts[len(ROOT.parts)] == "benchmark"
        cfg = json.loads(f.read_text())
        for k in c["reduced"]:
            assert k in cfg and k in cfg["published"]
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    for w in m["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (BENCH / "entries" / f"{traffic['entry']}.py").is_file()
        assert (BENCH / "references" / f"{traffic['entry']}.py").is_file()
        if "expected" in traffic.get("settings", {}):
            assert (BENCH / "expected" / f"{traffic['settings']['expected']}.npz").is_file()
    for e in m["end_to_end"]:
        assert (BENCH / "e2e" / f"{e['name']}.py").is_file()
    for e in m["per_layer"]:
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()


def _digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_new_files(tmp_path):
    """A later change adds a cell (a traffic mix and the cell's limits) and a
    per-layer metric (its reader) as new files and entries of
    `BENCHMARK.json`; the harness finds and runs them with no other file
    edited."""
    from harness import cell

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / "detect_stream.json").read_text())
    traffic.update(warmup_frames=1, trace_seconds=1)
    (bench / "traffic" / "detect_burst.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tum_detect_burst.json").write_text(
        (bench / "limits" / "tum_detect_cuboid.json").read_text())
    (bench / "metrics" / "frames_traced.py").write_text(
        '"""Frames in the profiled stretch."""\n\n\ndef read(ctx):\n'
        '    return ctx["frames_traced"] or None\n')
    m = manifest(root)
    m["workloads"].append({"name": "tum_detect_burst", "config": "tum_fr3",
                           "traffic": "detect_burst", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "frame_ms",
                           "workloads": ["tum_detect_burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    result = cell.run("tum_detect_burst", 2**31 + 5, 4.0, True, time.perf_counter(),
                      device="cpu", overrides=SMALL["tum_fr3"], root=root, log=lambda s: None)
    assert result["correct"]
    assert result["metrics"]["frames_traced"]["value"] >= 1
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {pathlib.Path("BENCHMARK.json")}
