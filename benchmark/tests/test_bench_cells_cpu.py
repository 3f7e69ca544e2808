"""Each cell's whole run on the CPU at a small size: the program against the
expected answers, the end-to-end metrics, and the per-layer metrics a traced
run reads on the host."""

import time

import pytest

from conftest import SMALL

CELLS = {"tum_detect_cuboid": "tum_fr3"}
HOST_LAYER = {
    "tum_detect_cuboid": {"proposals_host_ms", "detect_lines_host_ms", "host_reads_per_frame"},
}


def run_small(name, seed, trace=False, seconds=10.0):
    from harness import cell

    return cell.run(name, seed, seconds, trace, time.perf_counter(), device="cpu",
                    overrides=SMALL[CELLS[name]], log=lambda s: None)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_agrees_with_its_reference_on_cpu(name):
    r = run_small(name, 2**31 + 101)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"] and all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reads_the_host_layers_on_cpu(name):
    r = run_small(name, 2**31 + 102, trace=True, seconds=14.0)
    assert r["correct"]
    assert HOST_LAYER[name] <= set(r["metrics"])
    assert "breakdown" in r and r["device"]["window_s"] > 0


def test_expected_file_made_with_other_settings_is_refused():
    from harness import cell

    with pytest.raises(cell.Refused, match="other settings"):
        cell.run("tum_detect_cuboid", 2**31 + 103, 1.0, False, time.perf_counter(),
                 device="cpu", overrides={**SMALL["tum_fr3"], "top_k": 4}, log=lambda s: None)
