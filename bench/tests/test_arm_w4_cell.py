"""The ARM deployment's cell (``arm-w4-iter256``: four workers read by the
INA231 window sensor) found by name, and its shape checked at a tiny size
on the CPU."""

import json

import torch

import harness
from conftest import BENCH, ROOT, make_tiny

CELL = "arm-w4-iter256"
SIX = {"entry_fixed_ms", "host_ms_per_chunk", "kernels_per_chunk",
       "miss_wall_pct", "sample_attr_roofline", "device_idle_pct"}


def test_the_committed_arm_cell_loads_by_name():
    cell = harness.load_cell(ROOT, CELL)
    cfg = cell.config
    assert cell.workload["config"] == cfg["name"] == "alea-arm-w4-ina231"
    assert (cfg["workers"], cfg["sensor"], cfg["period_s"],
            cfg["jitter_s"]) == (4, "ina231", 2.8e-4, 5.6e-5)
    assert cfg["samples_per_profile"] == 2.6e7
    assert cfg["limits"] == {"order_gap": 0, "count_gap": 0,
                             "mean_gap": 1e-9, "spread_gap": 1e-9}
    assert cell.traffic == json.loads(
        (BENCH / "traffic" / "iter256.json").read_text())
    assert {m["name"] for m in cell.end_to_end} == {
        "samples_per_s", "peak_device_mib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == SIX
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == [] and "4.5" in entry["source"]


def test_the_arm_cell_shape_is_correct_at_a_tiny_size(tmp_path):
    """The committed configuration (4 workers, INA231, its period and
    jitter) at a tiny chunk and sample count, traced on the CPU: correct,
    with the program-read metrics."""
    root, bench = make_tiny(tmp_path)
    cfg = json.loads(
        (BENCH / "configs" / "alea-arm-w4-ina231.json").read_text())
    cfg.update(name="tiny-arm-w4", chunk_size=4096,
               samples_per_profile=60000)
    (bench / "configs" / "tiny-arm-w4.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny-arm-w4", source="tests",
                                file="bench/configs/tiny-arm-w4.json",
                                reduced=[], why="tests"))
    spec["workloads"].append(dict(name="tiny-arm-w4", config="tiny-arm-w4",
                                  traffic="tiny", chips=1, why="tests"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-arm-w4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(root, "tiny-arm-w4", bench)
    assert {m["name"] for m in cell.per_layer} == SIX
    out = harness.run(cell, seed=2**31 + 11, seconds=0, trace=True,
                      dev=torch.device("cpu"), t_start=0.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["order_gap"]["value"] == 0
    assert out["checks"]["count_gap"]["value"] == 0
    assert {"entry_fixed_ms", "host_ms_per_chunk",
            "miss_wall_pct"} <= set(out["metrics"])

