"""The harness on the CPU: the spec's form, cells found by name from new
files, the result line, and the check failing runs whose timed path is
broken underneath."""

import dataclasses
import hashlib
import json
import re
import subprocess
import sys

import pytest
import torch

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


def _run(root, bench, name, trace=False, seconds=0):
    cell = harness.load_cell(root, name, bench)
    return harness.run(cell, seed=2**31 + 3, seconds=seconds, trace=trace,
                       dev=CPU, t_start=0.0)


def test_benchmark_json_keeps_to_the_contract():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["limits"]) == {"order_gap", "count_gap", "mean_gap",
                                      "spread_gap"}
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        names.append(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert w["config"] in names
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        names += [w["name"], w["traffic"]]
    assert len(pairs) == len(SPEC["workloads"])
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _digests(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in path.rglob("*") if p.is_file()}


def test_a_cell_of_new_files_is_found_by_name(tiny):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus one entry each run without an edit to any file there."""
    root, bench = tiny
    before = _digests(bench)
    (bench / "metrics" / "samples_checked.py").write_text(
        "def read(ctx):\n    return float(ctx['fold']['samples'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(dict(
        name="samples_checked", unit="samples", better="higher",
        source="host_clock", layer="profiler entry", moves="samples_per_s",
        workloads=["tiny-combo"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traced = _run(root, bench, "tiny-combo", trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["samples_checked"]["value"] > 0
    assert {"entry_fixed_ms", "host_ms_per_chunk",
            "miss_wall_pct"} <= set(traced["metrics"])
    plain = _run(root, bench, "tiny-region")
    assert plain["correct"] and set(plain["metrics"]) == {"samples_per_s",
                                                          "setup_s"}
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_listed_metric_that_reads_nothing_is_missing(tiny):
    """A per-layer metric that lists the cell and finds nothing to read is
    named by ``harness.missing``, for which ``run.py`` prints no result;
    on the CPU the device trace's metrics are the only others missing."""
    root, bench = tiny
    (bench / "metrics" / "nothing_read.py").write_text(
        "def read(ctx):\n    return None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(dict(
        name="nothing_read", unit="ms", better="lower", source="host_clock",
        layer="profiler entry", moves="samples_per_s",
        workloads=["tiny-region"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(root, "tiny-region", bench)
    out = harness.run(cell, seed=5, seconds=0, trace=True, dev=CPU,
                      t_start=0.0)
    device = {m["name"] for m in SPEC["per_layer"]
              if m["source"] == "device_trace"}
    assert set(harness.missing(cell, out, True)) == device | {"nothing_read"}


def test_the_result_is_one_json_line_with_the_driver_keys(tiny):
    root, bench = tiny
    sys.path.insert(0, str(BENCH))
    import run
    out = run._finite(_run(root, bench, "tiny-region", trace=True))
    line = json.dumps(out)
    assert "\n" not in line
    got = json.loads(line)
    assert list(got)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(got)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(got["device"])
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in got["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in got["checks"].values():
        assert set(c) == {"value", "limit"}


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """Exit 2 and an empty standard output where torch sees no GPU (here
    always); in a directory of only the benchmark's files it cannot run
    either."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            import shutil
            shutil.copytree(BENCH, tmp_path / "bench")
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", "region-bb4096",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


# -- faults planted under the timed path ------------------------------------


def _unchanged_step(monkeypatch, dp):
    """The chunk step of chunk 1 returns its state unchanged."""
    region, combo = dp._region_step, dp._combo_step

    def region_step(carry, prev, dtl, spec, update, root, u0, k, *a):
        if k == 1:
            return carry, prev
        return region(carry, prev, dtl, spec, update, root, u0, k, *a)

    def combo_step(carry, prev, table, dtl, spec, root, u0, k, *a):
        if k == 1:
            return carry, prev, False
        return combo(carry, prev, table, dtl, spec, root, u0, k, *a)
    monkeypatch.setattr(dp, "_region_step", region_step)
    monkeypatch.setattr(dp, "_combo_step", combo_step)


def _half_batch(monkeypatch, dp):
    """Every other lane of each chunk left out."""
    samples = dp._chunk_samples

    def chunk_samples(*a):
        rid, chan, valid, prev = samples(*a)
        keep = torch.arange(valid.numel(), device=valid.device) % 2 == 0
        return rid, chan, valid & keep, prev
    monkeypatch.setattr(dp, "_chunk_samples", chunk_samples)


def _altered_answer(monkeypatch, dp):
    """One sample's power reading altered by 1 W where it is produced."""
    samples = dp._chunk_samples

    def chunk_samples(*a):
        rid, chan, valid, prev = samples(*a)
        chan = chan.clone()
        chan[..., 7] += 1.0
        return rid, chan, valid, prev
    monkeypatch.setattr(dp, "_chunk_samples", chunk_samples)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("cell", ["tiny-region", "tiny-combo", "tiny-arm"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, cell):
    from repro_torch.core import device_pipeline as dp
    root, bench = tiny
    fault(monkeypatch, dp)
    out = _run(root, bench, cell)
    assert out["correct"] is False, out["checks"]


# -- faults planted in the INA231 window sensor -----------------------------


def _window_1ms(monkeypatch, dp):
    """The meter's window set to 1 ms instead of 280 us."""
    sensor = dp._sensor_powers

    def sensor_powers(spec, *a):
        return sensor(dataclasses.replace(spec, window=1e-3), *a)
    monkeypatch.setattr(dp, "_sensor_powers", sensor_powers)


def _window_ahead(monkeypatch, dp):
    """The window put ahead of the sample: the mean over [t, t + w]."""
    sensor = dp._sensor_powers

    def sensor_powers(spec, arrs, t, cnt, valid, prev, k_max):
        ends, grid, cell = arrs[0], arrs[6], arrs[7]
        ahead = t + spec.window
        return sensor(spec, arrs, ahead,
                      dp._count_le(ends, grid, cell, ahead, k_max), valid,
                      prev, k_max)
    monkeypatch.setattr(dp, "_sensor_powers", sensor_powers)


def _instant_power(monkeypatch, dp):
    """The power at the sample's time read in place of the window's
    mean."""
    sensor = dp._sensor_powers

    def sensor_powers(spec, *a):
        return sensor(dataclasses.replace(spec, kind="instant"), *a)
    monkeypatch.setattr(dp, "_sensor_powers", sensor_powers)


def test_a_sound_ina231_run_is_correct(tiny):
    root, bench = tiny
    out = _run(root, bench, "tiny-arm", trace=True)
    assert out["correct"], out["checks"]
    assert {"entry_fixed_ms", "host_ms_per_chunk",
            "miss_wall_pct"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [_window_1ms, _window_ahead,
                                   _instant_power])
def test_a_broken_ina231_window_is_not_correct(tiny, monkeypatch, fault):
    from repro_torch.core import device_pipeline as dp
    root, bench = tiny
    fault(monkeypatch, dp)
    out = _run(root, bench, "tiny-arm")
    assert out["correct"] is False, out["checks"]


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, bench = tiny
    for name in ("tiny-region", "tiny-combo", "tiny-arm"):
        cell = harness.load_cell(root, name, bench)
        out = harness.run(cell, seed=11, seconds=1, trace=True,
                          dev=torch.device("cuda", 0), t_start=0.0)
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0
        assert "kernels_per_chunk" in out["metrics"]
