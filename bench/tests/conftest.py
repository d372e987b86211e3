"""Shared set-up of the benchmark's own tests.

Run from the root of the repository: ``python -m pytest bench/tests``.
The tests need only the CPU, except those marked ``gpu``, which decide in
their body whether a card is there and skip without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = dict(what="a tiny program for tests", blocks=24,
                    invocations=4, steps=6, flops_log10=[10.5, 11.5],
                    hbm_bytes_log10=[8.5, 9.5], latency_noise=0.08,
                    power_noise=0.02, efficiency=0.85)
# The INA231 meter's shortest window (ALEA §4.5) as the sampling period,
# with the 20% jitter of the RAPL configurations.
ARM = dict(sensor="ina231", period_s=2.8e-4, jitter_s=5.6e-5)
TINY = {"tiny-region": ("alea-region", 1, {}),
        "tiny-combo": ("alea-combo-w16", 4, {}),
        "tiny-arm": ("alea-combo-w16", 4, ARM)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself without one")


def make_tiny(tmp: Path):
    """A copy of the benchmark with three tiny cells (``tiny-region``, one
    worker; ``tiny-combo``, four; ``tiny-arm``, four read by the INA231
    sensor) added as new files and entries; returns (root, bench)."""
    root, bench = tmp / "root", tmp / "root" / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    for name, (base, workers, changes) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, workers=workers, chunk_size=4096,
                   samples_per_profile=60000, **changes)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=name, source="tests",
                                    file=f"bench/configs/{name}.json",
                                    reduced=[], why="tests"))
        spec["workloads"].append(dict(name=name, config=name,
                                      traffic="tiny", chips=1, why="tests"))
        like = {w["name"] for w in spec["workloads"]
                if w["config"] == base}
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like & set(m.get("workloads", ())):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)
