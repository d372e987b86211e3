"""The benchmark's frozen inputs and plain reference against the port, on
the CPU at tiny sizes; and what the benchmark's code may import and
read."""

import ast
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import generator
import reference
from conftest import ARM, BENCH, ROOT, TINY, TINY_TRAFFIC

TOL = dict(mean_gap=1e-12, spread_gap=1e-9)    # the port's own oracle rtol


CONFIGS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]]


def _cell(workers, chunk=4096, seed=2**31 + 77, **changes):
    cfg = json.loads((BENCH / "configs" / "alea-combo-w16.json").read_text())
    cfg.update(workers=workers, chunk_size=chunk, samples_per_profile=60000,
               **changes)
    base = generator.cell_timeline(TINY_TRAFFIC, cfg, seed)
    return cfg, generator.workers(base, cfg)


def _reference(arrays, cfg, seed, **kw):
    return reference.profile(arrays, period=cfg["period_s"],
                             jitter=cfg["jitter_s"], seed=seed,
                             chunk=cfg["chunk_size"], sensor=cfg["sensor"],
                             device="cpu", **kw)


def _port_profile(arrays, cfg, seed):
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.core.timeline import Timeline
    tls = [Timeline(a.region_ids, a.durations, a.powers, a.names,
                    rail_powers=a.rail_powers, domains=a.domains)
           for a in arrays]
    prof = EnergyProfiler(period=cfg["period_s"], jitter=cfg["jitter_s"],
                          seed=seed, device="cpu")
    kw = dict(sensor=cfg["sensor"], chunk_size=cfg["chunk_size"],
              pipeline="device")
    if len(tls) == 1:
        est = prof.profile_timeline_streaming(tls[0], **kw)
        keys = est.table.region_ids[:, None]
    else:
        est, combos = prof.profile_multiworker_streaming(tls, **kw)
        keys = np.asarray(combos)
    tb = est.table
    cols = {c: getattr(tb, c) for c in ("n_samples", "p_hat", "t_hat",
                                        "t_lo", "t_hi", "pow_hat", "pow_lo",
                                        "pow_hi", "e_hat", "e_lo", "e_hi",
                                        "pow_rails", "pow_rails_lo",
                                        "pow_rails_hi", "e_rails",
                                        "e_rails_lo", "e_rails_hi")}
    return keys, cols, est.n_total, est.t_exec


@pytest.mark.parametrize("workers,changes", [
    pytest.param(1, {}, id="1"), pytest.param(4, {}, id="4"),
    pytest.param(1, ARM, id="ina231-1"), pytest.param(4, ARM, id="ina231-4")])
def test_reference_equals_the_port_on_the_cpu(workers, changes):
    """RAPL at 1 ms, and the INA231 window sensor sampled at its 280 us
    window."""
    cfg, arrays = _cell(workers, **changes)
    seed = 5_000_000_017
    got = _port_profile(arrays, cfg, seed)
    ref = _reference(arrays, cfg, seed)
    nums = reference.compare(*got, ref, cfg["alpha"])
    assert nums["order_gap"] == 0 and nums["count_gap"] == 0, nums
    assert nums["mean_gap"] <= TOL["mean_gap"], nums
    assert nums["spread_gap"] <= TOL["spread_gap"], nums
    # Every combination of the phase-shifted workers: the pure rows and,
    # per block boundary, one row for each worker count already across.
    blocks = TINY_TRAFFIC["blocks"]
    assert len(ref.keys) == blocks * (1 if workers == 1 else workers)
    assert ref.n == int(np.sum(ref.counts))


@pytest.mark.parametrize("config,changes", [
    *(pytest.param(c, {}, id=c) for c in CONFIGS),
    pytest.param("alea-combo-w16", ARM, id="ina231")])
def test_control_fails_the_limits(config, changes):
    """The control (float32 sensor readings and sums) in the program's
    place fails a number of the configuration's check; ``ina231``: four
    workers read by the INA231 sensor, held to the limits of the
    16-worker configuration."""
    limits = json.loads((BENCH / "configs" / f"{config}.json").read_text()
                        )["limits"]
    cfg, arrays = _cell(1 if config == "alea-region" else 4, **changes)
    low = _reference(arrays, cfg, 41, fold_dtype=torch.float32)
    ref = _reference(arrays, cfg, 41)
    nums = reference.compare(low.keys, reference.estimates(low, 0.05),
                             low.n, low.t_exec, ref, 0.05)
    assert any(nums[k] > lim for k, lim in limits.items()), nums


def test_the_reference_refuses_a_sensor_it_does_not_model():
    cfg, arrays = _cell(1)
    cfg["sensor"] = "instant"
    with pytest.raises(ValueError, match="instant"):
        _reference(arrays, cfg, 3)


# sha256 of keys, counts, Σpow and Σpow² of the RAPL reference profiles of
# the tiny cells, as the reference gave them before it learned the INA231
# sensor (run seeds 1 and 2**31 + 5, the window's first profile, blocks of
# 2**14 lanes so that the counter's last sample crosses blocks).
RAPL_DIGESTS = {
    ("tiny-region", 1):
        "596e775534399ff93bf07e14a8500e5e3a8cdea0b4fe757bb769ad84d3ec6aee",
    ("tiny-region", 2**31 + 5):
        "7633d044cf4a1d3822013768af55ebaeb74672ef2cb67d52f7754ba82d19657b",
    ("tiny-combo", 1):
        "02ab5e5933106cc5d66e24315a271e5347d356e33468f9de1c360f8dd9ce3d97",
    ("tiny-combo", 2**31 + 5):
        "16c8af305cdffd463cc109b964bc84ebd91faeda772697ef9e6a079d55fc9d1c",
}


def _digest(prof) -> str:
    h = hashlib.sha256()
    for a in (prof.keys, prof.counts, prof.psum, prof.psumsq):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _tiny_rapl_profile(cell: str, seed: int):
    base, workers, _ = TINY[cell]
    cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    cfg.update(workers=workers, chunk_size=4096, samples_per_profile=60000)
    arrays = generator.workers(
        generator.cell_timeline(TINY_TRAFFIC, cfg, seed), cfg)
    return _reference(arrays, cfg, generator.derived_seed(seed, 2, 0),
                      block_lanes=1 << 14)


@pytest.mark.parametrize("cell,seed", list(RAPL_DIGESTS))
def test_the_rapl_profiles_of_the_tiny_cells_are_unchanged(cell, seed):
    """The RAPL arithmetic is bit for bit what it was before the INA231
    branch was added beside it."""
    assert _digest(_tiny_rapl_profile(cell, seed)) == RAPL_DIGESTS[
        (cell, seed)]


def test_clock_equals_the_port_bit_for_bit():
    from repro_torch.core import device_pipeline as dp, threefry
    period, jitter, c = 1.9e-5, 0.2 * 1.9e-5, 1024
    for seed in (0, 2**31 + 9, 2**62 + 3):
        ref = reference.sample_times(seed, period, jitter, c, 3, 4, "cpu")
        port = torch.cat([dp.chunk_sample_times(
            threefry.PRNGKey(seed), k, period, jitter, chunk_size=c,
            device="cpu") for k in range(3, 7)])
        assert torch.equal(ref, port)


def test_generator_equals_the_port_synthesize():
    from repro_torch.core.timeline import RegionCost, synthesize
    flops, hbm = generator.region_costs(TINY_TRAFFIC, 123)
    got = generator.synthesize(flops, hbm, invocations=4, steps=3, seed=9,
                               domains=True)
    tl = synthesize([RegionCost(f"bb{i}", float(f), float(b),
                                invocations=4)
                     for i, (f, b) in enumerate(zip(flops, hbm))],
                    steps=3, seed=9, domains=True)
    for f in ("region_ids", "durations", "powers", "rail_powers"):
        assert np.array_equal(getattr(got, f), getattr(tl, f)), f
    assert got.names == tl.names and got.domains == tl.domains


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_benchmark_imports_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro",
                               "benchmarks"), (path, name)
            if path.name == "reference.py":
                assert top not in ("repro_torch",), (path, name)


_DRIVE = """
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [{bench!r}, {src!r}, {tests!r}]
import torch, harness, conftest
from pathlib import Path
root, bench = conftest.make_tiny(Path({tmp!r}))
cell = harness.load_cell(root, "tiny-combo", bench)
out = harness.run(cell, seed=7, seconds=0, trace=True,
                  dev=torch.device("cpu"), t_start=0.0)
print(json.dumps(dict(correct=out["correct"],
                      modules=sorted({{m.split(".")[0] for m in sys.modules}}),
                      opened=opened)))
"""


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks(tmp_path):
    code = _DRIVE.format(bench=str(BENCH), src=str(ROOT / "src"),
                         tests=str(BENCH / "tests"), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(
        got["modules"]), got["modules"]
    bench_dir = str(ROOT / "benchmarks")
    assert not [p for p in got["opened"] if p.startswith(bench_dir)
                or p.startswith("benchmarks/")]
