"""The benchmark of the profiler's device pipeline (``repro_torch``).

One run measures one cell of ``BENCHMARK.json``: set-up, a window of
profiles back to back, optionally the per-layer probes and one traced
profile, then the check of every profile against the plain reference.
Everything a cell is made of is found by name: its configuration file
(``configs``' ``file``), its traffic (``bench/traffic/<traffic>.json``)
and each per-layer metric's reader (``bench/metrics/<name>.py``, a
``read(ctx)`` that returns the number or None when it finds nothing to
read).

The window is a closed loop with one client: a user hands the profiler a
recorded timeline and waits for the estimates, then asks again, each time
with a new sampling seed. The profile in flight when the window's seconds
run out runs to its end and counts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import generator
import reference
import tracing

BENCH = Path(__file__).resolve().parent
PIPELINE = "device"          # the profiler's device-resident pipeline
COLUMNS = ("n_samples", "p_hat", "t_hat", "t_lo", "t_hi", "pow_hat",
           "pow_lo", "pow_hi", "e_hat", "e_lo", "e_hi", "pow_rails",
           "pow_rails_lo", "pow_rails_hi", "e_rails", "e_rails_lo",
           "e_rails_hi")


@dataclasses.dataclass
class Cell:
    """One workload of the spec with its configuration and traffic."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: Path = BENCH


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{wl['traffic']}.json").read_text())
    return Cell(name, wl, config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], bench)


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def missing(cell: Cell, result: dict, trace: bool) -> list[str]:
    """The cell's metrics of this kind of run (end-to-end untraced,
    per-layer traced) that the result line lacks: a reader that found
    nothing to read, or a probe whose span never fired."""
    wanted = cell.per_layer if trace else cell.end_to_end
    return [m["name"] for m in wanted if m["name"] not in result["metrics"]]


def process_age() -> float | None:
    """Seconds since this process started (Linux; None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def power_limit_w() -> float | None:
    """The first card's power limit in watts, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The system under test: the profiler's public entry for this
    configuration, called on host ``Timeline`` objects."""

    def __init__(self, cell: Cell, arrays, dev):
        from repro_torch.core.timeline import Timeline
        self.cfg = cell.config
        self.period = self.cfg["period_s"]
        self.jitter = self.cfg["jitter_s"]
        self.dev = dev
        self.timelines = [Timeline(a.region_ids, a.durations, a.powers,
                                   a.names, rail_powers=a.rail_powers,
                                   domains=a.domains) for a in arrays]

    def profile(self, seed: int):
        """One profile through the public entry: (estimates, combination
        rows or None)."""
        from repro_torch.core.profiler import EnergyProfiler
        kw = dict(sensor=self.cfg["sensor"],
                  chunk_size=self.cfg["chunk_size"], pipeline=PIPELINE)
        prof = EnergyProfiler(period=self.period, jitter=self.jitter,
                              alpha=self.cfg["alpha"], seed=seed,
                              device=self.dev)
        if len(self.timelines) == 1:
            return prof.profile_timeline_streaming(self.timelines[0], **kw), \
                None
        return prof.profile_multiworker_streaming(self.timelines, **kw)

    def probe(self, seed: int) -> dict:
        """One profile through the public entry with a span of the
        benchmark's own around the entry's call into the device pipeline
        (``run_region_pipeline`` / ``run_combo_pipeline``, which is also
        handed a ``stats`` dict for its miss counters): the entry's wall,
        the pipeline's wall inside it, its chunks and counters, and the
        profile itself."""
        from repro_torch.core import device_pipeline as dp
        rec = dict(stats={})
        names = ("run_region_pipeline", "run_combo_pipeline")
        orig = {n: getattr(dp, n) for n in names}

        def span(fn, combo):
            sig = inspect.signature(fn)

            def timed(*args, **kw):
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                a = bound.arguments
                if combo and "stats" in a:
                    a["stats"] = rec["stats"]
                sync(self.dev)
                t0 = time.perf_counter()
                out = fn(*bound.args, **bound.kwargs)   # ends in a read-back
                rec["pipeline_s"] = time.perf_counter() - t0
                got = [a.get(k) for k in ("dtl", "period", "chunk_size")]
                if None not in got:
                    rec["chunks"] = dp.num_chunks(got[0].t_end, *got[1:])
                return out
            return timed

        for n in names:
            setattr(dp, n, span(orig[n], n == "run_combo_pipeline"))
        try:
            t0 = time.perf_counter()
            rec["out"] = self.profile(seed)
            rec["entry_s"] = time.perf_counter() - t0
        finally:
            for n in names:
                setattr(dp, n, orig[n])
        return rec


def _answer(seed: int, out) -> dict:
    """What the reference judges of one profile, on the host."""
    est, combos = out
    tb = est.table
    keys = (np.asarray(tb.region_ids, np.int64)[:, None] if combos is None
            else np.asarray(combos, np.int64))
    cols = {c: np.array(getattr(tb, c)) for c in COLUMNS
            if getattr(tb, c) is not None}
    return dict(seed=seed, keys=keys, cols=cols, n=int(est.n_total),
                t_exec=float(est.t_exec))


def check(cell: Cell, arrays, answers, dev):
    """Every answer against the reference: the worst of each number, and
    the reference's fold work of the last answer."""
    cfg = cell.config
    worst = {k: 0 for k in cfg["limits"]}
    last = None
    for a in answers:
        ref = reference.profile(arrays, period=cfg["period_s"],
                                jitter=cfg["jitter_s"], seed=a["seed"],
                                chunk=cfg["chunk_size"], sensor=cfg["sensor"],
                                device=dev)
        got = reference.compare(a["keys"], a["cols"], a["n"], a["t_exec"],
                                ref, cfg["alpha"])
        for k in worst:
            worst[k] = max(worst[k], got[k])
        last = ref
    return worst, last


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object.
    ``t_start`` is the process's start on the ``perf_counter`` clock."""
    cfg, traffic = cell.config, cell.traffic
    from repro_torch.core import device_pipeline

    # -- set-up: the inputs from the seed, one warm-up profile ---------------
    arrays = generator.workers(generator.cell_timeline(traffic, cfg, seed),
                               cfg)
    prog = Program(cell, arrays, dev)
    step = int(traffic["blocks"]) * int(traffic["invocations"])
    step += 0 if len(arrays) == 1 else 1
    warm = Program(cell, [generator.prefix(a, step) for a in arrays], dev)
    warm.profile(generator.derived_seed(seed, 3))
    del warm
    # The full-size upload once, so that the allocator holds its blocks
    # before the window as it does after the window's first profile.
    device_pipeline.DeviceTimeline.from_timelines(prog.timelines, device=dev)
    gc.collect()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window ------------------------------------------------------------
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    outs, walls, failed, samples, t_last = [], [], 0, 0, t0
    while True:
        s = generator.derived_seed(seed, 2, len(outs) + failed)
        try:
            out = prog.profile(s)
        except Exception as exc:              # a profile that never comes
            print(f"profile with seed {s} failed: {exc!r}", file=sys.stderr)
            failed += 1
        else:
            outs.append((s, out))
            samples += int(out[0].n_total)
        walls.append(time.perf_counter() - t_last)
        t_last = time.perf_counter()
        if t_last - t0 >= seconds:
            break
    window_s = t_last - t0
    print(f"window: {len(walls)} profiles, seconds each "
          f"{[round(w, 4) for w in walls]}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    attempted = len(outs) + failed
    answers = [_answer(s, o) for s, o in outs]
    del outs

    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
                  count=1, memory_peak_bytes=peak)
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    metrics, breakdown = {}, None
    if not trace:
        values = dict(samples_per_s=samples / window_s if samples else None,
                      peak_device_mib=None if peak is None else peak / 2**20,
                      setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        # Timer-based probes first: a traced process pays more per launch.
        s = generator.derived_seed(seed, 4)
        probe = prog.probe(s)
        answers.append(_answer(s, probe.pop("out")))
        s = generator.derived_seed(seed, 5)
        traced_out, summary = tracing.traced(lambda: prog.profile(s))
        answers.append(_answer(s, traced_out))
        del traced_out
        summary["chunks"] = probe.get("chunks")
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = dict(device_ops=summary["device_ops"],
                         idle_gaps=summary["idle_gaps"])
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check: every profile against the reference ------------------------
    worst, last = check(cell, arrays, answers, dev)
    correct = failed == 0 and bool(answers) and all(
        worst[k] <= lim for k, lim in cfg["limits"].items())
    if trace:
        ctx = dict(cell=cell.name, config=cfg, traffic=traffic, probe=probe,
                   trace=summary, device=device,
                   fold=dict(samples=last.n, lanes=last.lanes,
                             touched=last.touched, channels=last.channels,
                             chunks=last.chunks))
        for m in cell.per_layer:
            v = reader(m["name"], cell.bench)(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    checks = {k: dict(value=worst[k], limit=lim)
              for k, lim in cfg["limits"].items()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
