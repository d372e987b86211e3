"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout
(``build/kernels/``), then runs four checked phases and fails (non-zero
exit) if any check fails, and one measuring phase:

1. kernel   — every kernel against its plain PyTorch version at the
              pipeline's shapes: equal counts, sums to the stated rtol,
              two kernel runs bitwise equal; kernel, plain, library-call
              times (CUDA events) and the card's bound for the same work;
2. clock    — the sample clock on the GPU equals the CPU's bit for bit;
3. parity   — ``EnergyProfiler.profile_timeline_streaming(pipeline=
              "device")`` on the GPU against the port's numpy oracle for
              every trace sensor at D=1 and D=3, ~10^6 samples each;
4. full     — the main path at full size: one profiling run of a
              4096-region, 2^20-interval, 3-rail timeline at >= 10^8
              samples (chunk 65536), with the kernel's launch counter set
              to 0 just before and read just after;
5. breakdown — wall time per call of each layer of one chunk and, from a
              torch.profiler trace, kernels per chunk and the device's
              busy share (measured, not checked).

The line before the last is a JSON object listing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``. Without a GPU,
or without the rest of the repository beside it, it exits non-zero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP64_PER_S = 34e12         # float64 outside the tensor cores, same sheet
KERNEL_RTOL = 1e-10             # both f64; only the summation order differs
PIPELINE_RTOL = 1e-9            # the reference's own device-vs-oracle limit


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, *, warmup=3, iters=20):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events,
    after ``warmup`` launches)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 1: sample_attr against its plain version.
# ---------------------------------------------------------------------------


def sample_attr_inputs(c, R, C, seed, dev):
    """Ids with out-of-range lanes on both sides, f64 powers, ~10% masked."""
    import torch
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(-2, R + 2, (c,), generator=g, dtype=torch.int32)
    pows = 50.0 + 150.0 * torch.rand((c,) if C == 1 else (C, c),
                                     generator=g, dtype=torch.float64)
    valid = torch.rand(c, generator=g) < 0.9
    return ids.to(dev), pows.to(dev), valid.to(dev)


def fresh_carry(R, C, dev):
    import torch
    stat = (R,) if C == 1 else (R, C)
    return (torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros(stat, dtype=torch.float64, device=dev),
            torch.zeros(stat, dtype=torch.float64, device=dev))


def sample_attr_bound_ms(c, R, C):
    """Least time for one fold: each input read once (4 B id, 8·C B power,
    1 B mask per sample; the carry), each output written once (the
    carry), against HBM bandwidth; and 1 + 3·C float64 operations per
    sample against the FP64 peak. Returns (ms, "bytes"|"operations")."""
    carry = R * (1 + 2 * C) * 8
    nbytes = c * (4 + 8 * C + 1) + 2 * carry
    ops = c * (1 + 3 * C)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP64_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    import torch
    from repro_torch.kernels.sample_attr import ops
    from repro_torch.kernels.sample_attr.ref import sample_attr_fold_ref
    rows = {}
    c = 65536
    for R in (16, 4096):
        for C in (1, 4):
            ids, pows, valid = sample_attr_inputs(c, R, C, R * 10 + C, dev)
            got = fresh_carry(R, C, dev)
            ops.sample_attr_fold(*got, ids, pows, valid)
            again = fresh_carry(R, C, dev)
            ops.sample_attr_fold(*again, ids, pows, valid)
            want = fresh_carry(R, C, dev)
            sample_attr_fold_ref(*want, ids, pows, valid)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]),
                  f"sample_attr counts R={R} C={C}")
            err = 0.0
            for g, w in zip(got[1:], want[1:]):
                check(torch.allclose(g, w, rtol=KERNEL_RTOL, atol=0.0),
                      f"sample_attr sums R={R} C={C} rtol={KERNEL_RTOL}")
                err = max(err, (g - w).abs().max().item())
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"sample_attr bitwise repeat R={R} C={C}")

            carry = fresh_carry(R, C, dev)
            k_ms = time_ms(lambda: ops.sample_attr_fold(*carry, ids, pows,
                                                        valid))
            p_ms = time_ms(lambda: sample_attr_fold_ref(*carry, ids, pows,
                                                        valid))
            # Library yardstick: one bincount over (region, statistic)
            # keys computes all 1 + 2C statistics (inputs prepared
            # outside the timed call; never used by the port).
            ok = valid & (ids >= 0) & (ids < R)
            pw = pows.reshape(C, c)[:, ok]
            stats = torch.cat([torch.ones_like(pw[:1]), pw, pw * pw])
            keys = (ids[ok].to(torch.int64)[None, :] * (1 + 2 * C)
                    + torch.arange(1 + 2 * C, device=dev)[:, None])
            keys, stats = keys.reshape(-1), stats.reshape(-1)
            lib_ms = time_ms(lambda: torch.bincount(
                keys, weights=stats, minlength=R * (1 + 2 * C)))
            b_ms, b_by = sample_attr_bound_ms(c, R, C)
            rows[(R, C)] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by)
            log(f"kernel sample_attr c={c} R={R} C={C}: counts equal, sums "
                f"max_abs_err={err:.3e} (rtol {KERNEL_RTOL}), bitwise "
                f"repeat ok; ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms(bincount)={lib_ms:.4f} bound_ms={b_ms:.6f} "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2/3: clock and pipeline parity against the numpy oracle.
# ---------------------------------------------------------------------------


def clock_phase():
    import torch
    from repro_torch.core import device_pipeline as dp, threefry
    for seed, k, c in ((0, 0, 65536), (7, 1525, 65536), (3, 123456, 65536),
                       (5, 2 ** 24, 4096)):
        a = dp.chunk_sample_times(threefry.PRNGKey(seed), k, 1e-5, 2e-6,
                                  chunk_size=c, device="cpu")
        b = dp.chunk_sample_times(threefry.PRNGKey(seed), k, 1e-5, 2e-6,
                                  chunk_size=c, device="cuda").cpu()
        check(torch.equal(a.view(torch.int64), b.view(torch.int64)),
              f"clock seed={seed} k={k}: GPU times equal CPU times")
    log("clock: GPU sample times equal the CPU's bit for bit "
        "(4 (seed, k) cases)")


def parity_timeline(domains):
    """64 regions x 16 invocations x 64 steps = 65536 intervals, t_exec
    ~ 10^3 s, so 1 ms sampling (RAPL's floor) gives ~10^6 samples."""
    import numpy as np
    from repro_torch.core.timeline import RegionCost, synthesize
    rng = np.random.default_rng(1)
    costs = [RegionCost(f"r{i}", flops=float(f), hbm_bytes=float(b),
                        invocations=16)
             for i, (f, b) in enumerate(zip(10 ** rng.uniform(11.5, 12.5, 64),
                                            10 ** rng.uniform(9, 10.5, 64)))]
    return synthesize(costs, steps=64, seed=2, domains=domains)


def parity_phase():
    import numpy as np
    from repro_torch.core import device_pipeline as dp, sensors
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.core.streaming import StreamingAggregator
    specs = {"instant": sensors.InstantTraceSensor,
             "rapl": sensors.RaplTraceSensor,
             "ina231": sensors.Ina231TraceSensor}
    for domains in (False, True):
        tl = parity_timeline(domains)
        for name, cls in specs.items():
            spec = cls.make_spec(domains=tl.domain_names)
            period = max(spec.effective_min_period(), tl.t_exec / 1.05e6)
            kw = dict(period=period, jitter=0.2 * period, seed=5,
                      chunk_size=65536)
            t0 = time.perf_counter()
            got = dp.run_region_pipeline(tl.to_device(device="cuda"), spec,
                                         **kw)
            t_gpu = time.perf_counter() - t0
            want = dp.reference_region_pipeline(tl, spec, **kw)
            check(got.n == want.n, f"parity {name} D={tl.num_domains}: n")
            check(np.array_equal(got.counts, want.counts),
                  f"parity {name} D={tl.num_domains}: counts")
            for f in ("psum", "psumsq", "rail_psum", "rail_psumsq"):
                check(np.allclose(getattr(got, f), getattr(want, f),
                                  rtol=PIPELINE_RTOL, atol=0.0),
                      f"parity {name} D={tl.num_domains}: {f}")
            prof = EnergyProfiler(period=period, jitter=0.2 * period,
                                  seed=5, device="cuda")
            est = prof.profile_timeline_streaming(
                tl, sensor=name, chunk_size=65536, pipeline="device")
            d1 = tl.num_domains == 1
            oracle = StreamingAggregator.from_statistics(
                want.counts,
                want.psum if d1 else np.concatenate(
                    [want.rail_psum, want.psum[:, None]], axis=1),
                want.psumsq if d1 else np.concatenate(
                    [want.rail_psumsq, want.psumsq[:, None]], axis=1),
                domains=tl.domain_names).estimates(want.t_exec, tl.names)
            check(np.array_equal(est.table.n_samples,
                                 oracle.table.n_samples),
                  f"parity {name} D={tl.num_domains}: estimate counts")
            for f in ("pow_hat", "pow_lo", "pow_hi", "e_hat"):
                check(np.allclose(getattr(est.table, f),
                                  getattr(oracle.table, f),
                                  rtol=PIPELINE_RTOL),
                      f"parity {name} D={tl.num_domains}: estimate {f}")
            if name == "rapl":
                again = dp.run_region_pipeline(
                    tl.to_device(device="cuda"), spec, **kw)
                check(all(np.array_equal(getattr(got, f), getattr(again, f))
                          for f in ("counts", "psum", "psumsq", "rail_psum",
                                    "rail_psumsq")),
                      f"parity rapl D={tl.num_domains}: bitwise repeat")
            log(f"parity {name} D={tl.num_domains}: n={got.n} samples, "
                f"counts equal, sums rtol {PIPELINE_RTOL}, estimates "
                f"equal; GPU run {t_gpu:.3f} s"
                + (", two GPU runs bitwise equal" if name == "rapl" else ""))


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size.
# ---------------------------------------------------------------------------


def full_timeline():
    """4096 regions x 16 invocations x 16 steps = 2^20 intervals, 3 rails;
    per-invocation costs drawn log-uniform over one decade of FLOPs and
    HBM bytes (durations of ~0.1-1 ms)."""
    import numpy as np
    from repro_torch.core.timeline import RegionCost, synthesize
    rng = np.random.default_rng(0)
    R = 4096
    costs = [RegionCost(f"bb{i}", flops=float(f), hbm_bytes=float(b),
                        invocations=16)
             for i, (f, b) in enumerate(zip(10 ** rng.uniform(10.5, 11.5, R),
                                            10 ** rng.uniform(8.5, 9.5, R)))]
    return synthesize(costs, steps=16, seed=0, domains=True)


def full_phase(tl):
    import torch
    from repro_torch.core import device_pipeline as dp
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.kernels.sample_attr import ops
    target = 102_000_000
    period = tl.t_exec / target
    jitter = 0.2 * period
    chunk = 65536
    n_chunks = dp.num_chunks(tl.t_exec, period, chunk)
    prof = EnergyProfiler(period=period, jitter=jitter, seed=0,
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.sample_attr_fold.launches = 0
    t0 = time.perf_counter()
    est = prof.profile_timeline_streaming(tl, sensor="instant",
                                          chunk_size=chunk,
                                          pipeline="device")
    secs = time.perf_counter() - t0
    launches = ops.sample_attr_fold.launches
    peak = torch.cuda.max_memory_allocated()
    n = int(est.n_total)
    # Every sample i lies in [i·T, i·T + T + jitter): all i with
    # i·T + T + jitter < t_end are valid, none with i·T >= t_end.
    lo = int((tl.t_exec - period - jitter) // period)
    hi = int(tl.t_exec // period) + 1
    check(int(est.table.n_samples.sum()) == n, "full: sum of counts == n")
    check(lo <= n <= hi, f"full: n={n} within [{lo}, {hi}]")
    check(n >= 100_000_000, "full: >= 10^8 samples")
    check(launches == n_chunks,
          f"full: sample_attr launches {launches} == chunks {n_chunks}")
    check(bool((est.table.pow_hat > 0).all()) and all(
        bool(torch.isfinite(torch.as_tensor(getattr(est.table, f))).all())
        for f in ("pow_hat", "e_hat", "e_rails")),
        "full: finite positive estimates")
    log(f"full: {n} samples in {n_chunks} chunks, {secs:.3f} s "
        f"({n / secs:.4e} samples/s), peak device memory "
        f"{peak / 2 ** 20:.1f} MiB, sample_attr launches {launches}, "
        f"regions attributed {len(est.table)}")
    return dict(n=n, chunks=n_chunks, seconds=secs, launches=launches,
                peak_bytes=peak)


def breakdown_phase(tl):
    """Where one chunk's time goes at the full cell's shapes: host wall
    time per call of each layer (clock, lookup, sensor, fold; the loop is
    launch-bound, so wall time is what a layer costs the run), and, from
    a torch.profiler trace of whole chunks, kernels per chunk and the
    device's busy share. Measures only; checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import device_pipeline as dp, sensors, threefry
    from repro_torch.kernels.sample_attr import ops
    dev = torch.device("cuda")
    dtl = tl.to_device(device=dev)
    spec = sensors.InstantTraceSensor.make_spec(domains=tl.domain_names)
    c, period = 65536, tl.t_exec / 102_000_000
    jitter = 0.2 * period
    root = threefry.PRNGKey(0)
    u0 = dp._phase(root, period)
    arrs = tuple(a[0] for a in dtl.arrays())
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs
    k = 700
    t_raw = dp._raw_chunk_times(root, u0, k, c, period, jitter, dev)
    valid = t_raw < dtl.t_end
    t = torch.clamp_max(t_raw, dtl.t_end)
    cnt = dp._count_le(ends, grid, cell, t, dtl.grid_k)
    prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
    rid, chan, _, _ = dp._chunk_samples(dtl, spec, root, u0, k, c, period,
                                        jitter, prev)
    carry = fresh_carry(dtl.num_regions, chan.shape[0], dev)

    def wall_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def chunk():
        r, ch, v, _ = dp._chunk_samples(dtl, spec, root, u0, k, c, period,
                                        jitter, prev)
        ops.sample_attr_fold(*carry, r, ch, v)

    layers = {
        "clock": lambda: dp._raw_chunk_times(root, u0, k, c, period,
                                             jitter, dev),
        "lookup": lambda: dp._count_le(ends, grid, cell, t, dtl.grid_k),
        "sensor": lambda: dp._sensor_powers(spec, arrs, t, cnt, valid, prev,
                                            dtl.grid_k),
        "fold": lambda: ops.sample_attr_fold(*carry, rid, chan, valid),
        "chunk": chunk,
    }
    walls = {name: wall_ms(fn) for name, fn in layers.items()}
    log("breakdown (wall ms per call, full cell shapes): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in walls.items()))
    chunks = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    launched = sum(e.count for e in kern)
    if busy_us <= 0:
        log("breakdown: device time not measured (the profiler saw no "
            "device events)")
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"breakdown (profiled, {chunks} chunks): {launched / chunks:.0f} "
        f"kernels per chunk, device busy {busy_us / 1e3 / chunks:.3f} ms "
        f"of {wall * 1e3 / chunks:.3f} ms wall per chunk (busy share "
        f"{busy_us / 1e6 / wall:.3f}); top kernels by device time: "
        + "; ".join(f"{e.key[:48]} x{e.count // chunks} "
                    f"{e.self_device_time_total / 1e3 / chunks:.4f} ms"
                    for e in top))


# ---------------------------------------------------------------------------


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no GPU; nothing was run")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_smoke: src/repro_torch not found beside this script")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["sample_attr"])
    log(f"build: sample_attr in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(_build.NVCC_FLAGS)})")

    dev = torch.device("cuda")
    kernel_rows = kernel_phase(dev)
    clock_phase()
    parity_phase()
    t0 = time.perf_counter()
    tl = full_timeline()
    log(f"full: timeline of {len(tl.names)} regions, {len(tl.region_ids)} "
        f"intervals, {tl.num_domains} rails, t_exec={tl.t_exec:.3f} s "
        f"(synthesized in {time.perf_counter() - t0:.1f} s)")
    full = full_phase(tl)
    breakdown_phase(tl)

    main_shape = kernel_rows[(4096, 4)]   # the full run's fold: R=4096, C=4
    kernels = [dict(
        name="sample_attr", route="cuda",
        source="src/repro_torch/kernels/sample_attr/sample_attr.cu",
        replaces="src/repro/kernels/sample_attr/sample_attr.py:80",
        launches=full["launches"], **main_shape,
        check=f"counts equal, sums rtol {KERNEL_RTOL}, bitwise repeatable")]
    log(f"kernel share of the full run: "
        f"{full['launches'] * main_shape['ms'] / 1e3 / full['seconds']:.4f}"
        f" (launches x kernel ms / run seconds)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
