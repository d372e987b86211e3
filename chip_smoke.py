"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels and the stream-order marker library
from the sources in this checkout (``build/kernels/``, one ``nvcc`` per
source, all started together), then
runs these phases, and fails (non-zero exit) if any check fails:

1. clock    — the sample clock on the GPU equals the CPU's bit for bit;
2. parity   — ``EnergyProfiler.profile_timeline_streaming(pipeline=
              "device")`` on the GPU against the port's numpy oracle for
              every trace sensor at D=1 and D=3, ~10^6 samples each;
   combo-parity — the combination pipeline (``run_combo_pipeline`` and
              ``profile_multiworker_streaming(pipeline="device")``) on the
              GPU against ``reference_combo_pipeline`` for W in {1, 4}
              workers, D in {1, 3}, every trace sensor, ~10^6 samples
              each (combination order, n and counts equal, sums to
              rtol; t_lo/t_hi equal, the power and energy bounds within
              the gap power_ci's variance cancellation allows), two runs
              bitwise equal, one bounded run;
3. full     — the profiler's main path at full size: one profiling run of
              a 4096-region, 2^20-interval, 3-rail timeline at >= 10^8
              samples (chunk 65536), with the launch counters set to 0
              just before and read just after; it runs before any
              torch.profiler session, since a process that has traced
              the device pays more host time per launch afterwards;
   combo-full — the combination path at full size: 16 phase-shifted
              workers of that timeline (4-word keys), >= 5·10^7 samples,
              10^4-10^5 combinations, counters set to 0 just before and
              read just after (one fold per chunk plus one per miss
              chunk); wall per layer of one steady-state chunk;
   exchange — the cross-host shard exchange in an NCCL world of one:
              ``CollectiveExchange`` and ``CheckpointExchange`` reduce
              combo-full's and the full run's aggregators to themselves
              bit for bit, and ``profile_multiworker_streaming(exchange=
              ...)`` equals ``exchange=None`` at W=4; seconds of each
              reduce, spill and gather;
   host-seam — the host chunk seam with ``chunked_aggregate_fn`` on the
              GPU against the numpy seam; host-session — a short
              ``host_session`` around GPU work, marked by ``region`` and
              by ``mark_in_jit``, and ``mark_in_jit`` in stream order (a
              long kernel queued at once takes the samples taken while
              it runs; under a watchdog);
4. kernel   — every kernel against its plain PyTorch version at the
              shapes its path gives it, at the stated tolerances:
              ``sample_attr`` on uniform ids (equal counts, sums to rtol,
              bitwise repeatable, bitwise equal to the emulation of its
              summation order), ``flash_attention`` (the model's prefill
              shape, dh 64 and 80, a ragged length, non-causal, float32,
              a transposed q as the model passes it, S=77, float16,
              bf16 at dh 32; each with its route and TFLOP/s) and
              ``rmsnorm`` (block-norm and qk-norm shapes, odd widths,
              bfloat16 and float32, each with its launch plan); kernel,
              plain and library-call times and the card's bound for the
              same work. ``sample_attr`` and ``rmsnorm`` print device ms
              (torch.profiler, their own kernels) beside call ms (CUDA
              events around the wrapper); flash prints call ms;
5. breakdown — ``sample_attr`` on the full cell's own chunk (k = 700:
              the ids, channels and mask the main path folds), held
              and timed as in phase 4: this is the kernel line's
              ``sample_attr`` row; then wall time per call of each layer
              of one chunk and, from a torch.profiler trace, kernels per
              chunk and the device's busy share (measured, not checked);
   combo-fold — ``sample_attr`` on combo-full's steady chunk at R = the
              table capacity, held and timed as in phase 4 (the kernel
              line's second ``sample_attr`` path), and kernels per chunk
              of the combination step;
6. model    — the dense-transformer serving path at full size:
              ``qwen3-1.7b`` (28 layers, d_model 2048, random weights from
              a seed) prefills 4 prompts of 2048 tokens through the flash
              kernel (``attn_impl="flash"``, launch counters set to 0
              just before and read just after: 28 launches), then takes
              32 greedy ``decode_step``s; checked against the same
              prefill through ``attn_impl="full"`` and, for the first
              decode step, against a prefill of the prompt plus that
              token; prints prefill ms and tokens/s, decode ms per step,
              peak device memory, and device time by region (``embed``,
              ``attn``, ``ffn``, ``lm_head``) from a torch.profiler trace
              of one prefill.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a GPU, or without the
rest of the repository beside it, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP64_PER_S = 34e12         # float64 outside the tensor cores, same sheet
H100_BF16_PER_S = 989e12       # dense bf16 tensor cores, same sheet
KERNEL_RTOL = 1e-10             # both f64; only the summation order differs
PIPELINE_RTOL = 1e-9            # the reference's own device-vs-oracle limit
# The reference's own kernel limits (tests/test_kernels.py).
FLASH_F32_TOL = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16_MAX_ABS = 2e-2
RMSNORM_F32_TOL = dict(atol=1e-5, rtol=1e-5)
RMSNORM_BF16_MAX_ABS = 2e-2
# Model phase: bf16 logits of two attention paths through 28 layers, as a
# share of max |logit| (see model_phase).
MODEL_REL_TOL = 0.05


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def watchdog(seconds, what):
    """Fail the script (exit 1) if the block has not finished within
    ``seconds``: a deadlock or a hung collective ends the run instead of
    holding the card until the call's limit."""
    import threading

    def fire():
        print(f"check failed: {what} did not finish within {seconds} s",
              file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


@contextlib.contextmanager
def captured_aggregators():
    """The region aggregators ``StreamingAggregator.from_statistics``
    builds inside the block (the profiler's own, kept for the exchange
    phase); one extra list append a call."""
    from repro_torch.core.streaming import StreamingAggregator
    made = []
    orig = StreamingAggregator.__dict__["from_statistics"]

    def keep(cls, *args, **kw):
        agg = orig.__func__(cls, *args, **kw)
        made.append(agg)
        return agg

    StreamingAggregator.from_statistics = classmethod(keep)
    try:
        yield made
    finally:
        StreamingAggregator.from_statistics = orig


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


def device_ms(fn, *, match=None, warmup=3, iters=20):
    """Device time of one ``fn()`` from a torch.profiler trace of ``iters``
    calls (after ``warmup``): the summed ``self_device_time_total`` of the
    CUDA kernels whose name holds one of ``match`` (every kernel if None),
    over ``iters``. Returns (ms, {kernel name: ms per call}), or (None, {})
    when three traces in a row hold no such device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(3):            # a trace now and then comes back empty
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = {e.key: e.self_device_time_total / 1e3 / iters
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (match is None or any(m in e.key for m in match))}
        total = sum(kern.values())
        if total > 0:
            return total, kern
    return None, {}


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def launch_counters():
    """Every kernel wrapper of the port; each counts its own launches."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.sample_attr.ops import sample_attr_fold
    return (sample_attr_fold, flash_attention, rmsnorm)


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


def sample_attr_bound_ms(c, touched, C):
    """Least time for one fold: each input read once (4 B id, 8·C B power,
    1 B mask per sample), the carry of the ``touched`` regions (those this
    chunk's valid lanes name) read and written once, against HBM
    bandwidth; and 1 + 3·C float64 operations per sample against the FP64
    peak. Returns (ms, "bytes"|"operations")."""
    carry = touched * (1 + 2 * C) * 8
    nbytes = c * (4 + 8 * C + 1) + 2 * carry
    ops = c * (1 + 3 * C)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP64_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


SAMPLE_ATTR_DESIGN = ("per 256-sample tile: runs compressed by a segmented "
                      "reduction, ranked stably by id and merged into a "
                      "table where out of order; per 32 regions: each "
                      "region's records in tile order, summed by lane "
                      "groups reading one record each, then a butterfly")
SAMPLE_ATTR_KERNELS = ("sa_tile_table", "sa_region_merge")


def fold_row(name, R, C, ids, pows, valid):
    """``sample_attr_fold`` on one chunk against its plain version
    (``sample_attr_fold_ref``: counts equal, sums to ``KERNEL_RTOL``), to
    itself (two runs bitwise equal) and to the emulation of its summation
    order (``sample_attr_fold_emulated``: bitwise equal); then its device
    ms (profiler, its own kernels) and call ms (CUDA events around the
    wrapper), the plain version's, ``bincount``'s and the bound."""
    import torch
    from repro_torch.kernels.sample_attr import ops
    from repro_torch.kernels.sample_attr.ref import (
        sample_attr_fold_emulated, sample_attr_fold_ref)
    dev = ids.device
    c = ids.shape[0]
    name = f"{name} c={c} R={R} C={C}"
    got = fresh_carry(R, C, dev)
    ops.sample_attr_fold(*got, ids, pows, valid)
    again = fresh_carry(R, C, dev)
    ops.sample_attr_fold(*again, ids, pows, valid)
    want = fresh_carry(R, C, dev)
    sample_attr_fold_ref(*want, ids, pows, valid)
    emu = fresh_carry(R, C, dev)
    sample_attr_fold_emulated(*emu, ids, pows, valid)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got[1:], want[1:]))
    emu_err = max((g - e).abs().max().item() for g, e in zip(got[1:], emu[1:]))
    log(f"kernel sample_attr {name}: max_abs_err {err:.3e} against ref.py, "
        f"{emu_err:.3e} against the emulation of its order")
    check(torch.equal(got[0], want[0]), f"sample_attr {name}: counts")
    for g, w in zip(got[1:], want[1:]):
        check(torch.allclose(g, w, rtol=KERNEL_RTOL, atol=0.0),
              f"sample_attr {name}: sums rtol={KERNEL_RTOL}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"sample_attr {name}: bitwise repeat")
    check(all(torch.equal(a, b) for a, b in zip(got, emu)),
          f"sample_attr {name}: bitwise equal to sample_attr_fold_emulated")

    carry = fresh_carry(R, C, dev)

    def fold():
        ops.sample_attr_fold(*carry, ids, pows, valid)

    def plain():
        sample_attr_fold_ref(*carry, ids, pows, valid)

    # Library yardstick: one bincount over (region, statistic) keys
    # computes all 1 + 2C statistics (inputs prepared outside the timed
    # call; never used by the port).
    ok = (ids >= 0) & (ids < R)
    if valid is not None:
        ok = ok & valid
    pw = pows.reshape(C, c)[:, ok]
    stats = torch.cat([torch.ones_like(pw[:1]), pw, pw * pw])
    keys = (ids[ok].to(torch.int64)[None, :] * (1 + 2 * C)
            + torch.arange(1 + 2 * C, device=dev)[:, None])
    keys, stats = keys.reshape(-1), stats.reshape(-1)

    def library():
        torch.bincount(keys, weights=stats, minlength=R * (1 + 2 * C))

    k_call, p_call, l_call = (time_ms(f) for f in (fold, plain, library))
    k_dev, k_split = device_ms(fold, match=SAMPLE_ATTR_KERNELS)
    p_dev, _ = device_ms(plain)
    l_dev, _ = device_ms(library)
    touched = int(torch.unique(ids[ok]).numel())
    b_ms, b_by = sample_attr_bound_ms(c, touched, C)
    split = ", ".join(f"{k.split('<')[0].split()[-1]} {v:.4f}"
                      for k, v in sorted(k_split.items()))
    log(f"kernel sample_attr {name} ({touched} regions "
        f"touched): counts equal, sums rtol {KERNEL_RTOL}, bitwise repeat, "
        f"bitwise equal to the emulation; device_ms={_fmt(k_dev)} ({split}) "
        f"call_ms={k_call:.4f}; plain device_ms={_fmt(p_dev)} call_ms="
        f"{p_call:.4f}; library(bincount) device_ms={_fmt(l_dev)} call_ms="
        f"{l_call:.4f}; bound_ms={b_ms:.6f} ({b_by})")
    return dict(max_abs_err=err,
                ms=k_call if k_dev is None else k_dev,
                timing="call ms (events): the profiler saw no device time"
                if k_dev is None else "device ms (torch.profiler)",
                call_ms=k_call,
                plain_ms=p_call if p_dev is None else p_dev,
                library_ms=l_call if l_dev is None else l_dev,
                plain_call_ms=p_call, library_call_ms=l_call,
                bound_ms=b_ms, bound_by=b_by, design=SAMPLE_ATTR_DESIGN,
                split_ms=k_split)


def kernel_phase(dev):
    """``sample_attr`` on uniform ids (the worst case for pass 1's rank
    sort) at c = 65536, R in {16, 4096}, C in {1, 4}."""
    c = 65536
    for R in (16, 4096):
        for C in (1, 4):
            ids, pows, valid = sample_attr_inputs(c, R, C, R * 10 + C, dev)
            fold_row("uniform", R, C, ids, pows, valid)


# name, B, H, KV, S, dh, causal, dtype, q layout: the model's prefill
# shape first. "strided" makes q as [B, S, H, dh] and passes it transposed
# to [B, H, S, dh], as the model does; the others are contiguous.
FLASH_CASES = [
    ("model", 4, 16, 8, 2048, 128, True, "bfloat16", "bhsd"),
    ("dh64", 4, 16, 8, 2048, 64, True, "bfloat16", "bhsd"),
    ("dh80", 4, 16, 8, 2048, 80, True, "bfloat16", "bhsd"),
    ("ragged", 4, 16, 8, 2000, 128, True, "bfloat16", "bhsd"),
    ("noncausal", 4, 16, 8, 2048, 128, False, "bfloat16", "bhsd"),
    ("f32", 1, 16, 8, 2048, 128, True, "float32", "bhsd"),
    ("strided", 4, 16, 8, 2048, 128, True, "bfloat16", "bshd"),
    ("short", 4, 16, 8, 77, 128, True, "bfloat16", "bhsd"),
    ("fp16", 4, 16, 8, 2048, 128, True, "float16", "bhsd"),
    ("dh32", 4, 16, 8, 2048, 32, True, "bfloat16", "bhsd"),
]
# [n, d]: block norms [B·S, d_model] and qk-norm [B·H·S, dh] of the
# model's prefill, then odd widths.
RMSNORM_SHAPES = [(8192, 2048), (131072, 128), (513, 768), (1, 33)]


def flash_ops(B, H, S, T, dh, causal):
    """4·dh operations per (query, key) pair the mask keeps (q·k and p·v,
    2 each; causal keeps key col <= row)."""
    if causal:
        pairs = sum(min(r + 1, T) for r in range(S))
    else:
        pairs = S * T
    return 4 * dh * B * H * pairs


def flash_bound_ms(B, H, KV, S, T, dh, causal, esize):
    """Least time for one attention: q and o (B·H·S·dh), k and v
    (B·KV·T·dh) each moved once, against HBM bandwidth; and
    :func:`flash_ops` against the bf16 tensor-core peak.
    Returns (ms, "bytes"|"operations")."""
    nbytes = (2 * B * H * S + 2 * B * KV * T) * dh * esize
    ops = flash_ops(B, H, S, T, dh, causal)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_BF16_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_phase(dev):
    """flash_attention against its plain version (ref.py) at the model's
    prefill shape (qwen3-1.7b: B=4, H=16, KV=8, S=2048, dh=128, bf16,
    causal) and around it. Prints each case's route (``ops._route``) and
    achieved TFLOP/s (:func:`flash_ops` / kernel time). Returns the model
    shape's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=dev).manual_seed(12)
    main = None
    for name, B, H, KV, S, dh, causal, dt, layout in FLASH_CASES:
        dt = getattr(torch, dt)
        if layout == "bshd":
            q = torch.randn(B, S, H, dh, generator=g, device=dev).to(
                dt).transpose(1, 2)
        else:
            q = torch.randn(B, H, S, dh, generator=g, device=dev).to(dt)
        k = torch.randn(B, KV, S, dh, generator=g, device=dev).to(dt)
        v = torch.randn(B, KV, S, dh, generator=g, device=dev).to(dt)
        got = ops.flash_attention(q, k, v, causal=causal)
        again = ops.flash_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dt == torch.float32:
            check(torch.allclose(got, want, **FLASH_F32_TOL),
                  f"flash_attention {name}: f32 {FLASH_F32_TOL}")
            tol = f"atol {FLASH_F32_TOL['atol']} rtol {FLASH_F32_TOL['rtol']}"
        else:
            check(err <= FLASH_BF16_MAX_ABS,
                  f"flash_attention {name}: max abs err {err} > "
                  f"{FLASH_BF16_MAX_ABS}")
            tol = f"max abs {FLASH_BF16_MAX_ABS}"
        check(torch.equal(got, again),
              f"flash_attention {name}: bitwise repeat")
        k_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                       iters=10)
        p_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal),
                       warmup=1, iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters=10)
        b_ms, b_by = flash_bound_ms(B, H, KV, S, S, dh, causal,
                                    q.element_size())
        route = ops._route(dt, dh)
        tflops = flash_ops(B, H, S, S, dh, causal) / k_ms / 1e9
        log(f"kernel flash_attention {name} B={B} H={H} KV={KV} S={S} "
            f"dh={dh} causal={causal} {str(dt)[6:]} q {layout}: route "
            f"{route}; max_abs_err={err:.3e} ({tol}), bitwise repeat ok; "
            f"ms={k_ms:.4f} ({tflops:.1f} TFLOP/s) plain_ms={p_ms:.4f} "
            f"library_ms(sdpa)={lib_ms:.4f} bound_ms={b_ms:.6f} ({b_by})")
        if name == "model":
            main = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                        design=route, tflops=tflops,
                        check=f"{tol} against ref.py, bitwise repeatable")
        del q, k, v, got, again, want
    return main


def rmsnorm_bound_ms(n, d, esize):
    """Least time for one RMSNorm: x read and out written once (n·d
    elements each), scale read once (float32), against HBM bandwidth (the
    ~4 operations per element are far below the compute peaks)."""
    return (2 * n * d * esize + 4 * d) / H100_BYTES_PER_S * 1e3, "bytes"


def rmsnorm_phase(dev):
    """rmsnorm against its plain version at the shapes of the dense
    block's norms ([B·S, d_model] = [8192, 2048]) and of qk-norm
    ([B·H·S, dh] = [131072, 128]) at qwen3-1.7b's prefill, and at odd
    widths. bf16 scales are drawn from [0.4, 0.6], which keeps |out| < 4:
    there one bf16 ulp is at most 2^-6, inside the reference's 2e-2 (its
    own bf16 test normalises unit-scale inputs with scale 1, |out| < ~4).
    Returns the block-norm bf16 row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    g = torch.Generator(device=dev).manual_seed(13)
    main = None
    for n, d in RMSNORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(n, d, generator=g, device=dev).to(dt)
            s = 0.4 + 0.2 * torch.rand(d, generator=g, device=dev)
            got = ops.rmsnorm(x, s, eps=1e-5)
            want = rmsnorm_ref(x, s, eps=1e-5)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                check(torch.allclose(got, want, **RMSNORM_F32_TOL),
                      f"rmsnorm [{n}, {d}] f32 {RMSNORM_F32_TOL}")
                tol = "atol 1e-5 rtol 1e-5"
            else:
                check(err <= RMSNORM_BF16_MAX_ABS,
                      f"rmsnorm [{n}, {d}] bf16: max abs err {err} > "
                      f"{RMSNORM_BF16_MAX_ABS}")
                tol = f"max abs {RMSNORM_BF16_MAX_ABS}"
            sw = s.to(dt)
            calls = {"kernel": lambda: ops.rmsnorm(x, s, eps=1e-5),
                     "plain": lambda: rmsnorm_ref(x, s, eps=1e-5),
                     "library": lambda: F.rms_norm(x, (d,), sw, 1e-5)}
            k_call, p_call, l_call = (time_ms(f) for f in calls.values())
            k_dev, _ = device_ms(calls["kernel"], match=("rmsnorm_kernel",))
            p_dev, _ = device_ms(calls["plain"])
            l_dev, _ = device_ms(calls["library"])
            b_ms, b_by = rmsnorm_bound_ms(n, d, x.element_size())
            aligned = (x.data_ptr() | s.data_ptr()) % 16 == 0
            plan = dict(zip(("vec", "lanes_per_row", "rows_per_warp",
                             "per_lane"), ops._plan(d, dt, aligned)))
            log(f"kernel rmsnorm [{n}, {d}] {str(dt)[6:]}: plan {plan}; "
                f"max_abs_err={err:.3e} ({tol}); device_ms={_fmt(k_dev)} "
                f"call_ms={k_call:.4f}; plain device_ms={_fmt(p_dev)} "
                f"call_ms={p_call:.4f}; library(F.rms_norm) device_ms="
                f"{_fmt(l_dev)} call_ms={l_call:.4f}; bound_ms={b_ms:.6f} "
                f"({b_by})")
            if (n, d) == RMSNORM_SHAPES[0] and dt == torch.bfloat16:
                main = dict(
                    max_abs_err=err, ms=k_call if k_dev is None else k_dev,
                    timing="call ms (events): the profiler saw no device "
                           "time" if k_dev is None
                    else "device ms (torch.profiler)",
                    call_ms=k_call,
                    plain_ms=p_call if p_dev is None else p_dev,
                    library_ms=l_call if l_dev is None else l_dev,
                    plain_call_ms=p_call, library_call_ms=l_call,
                    bound_ms=b_ms, bound_by=b_by,
                    design=f"row in registers, scale once per warp, "
                           f"persistent grid; plan {plan}",
                    check=f"{tol} against ref.py")
    return main


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


def parity_timeline(domains, seed=2):
    """64 regions x 16 invocations x 64 steps = 65536 intervals, t_exec
    ~ 10^3 s, so 1 ms sampling (RAPL's floor) gives ~10^6 samples;
    ``seed`` draws the durations and powers (one per worker)."""
    import numpy as np
    from repro_torch.core.timeline import RegionCost, synthesize
    rng = np.random.default_rng(1)
    costs = [RegionCost(f"r{i}", flops=float(f), hbm_bytes=float(b),
                        invocations=16)
             for i, (f, b) in enumerate(zip(10 ** rng.uniform(11.5, 12.5, 64),
                                            10 ** rng.uniform(9, 10.5, 64)))]
    return synthesize(costs, steps=64, seed=seed, domains=domains)


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


def _combo_stats_check(what, got, n, want, wn, rtol):
    """Same combinations in the same order, equal n and counts, every
    channel's sums within ``rtol``."""
    import numpy as np
    check(n == wn, f"{what}: n {n} == {wn}")
    check(got.interner.combos == want.interner.combos,
          f"{what}: combination order")
    g, w = got.agg.channel_statistics(), want.agg.channel_statistics()
    check(np.array_equal(g[0], w[0]), f"{what}: counts")
    for a, b in zip(g[1:], w[1:]):
        check(np.allclose(a, b, rtol=rtol, atol=0.0), f"{what}: sums "
              f"rtol={rtol}")


BOUNDS_K = 8     # eps multiples for the rounding of power_ci's own steps


def check_estimate_bounds(what, est, oracle, got, want):
    """Interval bounds of two estimate sets whose sufficient statistics
    (``got`` against ``want``, aggregators) differ only by summation
    order. ``t_lo``/``t_hi`` depend on counts alone: equal bit for bit.
    The power and energy bounds go through ``power_ci``'s
    ``var = (sq − cnt·hat²)/(cnt−1)``, which cancels: where a row's
    samples all read nearly one power, var is zero up to rounding and
    ``se = sqrt(var/cnt)`` turns an ulp of the sums into ~sqrt(eps) of
    the bound. So each bound is held within the gap that cancellation
    allows, from the two sides' own sums:

    |Δvar| ≤ (|Δsq| + |Δs|·(|hat_a| + |hat_b|)
              + K·eps·(sq + cnt·hat²)) / (cnt − 1),
    |Δse| ≤ min(sqrt(|Δvar|/cnt), |Δvar|/cnt / (se_a + se_b)),
    |Δpow_lo|, |Δpow_hi| ≤ |Δs|/cnt + 2·eps·|hat| + z·|Δse|
                           + K·eps·|bound|,
    |Δe_lo|, |Δe_hi| ≤ t_lo (t_hi)·|Δpow bound| + K·eps·|e bound|,

    with K = ``BOUNDS_K``; per rail the same. The sums themselves stay
    held at ``PIPELINE_RTOL`` by the caller."""
    import numpy as np
    from repro_torch.core.estimator import z_quantile
    a, b = est.table, oracle.table
    check(np.array_equal(a.region_ids, b.region_ids), f"{what}: rows")
    for f in ("n_samples", "p_hat", "t_hat", "t_lo", "t_hi", "ci_valid"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} equal bit for bit")
    eps = np.finfo(np.float64).eps
    z = z_quantile(est.alpha)
    rows = a.region_ids
    cnt = a.n_samples.astype(np.float64)
    _, s_a, q_a = got.agg.channel_statistics()
    _, s_b, q_b = want.agg.channel_statistics()
    worst = 0.0
    cols = [("pow", "e", -1)]
    if a.pow_rails is not None:
        cols += [(f"pow_rails[{d}]", f"e_rails[{d}]", d)
                 for d in range(a.pow_rails.shape[1])]
    for pname, ename, ch in cols:
        sa, sb = s_a[rows, ch], s_b[rows, ch]
        qa, qb = q_a[rows, ch], q_b[rows, ch]
        hat = np.maximum(np.abs(sa), np.abs(sb)) / cnt
        ds, dq = np.abs(sa - sb), np.abs(qa - qb)
        dvar = np.where(cnt > 1, (dq + ds * 2 * hat + BOUNDS_K * eps * (
            np.maximum(qa, qb) + cnt * hat * hat)) / np.maximum(cnt - 1, 1),
            0.0)
        # |sqrt(x) - sqrt(y)| <= min(sqrt(|x - y|), |x - y| / (sqrt(x) +
        # sqrt(y))): the cancellation's sqrt(eps) only where var ~ 0.
        se = sum(np.sqrt(np.maximum(np.where(
            cnt > 1, (q - s * s / cnt) / np.maximum(cnt - 1, 1), 0.0), 0.0)
            / cnt) for s, q in ((sa, qa), (sb, qb)))
        dse = np.minimum(np.sqrt(dvar / cnt), np.divide(
            dvar / cnt, se, out=np.full_like(se, np.inf), where=se > 0))
        dpow = ds / cnt + 2 * eps * hat + z * dse
        for side, t in (("lo", a.t_lo), ("hi", a.t_hi)):
            if ch < 0:
                pa, pb = getattr(a, f"pow_{side}"), getattr(b, f"pow_{side}")
                ea, eb = getattr(a, f"e_{side}"), getattr(b, f"e_{side}")
            else:
                pa = getattr(a, f"pow_rails_{side}")[:, ch]
                pb = getattr(b, f"pow_rails_{side}")[:, ch]
                ea = getattr(a, f"e_rails_{side}")[:, ch]
                eb = getattr(b, f"e_rails_{side}")[:, ch]
            tol_p = dpow + BOUNDS_K * eps * np.maximum(np.abs(pa),
                                                       np.abs(pb))
            tol_e = t * tol_p + BOUNDS_K * eps * np.maximum(np.abs(ea),
                                                            np.abs(eb))
            for name, x, y, tol in ((f"{pname}_{side}", pa, pb, tol_p),
                                    (f"{ename}_{side}", ea, eb, tol_e)):
                d = np.abs(x - y)
                r = np.divide(d, tol, out=np.where(d > 0, np.inf, 0.0),
                              where=tol > 0)
                top = float(r.max(initial=0.0))
                check(top <= 1.0, f"{what}: {name} within the cancellation "
                      f"bound (worst {top:.3g} of it)")
                worst = max(worst, top)
    return worst


def _region_counts(agg, R):
    """Samples per region of the first worker (the region axis of a
    bounded table's ``other`` rows)."""
    import numpy as np
    rows = np.asarray(agg.interner.combos, np.int64)
    return np.bincount(rows[:, 0], weights=agg.agg.counts, minlength=R)


def combo_parity_phase():
    """The combination pipeline on the GPU against the port's numpy oracle
    (``reference_combo_pipeline``) for W in {1, 4} workers (one parity
    timeline per worker, seeds 2, 3, ...), D in {1, 3}, every trace
    sensor, ~10^6 samples each: the combination order, n and counts
    equal, sums to ``PIPELINE_RTOL``; the same through
    ``EnergyProfiler.profile_multiworker_streaming(pipeline="device")``
    against the oracle's estimates; two rapl runs bitwise equal; and one
    bounded run (``max_combinations`` a tenth of the distinct count)."""
    import numpy as np
    from repro_torch.core import device_pipeline as dp, sensors
    from repro_torch.core.profiler import EnergyProfiler
    specs = {"instant": sensors.InstantTraceSensor,
             "rapl": sensors.RaplTraceSensor,
             "ina231": sensors.Ina231TraceSensor}
    for W in (1, 4):
        for domains in (False, True):
            tls = [parity_timeline(domains, seed=2 + w) for w in range(W)]
            t_end = min(t.t_exec for t in tls)
            names = tls[0].names
            dtl = dp.DeviceTimeline.from_timelines(tls, device="cuda")
            D = dtl.num_domains
            for name, cls in specs.items():
                spec = cls.make_spec(domains=dtl.domains)
                period = max(spec.effective_min_period(), t_end / 1.05e6)
                kw = dict(period=period, jitter=0.2 * period, seed=5,
                          chunk_size=65536)
                what = f"combo-parity {name} W={W} D={D}"
                stats = {}
                t0 = time.perf_counter()
                got, n = dp.run_combo_pipeline(dtl, spec, stats=stats, **kw)
                t_gpu = time.perf_counter() - t0
                want, wn = dp.reference_combo_pipeline(
                    tls, lambda tl: spec, **kw)
                _combo_stats_check(what, got, n, want, wn, PIPELINE_RTOL)
                prof = EnergyProfiler(period=period, jitter=0.2 * period,
                                      seed=5, device="cuda")
                est, rows = prof.profile_multiworker_streaming(
                    tls, sensor=name, chunk_size=65536, pipeline="device")
                oracle, orows = want.estimates(t_end, names)
                check(rows == orows, f"{what}: estimate combinations")
                check(np.array_equal(est.table.n_samples,
                                     oracle.table.n_samples),
                      f"{what}: estimate counts")
                for f in ("t_hat", "pow_hat", "e_hat", "pow_rails",
                          "e_rails"):
                    a, b = getattr(est.table, f), getattr(oracle.table, f)
                    check((a is None and b is None) or np.allclose(
                        a, b, rtol=PIPELINE_RTOL, atol=0.0),
                          f"{what}: estimate {f}")
                # The interval bounds: t_lo/t_hi bit for bit, the power
                # and energy bounds within power_ci's cancellation gap.
                worst = check_estimate_bounds(what, est, oracle, got, want)
                extra = ""
                if name == "rapl":
                    again, _ = dp.run_combo_pipeline(dtl, spec, **kw)
                    check(again.interner.combos == got.interner.combos
                          and all(np.array_equal(a, b) for a, b in zip(
                              again.agg.channel_statistics(),
                              got.agg.channel_statistics())),
                          f"{what}: bitwise repeat")
                    extra = ", two GPU runs bitwise equal"
                if name == "instant" and W == 4 and D == 1:
                    k = max(1, len(got.interner) // 10)
                    bstats = {}
                    bounded, bn = dp.run_combo_pipeline(
                        dtl, spec, max_combinations=k, stats=bstats, **kw)
                    R = len(names)
                    check(bn == n, f"{what} bounded: n")
                    check(np.array_equal(_region_counts(bounded, R),
                                         _region_counts(got, R)),
                          f"{what} bounded: per-region counts")
                    check(bstats["tail_folds"] > 0,
                          f"{what} bounded: tail_folds > 0")
                    check(len(bounded.interner) <= k + R,
                          f"{what} bounded: rows <= k + regions")
                    extra += (f"; bounded k={k}: {len(bounded.interner)} "
                              f"rows, tail_folds {bstats['tail_folds']}, "
                              f"{bstats['miss_chunks']} of "
                              f"{bstats['chunks']} chunks missed, "
                              f"per-region counts equal")
                log(f"{what}: n={n} samples, {len(got.interner)} "
                    f"combinations, {stats['miss_chunks']} of "
                    f"{stats['chunks']} chunks missed; order, counts equal, "
                    f"sums rtol {PIPELINE_RTOL}, first-moment estimates "
                    f"equal, t_lo/t_hi equal, power/energy bounds within "
                    f"the cancellation bound (worst {worst:.3g} of it, "
                    f"K={BOUNDS_K}); GPU run {t_gpu:.3f} s" + extra)
            del dtl


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
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    with captured_aggregators() as aggs:
        t0 = time.perf_counter()
        est = prof.profile_timeline_streaming(tl, sensor="instant",
                                              chunk_size=chunk,
                                              pipeline="device")
        secs = time.perf_counter() - t0
    launches = ops.sample_attr_fold.launches
    others = {c.__name__: c.launches for c in counters
              if c is not ops.sample_attr_fold}
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
    check(not any(others.values()), f"full: other kernels launched {others}")
    check(bool((est.table.pow_hat > 0).all()) and all(
        bool(torch.isfinite(torch.as_tensor(getattr(est.table, f))).all())
        for f in ("pow_hat", "e_hat", "e_rails")),
        "full: finite positive estimates")
    log(f"full: {n} samples in {n_chunks} chunks, {secs:.3f} s "
        f"({n / secs:.4e} samples/s), peak device memory "
        f"{peak / 2 ** 20:.1f} MiB, sample_attr launches {launches}, "
        f"regions attributed {len(est.table)}")
    check(len(aggs) == 1, "full: one aggregator built")
    return dict(n=n, chunks=n_chunks, seconds=secs, launches=launches,
                peak_bytes=peak, agg=aggs[0])


class FullChunk:
    """Chunk ``k`` of the full cell's profiling run on ``dev``, as the main
    path folds it: ``ids`` [c] int32, ``pows`` [C, c] float64, ``valid``
    [c] bool, with the run's clock and sensor state beside them."""

    def __init__(self, tl, dev, k=700, c=65536):
        import torch
        from repro_torch.core import device_pipeline as dp, sensors, threefry
        self.dtl = tl.to_device(device=dev)
        self.spec = sensors.InstantTraceSensor.make_spec(
            domains=tl.domain_names)
        self.k, self.c = k, c
        self.period = tl.t_exec / 102_000_000
        self.jitter = 0.2 * self.period
        self.root = threefry.PRNGKey(0)
        self.u0 = dp._phase(self.root, self.period)
        self.prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
        rid_mat, self.pows, self.valid, _ = dp._chunk_samples(
            self.dtl, self.spec, self.root, self.u0, k, c, self.period,
            self.jitter, self.prev)
        self.ids = rid_mat[0]
        self.R, self.C = self.dtl.num_regions, self.pows.shape[0]
        ids = self.ids[self.valid].cpu().numpy()
        runs = 1 + int((ids[1:] != ids[:-1]).sum()) if ids.size else 0
        log(f"full chunk k={k}: {int(self.valid.sum())} of {c} lanes valid, "
            f"{len(set(ids.tolist()))} regions in {runs} runs (mean run "
            f"{ids.size / max(runs, 1):.0f} samples)")


def breakdown_phase(tl):
    """The fold on the full cell's own chunk (k = 700: the ids, channels
    and mask the main path launches it with), held and timed by
    :func:`fold_row`; then where one chunk's time goes: host wall time per
    call of each layer (clock, lookup, sensor, fold; the loop is
    launch-bound, so wall time is what a layer costs the run), and, from
    a torch.profiler trace of whole chunks, kernels per chunk and the
    device's busy share (measured, not checked). Returns the fold's row."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import device_pipeline as dp
    from repro_torch.kernels.sample_attr import ops
    dev = torch.device("cuda")
    ch = FullChunk(tl, dev)
    dtl, spec, root, u0, k, c = ch.dtl, ch.spec, ch.root, ch.u0, ch.k, ch.c
    period, jitter, prev = ch.period, ch.jitter, ch.prev
    arrs = dtl.arrays()
    ends, bounds, eint, powers, rids, m_true, grid, cell = arrs
    t_raw = dp._raw_chunk_times(root, u0, k, c, period, jitter, dev)
    valid = t_raw < dtl.t_end
    t = torch.clamp_max(t_raw, dtl.t_end)
    cnt = dp._count_le(ends, grid, cell, t, dtl.grid_k)
    rid, chan = ch.ids, ch.pows
    R, C = ch.R, ch.C
    row = fold_row(f"full chunk k={k}", R, C, rid, chan, ch.valid)
    carry = fresh_carry(R, C, dev)

    def chunk():
        r, ch, v, _ = dp._chunk_samples(dtl, spec, root, u0, k, c, period,
                                        jitter, prev)
        ops.sample_attr_fold(*carry, r[0], ch, v)

    layers = {
        "clock": lambda: dp._raw_chunk_times(root, u0, k, c, period,
                                             jitter, dev),
        "lookup": lambda: dp._count_le(ends, grid, cell, t, dtl.grid_k),
        "sensor": lambda: dp._sensor_powers(spec, arrs, t, cnt, valid, prev,
                                            dtl.grid_k),
        "fold": lambda: ops.sample_attr_fold(*carry, rid, chan, valid),
        "chunk": chunk,
    }
    walls = {name: wall_ms(fn, iters=50) for name, fn in layers.items()}
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
        return row
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"breakdown (profiled, {chunks} chunks): {launched / chunks:.0f} "
        f"kernels per chunk, device busy {busy_us / 1e3 / chunks:.3f} ms "
        f"of {wall * 1e3 / chunks:.3f} ms wall per chunk (busy share "
        f"{busy_us / 1e6 / wall:.3f}); top kernels by device time: "
        + "; ".join(f"{e.key[:48]} x{e.count // chunks} "
                    f"{e.self_device_time_total / 1e3 / chunks:.4f} ms"
                    for e in top))
    return row


# ---------------------------------------------------------------------------
# The combination pipeline at full size.
# ---------------------------------------------------------------------------

COMBO_WORKERS = 16
COMBO_SAMPLES = 52_000_000
# Workers cross each boundary of the shared interval structure this many
# sample periods apart: every window between two crossings holds at least
# two samples (their gaps are at most period + jitter = 1.2 periods), so
# each step already shows every transition pattern.
COMBO_SHIFT = 2.5


def combo_timelines(tl, period):
    """``COMBO_WORKERS`` phase-shifted copies of ``tl``, built as the
    reference's fleet benchmark builds its workers
    (benchmarks/pipeline.py): worker w leads with a pad interval of
    ``w·COMBO_SHIFT·period`` (+1 ns) in the first interval's region and
    power. The spread (15 · 2.5 periods) stays under the shortest region
    block (16 invocations, ~185 periods at this period), so a row holds
    at most two regions: the combinations are each boundary's transition
    patterns, 4096 boundaries × (W - 1) mixed rows plus the 4096 pure
    ones."""
    import numpy as np
    from repro_torch.core.timeline import Timeline
    ids, durs, pows = tl.region_ids, tl.durations, tl.powers
    rails = tl.rail_powers
    out = []
    for w in range(COMBO_WORKERS):
        off = w * COMBO_SHIFT * period + 1e-9
        out.append(Timeline(
            np.concatenate([ids[:1], ids]), np.concatenate([[off], durs]),
            np.concatenate([pows[:1], pows]), tl.names,
            rail_powers=np.concatenate([rails[:1], rails]),
            domains=tl.domains))
    return out


class ComboChunk:
    """Chunk ``k`` of the combo-full run in the steady state: the table
    the run ended with, and the ids, channels and mask its step folds
    (every row found, so the mask is the valid lanes)."""

    def __init__(self, dtl, spec, interner, period, k, c=65536):
        import torch
        from repro_torch.core import device_pipeline as dp, threefry
        self.dtl, self.spec, self.k, self.c = dtl, spec, k, c
        self.period, self.jitter = period, 0.2 * period
        self.pack = dp._pack_spec(dtl.num_regions, dtl.num_workers)
        self.cap = dp._table_cap(len(interner))
        self.table = dp._build_table(interner, self.cap, self.pack,
                                     dtl.device)
        self.root = threefry.PRNGKey(0)
        self.u0 = dp._phase(self.root, period)
        self.prev = torch.full((), -1.0, dtype=torch.float64,
                               device=dtl.device)
        rid_mat, self.pows, valid, _ = self.samples()
        self.ids, found = self.table.lookup(rid_mat)
        check(not bool((valid & ~found).any()),
              f"combo chunk k={k}: every row in the table")
        self.valid = valid & found
        self.C = self.pows.shape[0]
        ok = self.ids[self.valid]
        self.touched = int(torch.unique(ok).numel())
        log(f"combo chunk k={k}: {int(valid.sum())} of {c} lanes valid, "
            f"{self.touched} combinations touched, table capacity "
            f"{self.cap}, {self.pack[2]} key words")

    def samples(self):
        from repro_torch.core import device_pipeline as dp
        return dp._chunk_samples(self.dtl, self.spec, self.root, self.u0,
                                 self.k, self.c, self.period, self.jitter,
                                 self.prev)

    def step(self, carry, read_flag=True):
        """The steady-state pass of run_combo_pipeline's chunk loop:
        sample, look up, fold, read the miss flag (``read_flag=False``
        leaves the flag on the device, so the host may run ahead)."""
        from repro_torch.kernels.sample_attr import ops
        rid_mat, chan, valid, _ = self.samples()
        ids, found = self.table.lookup(rid_mat)
        any_miss = (valid & ~found).any()
        ops.sample_attr_fold(*carry, ids, chan, valid & found & ~any_miss)
        return bool(any_miss) if read_flag else any_miss

    def layer_walls(self):
        """Host wall ms per call (after a sync) of each layer of one
        chunk: clock, lookup, sensor, pack + search, fold, miss-flag read,
        the whole step, and the step without its flag read (what the
        per-chunk sync costs is the difference)."""
        import torch
        from repro_torch.core import device_pipeline as dp
        from repro_torch.kernels.sample_attr import ops
        dtl = self.dtl
        arrs = dtl.arrays()
        ends, grid, cell = arrs[0], arrs[6], arrs[7]
        dev = dtl.device
        t_raw = dp._raw_chunk_times(self.root, self.u0, self.k, self.c,
                                    self.period, self.jitter, dev)
        valid = t_raw < dtl.t_end
        t = torch.clamp_max(t_raw, dtl.t_end)
        cnt = dp._count_le(ends, grid, cell, t, dtl.grid_k)
        rid_mat, _, _, _ = self.samples()
        _, found = self.table.lookup(rid_mat)
        carry = fresh_carry(self.cap, self.C, dev)
        layers = {
            "clock": lambda: dp._raw_chunk_times(
                self.root, self.u0, self.k, self.c, self.period,
                self.jitter, dev),
            "lookup": lambda: dp._count_le(ends, grid, cell, t, dtl.grid_k),
            "sensor": lambda: dp._sensor_powers(self.spec, arrs, t, cnt,
                                                valid, self.prev,
                                                dtl.grid_k),
            "pack+search": lambda: self.table.lookup(rid_mat),
            "fold": lambda: ops.sample_attr_fold(*carry, self.ids,
                                                 self.pows, self.valid),
            "miss-flag read": lambda: bool((valid & ~found).any()),
            "chunk": lambda: self.step(carry),
            "chunk without the flag read": lambda: self.step(
                carry, read_flag=False),
        }
        return {name: wall_ms(fn) for name, fn in layers.items()}


def wall_ms(fn, iters=20):
    """Host wall ms per call of ``fn`` (synchronised before and after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def combo_full_phase(tl):
    """The multi-worker combination path at full size: 16 phase-shifted
    workers (:func:`combo_timelines`) of the full cell's timeline (4096
    regions, 2^20 intervals, 3 rails), 12-bit ids in 4 int64 key words,
    ``instant`` sensor, chunk 65536, >= 5·10^7 samples; the launch
    counters set to 0 just before ``run_combo_pipeline`` (the device
    branch of ``profile_multiworker_streaming``, called directly for its
    ``stats``) and read just after. Checks the sample count, the
    estimates, 10^4-10^5 combinations, and one ``sample_attr`` launch per
    chunk plus one per miss chunk. Then the wall per layer of one
    steady-state chunk."""
    import torch
    from repro_torch.core import device_pipeline as dp, sensors
    from repro_torch.kernels.sample_attr import ops
    period = tl.t_exec / COMBO_SAMPLES
    jitter = 0.2 * period
    chunk = 65536
    t0 = time.perf_counter()
    tls = combo_timelines(tl, period)
    dtl = dp.DeviceTimeline.from_timelines(tls, device="cuda")
    del tls
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spec = sensors.InstantTraceSensor.make_spec(domains=dtl.domains)
    pack = dp._pack_spec(dtl.num_regions, dtl.num_workers)
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    stats = {}
    t0 = time.perf_counter()
    agg, n = dp.run_combo_pipeline(dtl, spec, period=period, jitter=jitter,
                                   seed=0, chunk_size=chunk, stats=stats)
    secs = time.perf_counter() - t0
    launches = ops.sample_attr_fold.launches
    others = {c.__name__: c.launches for c in counters
              if c is not ops.sample_attr_fold}
    peak = torch.cuda.max_memory_allocated()
    est, rows = agg.estimates(dtl.t_end, tl.names)
    distinct = len(agg.interner)
    chunks, misses = stats["chunks"], stats["miss_chunks"]
    lo = int((dtl.t_end - period - jitter) // period)
    hi = int(dtl.t_end // period) + 1
    check(lo <= n <= hi, f"combo-full: n={n} within [{lo}, {hi}]")
    check(n >= 50_000_000, "combo-full: >= 5·10^7 samples")
    check(int(est.table.n_samples.sum()) == n,
          "combo-full: sum of counts == n")
    check(pack[2] == 4, f"combo-full: {pack[2]} key words == 4")
    check(10_000 <= distinct <= 100_000,
          f"combo-full: {distinct} combinations within 10^4-10^5")
    check(launches == chunks + misses,
          f"combo-full: sample_attr launches {launches} == chunks {chunks} "
          f"+ miss chunks {misses}")
    check(not any(others.values()),
          f"combo-full: other kernels launched {others}")
    check(misses < chunks / 2, f"combo-full: {misses} of {chunks} chunks "
          f"missed; steady state expected")
    check(bool((est.table.pow_hat > 0).all()) and all(
        bool(torch.isfinite(torch.as_tensor(getattr(est.table, f))).all())
        for f in ("pow_hat", "e_hat", "e_rails")),
        "combo-full: finite positive estimates")
    cap = dp._table_cap(distinct)
    log(f"combo-full: W={dtl.num_workers} workers, {n} samples in {chunks} "
        f"chunks, {secs:.3f} s ({n / secs:.4e} samples/s); {misses} miss "
        f"chunks ({stats['miss_seconds']:.3f} s of host wall in the miss "
        f"path), {distinct} combinations, table capacity {cap}, "
        f"{pack[2]} key words ({pack[0]} bits a region); sample_attr "
        f"launches {launches}; peak device memory {peak / 2 ** 20:.1f} "
        f"MiB; timelines built and uploaded in {build_s:.1f} s")
    ch = ComboChunk(dtl, spec, agg.interner, period, k=chunks - 2, c=chunk)
    walls = ch.layer_walls()
    log(f"combo-full breakdown (wall ms per call, chunk k={ch.k}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return dict(n=n, chunks=chunks, miss_chunks=misses, seconds=secs,
                launches=launches, peak_bytes=peak, distinct=distinct,
                cap=cap, walls=walls, chunk=ch, agg=agg)


def combo_fold_phase(combo):
    """``sample_attr`` on one steady-state chunk of combo-full at R = the
    table capacity, held and timed by :func:`fold_row` (the kernel
    line's second ``sample_attr`` path); then kernels per chunk and the
    device's busy share from a torch.profiler trace of whole chunks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ch = combo["chunk"]
    row = fold_row(f"combo chunk k={ch.k}", ch.cap, ch.C, ch.ids, ch.pows,
                   ch.valid)
    carry = fresh_carry(ch.cap, ch.C, ch.dtl.device)
    ch.step(carry)
    chunks = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            ch.step(carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    launched = sum(e.count for e in kern)
    if busy_us <= 0:
        log("combo breakdown: device time not measured (the profiler saw "
            "no device events)")
        return row
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"combo breakdown (profiled, {chunks} chunks): "
        f"{launched / chunks:.0f} kernels per chunk, device busy "
        f"{busy_us / 1e3 / chunks:.3f} ms of {wall * 1e3 / chunks:.3f} ms "
        f"wall per chunk (busy share {busy_us / 1e6 / wall:.3f}); top "
        f"kernels by device time: "
        + "; ".join(f"{e.key[:48]} x{e.count // chunks} "
                    f"{e.self_device_time_total / 1e3 / chunks:.4f} ms"
                    for e in top))
    row["kernels_per_chunk"] = launched / chunks
    return row


# ---------------------------------------------------------------------------
# Host seam and host sessions.
# ---------------------------------------------------------------------------


def _agg_bits_equal(a, b):
    """Combination order, counts and every channel's sums bit for bit."""
    import numpy as np
    ra = getattr(a, "interner", None)
    rb = getattr(b, "interner", None)
    if (ra is None) != (rb is None):
        return False
    if ra is not None and ra.combos != rb.combos:
        return False
    sa = (a.agg if ra is not None else a).channel_statistics()
    sb = (b.agg if rb is not None else b).channel_statistics()
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(sa, sb))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def exchange_phase(region_agg, combo_agg, smi):
    """The cross-host shard exchange on the card, in a world of one
    (NCCL): (a) ``CollectiveExchange().reduce`` and (b)
    ``CheckpointExchange(tmpdir).reduce`` of combo-full's aggregator
    (65 536 combinations × 16 workers) and of the full run's region
    aggregator (4096 regions, 3 rails) each return their input bit for
    bit; (c) ``profile_multiworker_streaming(exchange=...)`` with either
    strategy at combo-parity W=4 equals ``exchange=None`` column for
    column. Prints the seconds of each reduce (the collective's first
    call includes NCCL's set-up), of the spill and of the gather, and the
    spill's bytes. A hung collective fails the phase (watchdog)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import exchange as ex
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.launch.mesh import make_exchange_mesh
    with watchdog(300, "exchange phase"):
        t0 = time.perf_counter()
        mesh = make_exchange_mesh(device="cuda")
        t_mesh = time.perf_counter() - t0
        check(dist.get_backend() == "nccl" and mesh.size() == 1,
              "exchange: NCCL world of one")
        for name, agg in (("combination", combo_agg), ("region", region_agg)):
            rows = (len(agg.interner) if name == "combination"
                    else agg.num_regions)
            coll = ex.CollectiveExchange(mesh)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = coll.reduce(agg)
                times.append(time.perf_counter() - t0)
                check(_agg_bits_equal(out, agg), f"exchange {name}: "
                      f"collective reduce == input bit for bit")
            with tempfile.TemporaryDirectory() as d:
                t0 = time.perf_counter()
                out = ex.CheckpointExchange(os.path.join(d, "a"),
                                            host_id=0).reduce(agg)
                t_ckpt = time.perf_counter() - t0
                check(_agg_bits_equal(out, agg), f"exchange {name}: "
                      f"checkpoint reduce == input bit for bit")
                t0 = time.perf_counter()
                ex.spill_shard(os.path.join(d, "b"), 0, 1, agg)
                t_spill = time.perf_counter() - t0
                nbytes = _dir_bytes(os.path.join(d, "b"))
                t0 = time.perf_counter()
                back = ex.gather_shards(os.path.join(d, "b"))
                t_gather = time.perf_counter() - t0
                check(_agg_bits_equal(back, agg), f"exchange {name}: "
                      f"spill + gather == input bit for bit")
            log(f"exchange {name} ({rows} rows, "
                f"{len(agg.domains)} domains): collective reduce {times[0]:.4f} s (first, "
                f"NCCL set-up included) / {times[1]:.4f} s, checkpoint "
                f"reduce {t_ckpt:.4f} s (spill {t_spill:.4f} s + gather "
                f"{t_gather:.4f} s of {nbytes} bytes); all bit for bit "
                f"[{smi}]")

        # (c) the profiler's exchange= at combo-parity W=4.
        tls = [parity_timeline(False, seed=2 + w) for w in range(4)]
        t_end = min(t.t_exec for t in tls)
        period = t_end / 1.05e6
        prof = EnergyProfiler(period=period, jitter=0.2 * period, seed=5,
                              device="cuda")
        kw = dict(sensor="instant", chunk_size=65536, pipeline="device")
        alone, rows = prof.profile_multiworker_streaming(tls, **kw)
        with tempfile.TemporaryDirectory() as d:
            for name, strategy in (
                    ("collective", ex.CollectiveExchange(mesh)),
                    ("checkpoint", ex.CheckpointExchange(d, host_id=0))):
                t0 = time.perf_counter()
                est, erows = prof.profile_multiworker_streaming(
                    tls, exchange=strategy, **kw)
                secs = time.perf_counter() - t0
                check(erows == rows, f"exchange profiler {name}: "
                      f"combinations")
                for f in ("region_ids", "n_samples", "p_hat", "t_hat",
                          "t_lo", "t_hi", "pow_hat", "pow_lo", "pow_hi",
                          "e_hat", "e_lo", "e_hi", "ci_valid"):
                    check(np.array_equal(getattr(est.table, f),
                                         getattr(alone.table, f)),
                          f"exchange profiler {name}: {f} == exchange=None")
                log(f"exchange profiler W=4 {name}: {est.n_total} samples, "
                    f"{len(rows)} combinations, estimates equal to "
                    f"exchange=None column for column; run {secs:.3f} s")
        dist.destroy_process_group()
    log(f"exchange: mesh (NCCL, world of one) set up in {t_mesh:.3f} s")


def host_seam_phase():
    """``profile_timeline_streaming(pipeline="host")`` with the kernel
    plugged into the host chunk seam (``chunked_aggregate_fn`` on the
    GPU) against the same call with the numpy aggregation, on the parity
    timeline at D=1 and D=3: counts equal, estimates to
    ``PIPELINE_RTOL``, and the kernel launched."""
    import numpy as np
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.kernels.sample_attr import ops
    for domains in (False, True):
        tl = parity_timeline(domains)
        period = 1e-3
        prof = EnergyProfiler(period=period, jitter=0.2 * period, seed=5,
                              device="cuda")
        ops.sample_attr_fold.launches = 0
        t0 = time.perf_counter()
        got = prof.profile_timeline_streaming(
            tl, sensor="rapl", pipeline="host",
            aggregate_fn=ops.chunked_aggregate_fn(device="cuda"))
        secs = time.perf_counter() - t0
        launches = ops.sample_attr_fold.launches
        want = prof.profile_timeline_streaming(tl, sensor="rapl",
                                               pipeline="host")
        what = f"host-seam D={tl.num_domains}"
        check(launches > 0, f"{what}: sample_attr launched")
        check(np.array_equal(got.table.n_samples, want.table.n_samples),
              f"{what}: counts")
        for f in ("pow_hat", "pow_lo", "pow_hi", "e_hat"):
            check(np.allclose(getattr(got.table, f), getattr(want.table, f),
                              rtol=PIPELINE_RTOL),
                  f"{what}: estimate {f}")
        log(f"{what}: n={got.n_total} samples, counts equal, estimates "
            f"rtol {PIPELINE_RTOL} against the numpy seam; sample_attr "
            f"launches {launches}; {secs:.3f} s")


def host_session_phase(dev):
    """A short ``host_session`` around named regions of GPU work (a
    4096² float32 matmul, waited for), once marked by ``region`` and once
    by ``mark_in_jit`` under ``jit_marking=True``. Checks, as loose as
    the reference's own: samples taken, the regions in the estimates,
    Σ t̂ equal to the session's measured time and that within its wall
    time."""
    import torch
    from repro_torch.core import regions
    from repro_torch.core.profiler import EnergyProfiler
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(4096, 4096, generator=g, device=dev)
    prof = EnergyProfiler(period=1e-3, jitter=1e-4, device="cuda")
    for jit_marking in (False, True):
        name = "gpu_marked" if jit_marking else "gpu_matmul"
        t0 = time.perf_counter()
        with prof.host_session(jit_marking=jit_marking) as sess:
            for _ in range(60):
                if jit_marking:
                    regions.mark_in_jit(name)
                    (x @ x).sum().item()
                    regions.mark_in_jit("<other>")
                    time.sleep(0.5e-3)
                else:
                    with regions.region(name):
                        (x @ x).sum().item()
                    with regions.region("host_sleep"):
                        time.sleep(0.5e-3)
        wall = time.perf_counter() - t0
        est = sess.estimates()
        what = f"host-session jit_marking={jit_marking}"
        seen = {r.name: r for r in est.regions if r.n_samples}
        t_sum = sum(r.t_hat for r in est.regions)
        check(est.n_total > 0, f"{what}: samples taken")
        check(name in seen and seen[name].n_samples >= 5,
              f"{what}: {name} sampled")
        check(abs(t_sum - est.t_exec) <= 1e-6 * est.t_exec,
              f"{what}: sum of t_hat == session time")
        check(0.0 < est.t_exec <= wall, f"{what}: session time within wall")
        log(f"{what}: {est.n_total} samples over {est.t_exec:.3f} s "
            f"(wall {wall:.3f} s, sensor "
            f"{type(sess.sampler.sensor).__name__}); "
            + ", ".join(f"{k} n={r.n_samples} t_hat={r.t_hat:.4f} s"
                        for k, r in sorted(seen.items())))
    with watchdog(120, "host-session stream order"):
        stream_order_check(prof)


def stream_order_check(prof, kernel_s=0.5, after_s=0.1):
    """``mark_in_jit`` marks in stream order: one region is marked, a
    ~``kernel_s`` device kernel (``torch.cuda._sleep``) is queued and the
    host returns at once, then a host-only region is marked and the host
    waits for the stream and ``after_s`` more. The samples taken while
    the kernel runs must fall in the long region (stored at issue time,
    they would fall in the host region)."""
    import torch
    from repro_torch.core import regions
    from repro_torch.core.stream_marker import StreamMarker
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles = int(50_000_000 * kernel_s * 1e3 / start.elapsed_time(end))
    with prof.host_session(jit_marking=True) as sess:
        check(isinstance(sess.marker, StreamMarker),
              "host-session stream order: the CUDA session's marker is a "
              "StreamMarker")
        t0 = time.perf_counter()
        regions.mark_in_jit("gpu_long")
        torch.cuda._sleep(cycles)
        regions.mark_in_jit("host_after")
        t_issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        time.sleep(after_s)
    est = sess.estimates()
    seen = {r.name: r for r in est.regions if r.n_samples}
    n_long = seen["gpu_long"].n_samples if "gpu_long" in seen else 0
    n_host = seen["host_after"].n_samples if "host_after" in seen else 0
    t_long = seen["gpu_long"].t_hat if "gpu_long" in seen else 0.0
    what = "host-session stream order"
    check(sess.marker.queued == 2, f"{what}: 2 stores queued on the stream")
    check(t_issue < 0.1 * t_kernel, f"{what}: the host queued the kernel "
          f"at once ({t_issue:.4f} s of {t_kernel:.3f} s)")
    check(n_long > n_host, f"{what}: gpu_long n={n_long} > host_after "
          f"n={n_host}")
    check(t_long >= 0.5 * t_kernel, f"{what}: t_hat(gpu_long) "
          f"{t_long:.3f} s >= half the kernel's {t_kernel:.3f} s")
    log(f"{what}: kernel {t_kernel:.3f} s queued in {t_issue * 1e3:.3f} ms; "
        f"gpu_long n={n_long} t_hat={t_long:.3f} s, host_after n={n_host} "
        f"(host-only {after_s} s); 2 stores queued in stream order")


# ---------------------------------------------------------------------------
# Phase 6: the dense-transformer serving path at full size.
# ---------------------------------------------------------------------------

MODEL_ARCH = "qwen3-1.7b"
MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_DECODE = 4, 2048, 2080, 32
MODEL_REGIONS = ("embed", "attn", "ffn", "lm_head")


def _max_rel(a, b):
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def model_phase(dev):
    """``prefill`` + 32 ``decode_step``s of full-width, full-depth
    qwen3-1.7b (bf16 compute, random float32 master weights from a seeded
    generator, held as a bf16 copy). The launch counters are set to 0
    just before the main path (prefill and decode) and read just after.

    Checks: 28 flash launches per prefill (one per layer) and none in
    decode; finite outputs of the expected shapes; the flash prefill's
    last-position logits and its cache within ``MODEL_REL_TOL`` of
    max |.| of the same prefill through ``attn_impl="full"`` (layer 0's
    K/V, computed before any attention, bitwise equal); the first decode
    step's logits within the same share of a prefill of the prompt plus
    that token. The tolerance: the reference's own kernel-vs-plain bf16
    spread is 1.0% of max |logit| through 2 layers (0.031 at 3.06); the
    two attention paths round differently (the kernel rounds p to bf16
    per 128-key tile before its online rescale, the plain path rounds the
    normalised probabilities), and the difference compounds through 28
    layers, so 5% is allowed.
    Returns the measurements and the path's launch counts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    cfg = get_config(MODEL_ARCH)
    B, S, T, steps = MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_DECODE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    master = M.init_params(g, cfg, device=dev)
    p = M.cast_params(master, cfg)
    del master
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(p))
    log(f"model: {MODEL_ARCH} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"H={cfg.n_heads} KV={cfg.n_kv_heads} dh={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}: {n_params} parameters "
        f"drawn and cast to bf16 in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    batch = {"tokens": tokens}

    M.prefill(p, cfg, batch, T, attn_impl="flash")       # warm-up
    torch.cuda.synchronize()
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    logits, cache, cur = M.prefill(p, cfg, batch, T, attn_impl="flash")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = fa_ops.flash_attention.launches
    cur_len = cur.to(torch.int32).expand(B).contiguous()     # [B]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    first = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step_logits, cache = M.decode_step(p, cfg, tok, cache, cur_len)
        if i == 0:
            first = (tok.clone(), step_logits.clone())
        tok = step_logits[:, -1].argmax(-1, keepdim=True)
        cur_len = cur_len + 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check(after_prefill == cfg.n_layers,
          f"model: flash launches per prefill {after_prefill} == "
          f"{cfg.n_layers}")
    check(launches == {"sample_attr_fold": 0, "flash_attention": cfg.n_layers,
                       "rmsnorm": 0},
          f"model: launches in prefill + decode {launches}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "model: prefill logits")
    check(tuple(step_logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(step_logits).all()),
          "model: decode logits")
    check(int(cur_len[0]) == S + steps, "model: cur_len after decode")

    full_logits, full_cache, _ = M.prefill(p, cfg, batch, T,
                                           attn_impl="full")
    rel = _max_rel(logits, full_logits)
    check(rel <= MODEL_REL_TOL,
          f"model: flash vs full prefill logits {rel:.4f} of max |logit|")
    l0 = cache["blocks"][0]
    check(all(torch.equal(l0[k][:, :, :S], full_cache["blocks"][0][k][:, :, :S])
              for k in ("k", "v")), "model: layer-0 cache bitwise equal")
    cache_rel = max(_max_rel(c[k][:, :, :S], f[k][:, :, :S])
                    for c, f in zip(cache["blocks"], full_cache["blocks"])
                    for k in ("k", "v"))
    check(cache_rel <= MODEL_REL_TOL,
          f"model: flash vs full prefill cache {cache_rel:.4f} of max |.|")
    agree = (logits[:, -1].argmax(-1) == full_logits[:, -1].argmax(-1)
             ).float().mean().item()
    del full_cache
    tok0, logits0 = first
    ext = {"tokens": torch.cat([tokens, tok0], dim=1)}
    ext_logits, _, _ = M.prefill(p, cfg, ext, T, attn_impl="flash")
    dec_rel = _max_rel(logits0, ext_logits)
    check(dec_rel <= MODEL_REL_TOL,
          f"model: first decode step vs prefill of S+1 tokens "
          f"{dec_rel:.4f} of max |logit|")
    log(f"model: flash vs full prefill: logits {rel:.4f} of max |logit| "
        f"({full_logits.float().abs().max().item():.3f}), cache "
        f"{cache_rel:.4f} of max |.|, layer-0 K/V bitwise equal, greedy "
        f"tokens agree on {agree:.2f} of rows (tolerance {MODEL_REL_TOL}); "
        f"decode step 1 vs prefill of S+1 tokens {dec_rel:.4f}")
    log(f"model: prefill B={B} S={S} {prefill_s * 1e3:.2f} ms "
        f"({B * S / prefill_s:.1f} tokens/s), {after_prefill} flash "
        f"launches; decode {steps} steps {decode_s * 1e3 / steps:.3f} ms "
        f"per step ({B * steps / decode_s:.1f} tokens/s); peak device "
        f"memory {peak / 2 ** 30:.2f} GiB; launches in the main path "
        f"{launches}")
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / steps,
                peak_bytes=peak, launches=launches, params=p, cfg=cfg,
                batch=batch, cache=cache, tok=tok, cur_len=cur_len - 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _trace(fn):
    """Run ``fn`` once under torch.profiler. Returns (device ms by region,
    kernels launched, device ms busy in kernels, wall ms, the kernels).

    A region's ``record_function`` range appears on the device as an
    annotation spanning its kernels, from the first one's start to the
    last one's end (idle gaps inside included); those annotations are
    the by-region times, and they are kept out of the kernel sums."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.regions import registry
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    names = set(registry.names)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    spans = {e.key: e.self_device_time_total / 1e3 for e in dev
             if e.key in names}
    kern = [e for e in dev if e.key not in names]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return spans, sum(e.count for e in kern), busy_ms, wall_ms, kern


def model_breakdown(m):
    """Where the model path's device time goes, from torch.profiler traces
    of one flash prefill and one decode step: device ms by region (attn
    holds ln1, the q/k/v/o projections, qk-norm, rope, the flash kernel
    and the cache write; ffn holds ln2 and the MLP), kernels launched,
    and the device's busy share. Measures only; checks nothing; a trace
    with no device events is reported as not measured."""
    from repro_torch.models import model as M
    p, cfg, batch = m["params"], m["cfg"], m["batch"]
    spans, n_kern, busy, wall, kern = _trace(
        lambda: M.prefill(p, cfg, batch, MODEL_MAX_LEN, attn_impl="flash"))
    if busy <= 0:
        log("model breakdown: device time not measured (the profiler saw "
            "no device events)")
        return None
    flash = sum(e.self_device_time_total for e in kern
                if "fa_wgmma_kernel" in e.key or "fa_fwd_kernel" in e.key
                ) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log("model breakdown, one flash prefill: device ms by region "
        + ", ".join(f"{r} {spans.get(r, 0.0):.3f}" for r in MODEL_REGIONS)
        + f" (sum {sum(spans.get(r, 0.0) for r in MODEL_REGIONS):.3f}); "
        f"{n_kern} kernels, device busy {busy:.3f} ms of {wall:.3f} ms "
        f"profiled wall (busy share {busy / wall:.3f}); flash kernel "
        f"{flash:.3f} ms; top kernels: "
        + "; ".join(f"{e.key[:48]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms" for e in top))
    spans_d, n_kern_d, busy_d, wall_d, _ = _trace(
        lambda: M.decode_step(p, cfg, m["tok"], m["cache"], m["cur_len"]))
    log(f"model breakdown, one decode step (B={MODEL_BATCH}, cache "
        f"{MODEL_MAX_LEN}): {n_kern_d} kernels, device busy {busy_d:.3f} "
        f"ms of {wall_d:.3f} ms profiled wall (busy share "
        f"{busy_d / wall_d:.3f}); device ms by region "
        + ", ".join(f"{r} {v:.3f}" for r, v in sorted(spans_d.items())))
    return dict(prefill_region_ms=spans, prefill_busy_ms=busy,
                flash_ms=flash, decode_kernels=n_kern_d,
                decode_busy_ms=busy_d)


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
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    names = ["sample_attr", "flash_attention", "rmsnorm", "stream_marker"]
    t0 = time.perf_counter()
    _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(_build.NVCC_FLAGS)})")

    dev = torch.device("cuda")
    # The main path runs before any torch.profiler session: a process that
    # has traced the device pays more host time per launch afterwards, and
    # the chunk loop is launch-bound (PERF.md).
    clock_phase()
    parity_phase()
    combo_parity_phase()
    t0 = time.perf_counter()
    tl = full_timeline()
    log(f"full: timeline of {len(tl.names)} regions, {len(tl.region_ids)} "
        f"intervals, {tl.num_domains} rails, t_exec={tl.t_exec:.3f} s "
        f"(synthesized in {time.perf_counter() - t0:.1f} s)")
    full = full_phase(tl)
    combo = combo_full_phase(tl)
    exchange_phase(full.pop("agg"), combo.pop("agg"), smi)
    host_seam_phase()
    host_session_phase(dev)
    kernel_phase(dev)
    flash_row = flash_phase(dev)
    rmsnorm_row = rmsnorm_phase(dev)
    fold = breakdown_phase(tl)
    combo_fold = combo_fold_phase(combo)
    del tl, combo["chunk"]
    model = model_phase(dev)
    model_breakdown(model)
    for k in ("params", "cache"):
        del model[k]

    split = fold.pop("split_ms")
    combo_fold.pop("split_ms")
    fold_check = (f"counts equal, sums rtol {KERNEL_RTOL}, bitwise "
                  f"repeatable, bitwise equal to sample_attr_fold_emulated")
    region_path = dict(
        launches=full["launches"], **fold,
        path="region path: the full run's chunk k=700 (c=65536, R=4096, "
             "C=4)", check=fold_check)
    combo_path = dict(
        launches=combo["launches"], **combo_fold,
        path=f"combination path: combo-full's steady chunk (c=65536, "
             f"W={COMBO_WORKERS}, R=capacity {combo['cap']}, C=4)",
        check=fold_check)
    kernels = [dict(
        name="sample_attr", route="cuda",
        source="src/repro_torch/kernels/sample_attr/sample_attr.cu",
        replaces="src/repro/kernels/sample_attr/sample_attr.py:80",
        **region_path, paths=[region_path, combo_path]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:89",
             launches=model["launches"]["flash_attention"], **flash_row,
             path=f"{MODEL_ARCH} prefill (one launch per layer); timed at "
                  f"B=4 H=16 KV=8 S=2048 dh=128 bf16 causal"),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:35",
             launches=model["launches"]["rmsnorm"], **rmsnorm_row,
             path="not on the model path: the models normalise with "
                  "layers.rmsnorm, as the reference's do; timed at "
                  "[8192, 2048] bf16")]
    log(f"kernel share of the full run: "
        f"{full['launches'] * fold['ms'] / 1e3 / full['seconds']:.4f} "
        f"(launches x {fold['timing']} of the fold on the full run's chunk "
        f"/ run seconds; per kernel: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(split.items()))
        + ")")
    log(f"kernel share of the combo-full run: "
        f"{combo['launches'] * combo_fold['ms'] / 1e3 / combo['seconds']:.4f}"
        f" (launches x {combo_fold['timing']} of the fold on its steady "
        f"chunk / run seconds)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
