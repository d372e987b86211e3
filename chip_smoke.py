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
   energy   — the paper's §7 use case (``examples/torch/energy_tuning.py``
              at its defaults, priced at ``core.hardware.H100_SXM``):
              yi-6b's train_4k step on 8 chips, 150 steps synthesized,
              the one-shot profile, then the device pipeline on the card
              (``sample_attr``, counters set to 0 just before and read
              just after) against the same pipeline on the CPU at 10 ms
              (counts equal, sums rtol 1e-9), two card runs at 100 µs
              (instant sensor, jitter 20 µs; bitwise equal, samples/s),
              the energy-optimal plan over the card's six hotspots equal
              to the plan over the CPU's, and no more energy than the
              max-performance baseline; the joules are the activity
              model's, not measured;
   sharding — the distribution layer in an NCCL world of one (untraced):
              (a) ``qwen3-1.7b`` at full width and depth prefills B=4 ×
              2048 through the flash kernel under ``axis_rules`` on a
              1 × 1 mesh (parameters and batch DTensors, the kernel on
              each rank's local heads; launch counters set to 0 just
              before and read just after: 28 launches), logits against
              the unsharded prefill (bitwise expected at world 1), both
              prefills' ms; (b) ``launch/train.py --mesh 1x1`` at full
              size (4 steps) against the same run without ``--mesh``
              (losses and parameters), ms a step of both, and on the
              smoke config a sharded run's checkpoint restored into the
              unsharded launcher; (c) granite-moe-1b-a400m's ``moe_ffn``
              with ``experts`` on the one-rank ``model`` axis against
              the local dispatch; (d) ``pipeline_forward`` on a one-rank
              ``pipe`` axis against the sequential layers; (e) the dry
              run in a subprocess (a fake process group of 256 / 512
              ranks cannot share a process with NCCL): qwen3-1.7b × the
              four shapes on 16 × 16, one 2 × 16 × 16 cell, and a
              one-chip row at ``H100_SXM`` for (a)'s prefill shape,
              printed beside (a)'s ms; each cell's seconds;
4. kernel   — every kernel against its plain PyTorch version at the
              shapes its path gives it, at the stated tolerances:
              ``sample_attr`` on uniform ids (equal counts, sums to rtol,
              bitwise repeatable, bitwise equal to the emulation of its
              summation order), ``flash_attention`` (the model's prefill
              shape, dh 64 and 80, a ragged length, non-causal, float32,
              a transposed q as the model passes it, S=77, float16,
              bf16 at dh 32, and the later families' shapes: GQA group
              7 at dh 64, MHA at dh 80 non-causal, group 8 at dh 128,
              MHA 32/32 at dh 64; each with its route and TFLOP/s) and
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
              and ``sample_attr`` on a chunk of the energy phase's 100 µs
              run, held and timed alike (the kernel line's ``energy``
              path);
   combo-fold — ``sample_attr`` on combo-full's steady chunk at R = the
              table capacity, held and timed as in phase 4 (the kernel
              line's second ``sample_attr`` path), and kernels per chunk
              of the combination step;
6. model    — the dense-transformer path at full size:
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
              of one prefill, and beside it the cost model's
              (``roofline.cost_model``) predicted ms by region for that
              prefill under ``H100_SXM`` (printed, not checked);
7. serve    — the serving engine on the same model (bf16, random weights
              from seed 0): the launcher ``repro_torch.launch.serve``
              with its defaults (8 requests, 16 new tokens, 4 slots,
              launch counters set to 0 just before and read just after:
              the serving path launches none of the kernels), then the
              same traffic with a per-request ``PhaseEnergyAccountant``
              (no sample in a model-inner region, per-request energies
              partition the phases', a J/token quote), ragged batching
              against each request alone, kill and restore from a
              snapshot (bit-exact, bf16), and speculative decoding
              (token-exact to the baseline in float32; measured in bf16).
              Each kernel's entry of the kernels line carries its
              ``serve_launches``;
8. train    — training (``repro_torch.launch.train``): the launcher at
              full size with its defaults (B=8 × 512, bf16, remat
              "full", profiling at 5 ms), 8 steps, launch counters set to
              0 just before and read just after (the training path
              launches none of the kernels: none has a gradient); no
              sample or marker store in a step- or model-inner region
              (C7); the same steps on the card and on the CPU (reduced,
              float32, accum_steps 1 and 2, compression); kill and resume
              bit for bit; fused against plain CE at B=2 × 2048 (loss and
              peak memory); a gradient through the flash and rmsnorm
              kernels raises. Prints ms and loss a step, tokens/s and
              peak memory. Each kernel's entry carries its
              ``train_launches``;
9. the moe, vlm and audio families at full width, each path's flash
   launches counted as above (``moe_launches``, ``moe_serve_launches``,
   ``moe_train_launches``, ``moe30b_launches``, ``vlm_launches``,
   ``vlm_serve_launches``, ``audio_launches`` on every kernel's entry):
   granite-moe-1b-a400m (24 layers, 32 experts top-8) through phases 6-8
   (prefill + 32 decode steps, the step-1 check at capacity factor E/k;
   serve with every check; train with every check, card vs CPU counting
   the tokens whose expert choice rounds apart); qwen3-moe-30b-a3b at
   full width, depth cut to 8 of 48 layers (prefill + 8 decode steps);
   internvl2-1b (256 patch embeddings + 1 792 tokens: prefill + 32
   decode steps; the serve launcher; fused vs plain CE with patches at
   B=2 × 2048); hubert-xlarge (48 layers, non-causal: forward and
   loss_fn on B=4 × 2048 frame embeddings, flash vs full);
10. the recurrent families at full width and depth through phases 6-8
   (``hybrid_launches``, ``hybrid_serve_launches``,
   ``hybrid_train_launches``, ``xlstm_launches``,
   ``xlstm_serve_launches``, ``xlstm_train_launches``): zamba2-1.2b (38
   Mamba2 layers in 6 groups of 6 and a tail of 2, the weight-shared
   attention block after each group through the flash kernel: 6
   launches a prefill) and xlstm-125m (6 mLSTM + sLSTM pairs, no
   attention: 0 launches). Prefill + 32 decode steps held against the
   full-attention prefill and against a forward over the prompt and
   the decoded tokens; serve with every check, float32 speculation also
   with rejected drafts (the window-start checkpoint, its rollback and
   ``serve/replay`` run); train with every check (card vs CPU on a
   reduced zamba2 with a tail). The sLSTM scan is timed and traced
   alone;
11. examples — each of the four ``examples/torch/*.py`` as its own
   process on the card at its smallest documented size; a non-zero exit
   fails the run;
12. analysis — the contract auditor (``repro_torch.analysis``) on the
   card, after every timed phase: (a) its AST passes over this
   checkout's ``src/repro_torch`` against the committed baseline (no new
   finding, no stale key); (c) the recompile guard: each kernel library
   loaded once in the process, the engine's step-function caches one
   entry per configuration (and speculation window) the script served,
   and three requests of 5, 9 and 17 prompt tokens adding no rotary
   entry after the first step; (b) the 20 hot paths of the op audit on
   the card, each row printed beside the CPU budget's counts: the 12
   serve steps with 0 float64 ops, 0 widenings and 0 host waits, the
   region step and the miss fold with no host wait, the combination
   step with exactly one (its miss flag), every carry leaf in place, and
   ``sample_attr`` launched on every device-pipeline path.

Each phase's seconds are printed on a line of their own. The line
before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a GPU, or without the
rest of the repository beside it, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
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
def phase(name):
    """Print the block's seconds on a line of its own."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")


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
# The sharding phase: the distribution layer in an NCCL world of one.
# ---------------------------------------------------------------------------

SHARD_TRAIN_STEPS = 4
DRYRUN_CELLS = [("qwen3-1.7b", s, False) for s in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("qwen3-1.7b", "decode_32k", True)]
# The dry run's subprocess: the cells above priced at the reference's
# spec, then a one-chip row of the model phase's prefill at H100_SXM.
_DRYRUN_SCRIPT = """
import json, sys, time, warnings, logging
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch.dryrun import fake_world, lower_cell
from repro_torch.launch.mesh import make_mesh
cells, (B, S) = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for arch, shape, mp in cells:
    t0 = time.perf_counter()
    row, _ = lower_cell(arch, shape, multi_pod=mp)
    row["seconds"] = time.perf_counter() - t0
    print("DRYRUN " + json.dumps(row, default=str), flush=True)
SHAPES["chip_prefill"] = ShapeConfig("chip_prefill", S, B, "prefill")
fake_world(1)
t0 = time.perf_counter()
row, _ = lower_cell(cells[0][0], "chip_prefill", multi_pod=False,
                    mesh=make_mesh((1, 1), ("data", "model"), device="meta"),
                    hw=H100_SXM)
row["seconds"] = time.perf_counter() - t0
print("DRYRUN " + json.dumps(row, default=str), flush=True)
"""


def sharding_phase(dev):
    """The distribution layer on the card, in an NCCL world of one (set up
    here and torn down at the end). Runs untraced.

    (a) qwen3-1.7b at full width and depth (bf16, random weights from
        seed 0, B=4 × 2048, the model phase's inputs) prefills through
        ``attn_impl="flash"`` under ``axis_rules(build_rules(...))`` on a
        1 × 1 ("data", "model") mesh: parameters and batch are DTensors
        placed by ``param_specs`` / ``batch_specs``, the flash kernel
        runs on each rank's local heads (``local_map``). Launch counters
        set to 0 just before the sharded prefill and read just after: 28
        flash launches, nothing else. Its logits against the unsharded
        prefill's: bitwise expected (one rank runs the same kernels on
        the same tensors); otherwise within ``MODEL_REL_TOL``. Both
        prefills' ms.
    (b) ``launch/train.py --arch qwen3-1.7b --mesh 1x1 --steps 4
        --no-profile`` in process against the same run without
        ``--mesh``: losses and final parameters equal (bitwise expected;
        otherwise losses within rel 1e-6 and parameters within the
        train phase's atol 1e-2·lr); ms a step of both (DTensor's host
        cost). A checkpoint at full size would write 24 GB, so the
        restore check runs on the smoke config: a sharded run's
        checkpoint (whole tensors) restores into the unsharded launcher
        bit for bit.
    (c) granite-moe-1b-a400m's ``moe_ffn`` (one layer's experts at full
        width, B=4 × 2048 bf16 tokens) with ``experts`` on the one-rank
        ``model`` axis against the local dispatch: bitwise.
    (d) ``pipeline_forward`` on a one-rank ``pipe`` axis against the
        sequential layers (L=8, D=16, B=12, M=6): bitwise.
    (e) the dry run in a subprocess (its fake process group cannot share
        a process with NCCL), each cell's row and seconds, and a
        one-chip row at ``H100_SXM`` for (a)'s prefill (its attention
        priced through the dry run's default ``"chunked"`` path: the
        flash kernel runs on no meta tensor) beside (a)'s ms.
    Returns the sharded prefill's launch counts."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.launch.dryrun import build_rules
    from repro_torch.launch.mesh import make_mesh, make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.pipeline import pipeline_forward
    from repro_torch.sharding.rules import axis_rules, make_rules
    from repro_torch.tree import tree_leaves

    check(not dist.is_initialized(), "sharding: no process group yet")
    B, S, T = MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN
    mesh = make_small_mesh(1, 1, device=dev)
    log(f"sharding: NCCL world of {dist.get_world_size()}, mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}")

    # (a) the sharded prefill.
    cfg = get_config(MODEL_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    p, n_params, _ = _draw(cfg, dev)
    batch = _model_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1),
                         dev)
    rules = build_rules(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
    for w in rules.warnings:
        log(f"sharding (a): rules warning: {w}")

    def plain():
        return M.prefill(p, cfg, batch, T, attn_impl="flash")[0]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    want, plain_ms = timed(plain)
    counters = launch_counters()
    with axis_rules(rules):
        pd = sp.distribute(p, sp.param_specs(p, rules), rules)
        bd = sp.distribute(batch, sp.batch_specs(batch, rules), rules)

        def sharded():
            return M.prefill(pd, cfg, bd, T, attn_impl="flash")[0]
        sharded()                                           # warm-up
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        got = sharded()
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        launches = {c.__name__: c.launches for c in counters}
        placements = str(got.placements)
        got = got.full_tensor()
        _, sharded_ms2 = timed(sharded)
    bitwise = torch.equal(got, want)
    rel = _max_rel(got, want)
    check(launches == {"sample_attr_fold": 0,
                       "flash_attention": cfg.n_layers, "rmsnorm": 0},
          f"sharding (a): launches in the sharded prefill {launches}")
    check(tuple(got.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "sharding (a): logits")
    check(bitwise or rel <= MODEL_REL_TOL,
          f"sharding (a): sharded vs unsharded logits {rel:.3e}")
    log(f"sharding (a): {MODEL_ARCH} {n_params} parameters, prefill B={B} "
        f"S={S} flash under axis_rules on 1x1: logits {placements}, "
        + ("bitwise equal to the unsharded prefill" if bitwise else
           f"{rel:.3e} of max |logit| from the unsharded prefill (not "
           f"bitwise)")
        + f"; sharded prefill {sharded_ms:.2f} / {sharded_ms2:.2f} ms, "
        f"unsharded {plain_ms:.2f} ms; launches {launches}")
    del p, pd, batch, bd, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) sharded training against unsharded.
    import signal
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    lr = 3e-4
    argv = ["--arch", MODEL_ARCH, "--steps", str(SHARD_TRAIN_STEPS),
            "--no-profile", "--log-every", "1"]
    with tempfile.TemporaryDirectory() as ckdir:
        plain_res, _, tp = launcher.main(argv + ["--ckpt-dir", ckdir])
        want_p = [t.detach() for t in tree_leaves(tp.state["params"])]
        del tp
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckdir:
        shard_res, _, ts = launcher.main(argv + ["--ckpt-dir", ckdir,
                                                 "--mesh", "1x1"])
        leaves = tree_leaves(ts.state["params"])
        check(all(hasattr(t, "placements") for t in leaves),
              "sharding (b): the sharded state is DTensors")
        diffs = []
        for t, w in zip(leaves, want_p):
            diffs.append(float((t.full_tensor().detach() - w).abs().max()))
        del ts, leaves, want_p
        torch.cuda.empty_cache()
    pl = [m["loss"] for m in plain_res["metrics"]]
    sl = [m["loss"] for m in shard_res["metrics"]]
    pms = [m["step_time_s"] * 1e3 for m in plain_res["metrics"]]
    sms = [m["step_time_s"] * 1e3 for m in shard_res["metrics"]]
    same = pl == sl and max(diffs) == 0.0
    check(len(sl) == SHARD_TRAIN_STEPS and all(np.isfinite(sl)),
          f"sharding (b): losses {sl}")
    check(same or (all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(sl, pl))
                   and max(diffs) <= 1e-2 * lr),
          f"sharding (b): sharded losses {sl} vs {pl}, parameters max "
          f"|d| {max(diffs):.3e}")
    with tempfile.TemporaryDirectory() as ckdir:
        smoke = ["--arch", MODEL_ARCH, "--smoke", "--steps", "10",
                 "--no-profile", "--ckpt-dir", ckdir]
        _, _, ts = launcher.main(smoke + ["--mesh", "1x1"])
        saved = [t.full_tensor().detach() if hasattr(t, "full_tensor")
                 else t for t in tree_leaves(ts.state)]
        check(ckpt.latest_step(ckdir) == 10, "sharding (b): the sharded "
              "smoke run's checkpoint at step 10")
        del ts
        _, _, tr = launcher.main(smoke)
        restored = tree_leaves(tr.state)
        check(tr.step == 10 and len(restored) == len(saved) and all(
            torch.equal(a, b) for a, b in zip(restored, saved)),
            "sharding (b): the sharded checkpoint restores into the "
            "unsharded launcher bit for bit")
        del tr, restored, saved
    log(f"sharding (b): launcher --mesh 1x1, {SHARD_TRAIN_STEPS} steps at "
        f"full size: losses " + " ".join(f"{x:.6f}" for x in sl)
        + (" equal to the unsharded run's, parameters bitwise equal"
           if same else f" vs unsharded " + " ".join(f"{x:.6f}" for x in pl)
           + f", parameters max |d| {max(diffs):.3e} (not bitwise)")
        + "; ms a step sharded " + " ".join(f"{x:.1f}" for x in sms)
        + ", unsharded " + " ".join(f"{x:.1f}" for x in pms)
        + "; smoke: the sharded checkpoint restored into the unsharded "
        "launcher bit for bit")
    signal.signal(signal.SIGTERM, prev_sigterm)
    torch.cuda.empty_cache()

    # (c) expert parallelism on the one-rank model axis.
    mcfg = get_config(MOE_ARCH).replace(compute_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(2)
    mp_ = MoE.moe_init(g, mcfg)
    x = torch.randn(B, S, mcfg.d_model, generator=g, device=dev,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        local, _ = MoE.moe_ffn(mp_, mcfg, x)
        erules = make_rules(mesh)
        with axis_rules(erules):
            specs = sp.param_specs({"blocks": [{"moe": mp_}]}, erules)
            mpd = sp.distribute(mp_, specs["blocks"][0]["moe"], erules)
            xd = sp.distribute({"x": x}, sp.batch_specs({"x": x}, erules),
                               erules)["x"]
            ep, _ = MoE.moe_ffn(mpd, mcfg, xd)
            ep = ep.full_tensor()
    ep_bitwise = torch.equal(ep, local)
    check(ep_bitwise or _max_rel(ep, local) <= 1e-3,
          f"sharding (c): expert-parallel vs local {_max_rel(ep, local):.3e}")
    log(f"sharding (c): {MOE_ARCH} moe_ffn ({mcfg.n_experts} experts, top "
        f"{mcfg.top_k}, B={B} S={S} bf16) with experts on the one-rank "
        f"model axis: "
        + ("bitwise equal to the local dispatch" if ep_bitwise else
           f"{_max_rel(ep, local):.3e} of max |y| from the local dispatch"))
    del mp_, mpd, x, xd, local, ep

    # (d) the pipeline at world 1.
    pmesh = make_mesh((1,), ("pipe",), device=dev)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(0.3 * rng.standard_normal((8, 16, 16),
                                                   np.float32)).to(dev)
    xp = torch.from_numpy(rng.standard_normal((12, 16), np.float32)).to(dev)

    def stage(ws, h):
        for wi in ws:
            h = torch.tanh(h @ wi)
        return h
    piped = pipeline_forward(stage, pmesh, axis="pipe", n_micro=6)(w, xp)
    check(torch.equal(piped, stage(w, xp)),
          "sharding (d): pipeline at world 1 vs sequential")
    log("sharding (d): pipeline_forward on a one-rank pipe axis (L=8 D=16 "
        "B=12 M=6) bitwise equal to the sequential layers")
    dist.destroy_process_group()

    # (e) the dry run in a subprocess.
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS),
         json.dumps([B, S])], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    check(res.returncode == 0, f"sharding (e): dry run failed: "
          f"{res.stderr[-2000:]}")
    rows = [json.loads(l[len("DRYRUN "):]) for l in res.stdout.splitlines()
            if l.startswith("DRYRUN ")]
    check(len(rows) == len(DRYRUN_CELLS) + 1, f"sharding (e): {len(rows)} "
          f"rows")
    for (arch, shape, mp), row in zip(DRYRUN_CELLS, rows):
        if "skipped" in row:
            log(f"sharding (e): dry run [SKIP] {arch} x {shape}: "
                f"{row['skipped']} ({row['seconds']:.2f} s)")
            continue
        check(row["flops_per_device"] > 0, f"sharding (e): {arch} {shape}")
        log(f"sharding (e): dry run [OK] {arch} x {shape} mesh={row['mesh']}"
            f" in {row['seconds']:.2f} s: flops/device "
            f"{row['flops_per_device']:.4e}, hbm bytes/device (unfused, "
            f"upper) {row['hbm_bytes_per_device']:.4e}, collective "
            f"bytes/device {row['coll_bytes_per_device']:.4e} "
            f"{row['collective_counts']}, bytes/device "
            f"{row['bytes_per_device']:.4e}; at the reference's TPU_V5E "
            f"spec compute {row['t_compute_s'] * 1e3:.2f} ms, memory "
            f"{row['t_memory_s'] * 1e3:.2f} ms, collective "
            f"{row['t_collective_s'] * 1e3:.2f} ms ({row['dominant']}); "
            f"warnings {row['warnings']}")
    one = rows[-1]
    bound = max(one["t_compute_s"], one["t_memory_s"]) * 1e3
    log(f"sharding (e): dry run one-chip row of (a)'s prefill (B={B} "
        f"S={S}, H100_SXM; attention through the dry run's default "
        f"\"chunked\" path, whose masked scores count S x S: the flash "
        f"kernel runs on no meta tensor) in {one['seconds']:.2f} s: flops "
        f"{one['flops_per_device']:.4e}, hbm bytes (unfused, upper) "
        f"{one['hbm_bytes_per_device']:.4e}: compute "
        f"{one['t_compute_s'] * 1e3:.3f} ms, memory "
        f"{one['t_memory_s'] * 1e3:.3f} ms, bound {bound:.3f} ms beside "
        f"(a)'s measured {sharded_ms:.2f} ms sharded, {plain_ms:.2f} ms "
        f"unsharded; dry run subprocess {time.perf_counter() - t0:.2f} s")
    return dict(launches=launches, prefill_ms=sharded_ms)


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
    from repro_torch.core.hardware import H100_FP64_PER_S, H100_SXM
    carry = touched * (1 + 2 * C) * 8
    nbytes = c * (4 + 8 * C + 1) + 2 * carry
    ops = c * (1 + 3 * C)
    t_bytes, t_ops = nbytes / H100_SXM.hbm_bandwidth, ops / H100_FP64_PER_S
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
    # The later families' prefill shapes, q transposed as the model
    # passes it: internvl2-1b (GQA group 7), hubert-xlarge (MHA at dh 80,
    # non-causal), qwen3-moe-30b-a3b (group 8 at dh 128; granite-moe's
    # 16/8 at dh 64 is "dh64" above), zamba2-1.2b (MHA at dh 64).
    ("gqa7", 4, 14, 2, 2048, 64, True, "bfloat16", "bshd"),
    ("mha80nc", 4, 16, 16, 2048, 80, False, "bfloat16", "bshd"),
    ("gqa8", 4, 32, 4, 2048, 128, True, "bfloat16", "bshd"),
    # zamba2-1.2b's weight-shared attention block: MHA 32/32 at dh 64.
    ("mha64", 4, 32, 32, 2048, 64, True, "bfloat16", "bshd"),
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
    from repro_torch.core.hardware import H100_SXM
    nbytes = (2 * B * H * S + 2 * B * KV * T) * dh * esize
    ops = flash_ops(B, H, S, T, dh, causal)
    t_bytes = nbytes / H100_SXM.hbm_bandwidth
    t_ops = ops / H100_SXM.peak_flops_bf16
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
    from repro_torch.core.hardware import H100_SXM
    return ((2 * n * d * esize + 4 * d) / H100_SXM.hbm_bandwidth * 1e3,
            "bytes")


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
    """Chunk ``k`` of a profiling run of ``tl`` on ``dev`` through the
    instant sensor (by default the full cell's run), as the main path
    folds it: ``ids`` [c] int32, ``pows`` [C, c] float64, ``valid`` [c]
    bool, with the run's clock and sensor state beside them."""

    def __init__(self, tl, dev, k=700, c=65536, period=None, jitter=None,
                 name="full"):
        import torch
        from repro_torch.core import device_pipeline as dp, sensors, threefry
        self.dtl = tl.to_device(device=dev)
        self.spec = sensors.InstantTraceSensor.make_spec(
            domains=tl.domain_names)
        self.k, self.c = k, c
        self.period = period or tl.t_exec / 102_000_000
        self.jitter = 0.2 * self.period if jitter is None else jitter
        self.root = threefry.PRNGKey(0)
        self.u0 = dp._phase(self.root, self.period)
        self.prev = torch.full((), -1.0, dtype=torch.float64, device=dev)
        rid_mat, self.pows, self.valid, _ = dp._chunk_samples(
            self.dtl, self.spec, self.root, self.u0, k, c, self.period,
            self.jitter, self.prev)
        self.ids = rid_mat[0]
        self.R = self.dtl.num_regions
        self.C = 1 if self.pows.ndim == 1 else self.pows.shape[0]
        ids = self.ids[self.valid].cpu().numpy()
        runs = 1 + int((ids[1:] != ids[:-1]).sum()) if ids.size else 0
        log(f"{name} chunk k={k}: {int(self.valid.sum())} of {c} lanes valid, "
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
# The §7 energy optimisation on the card (examples/torch/energy_tuning.py).
# ---------------------------------------------------------------------------

# energy_tuning's defaults: yi-6b's train_4k step on 8 chips, 150 steps.
ENERGY_ARCH, ENERGY_SHAPE, ENERGY_CHIPS, ENERGY_STEPS = (
    "yi-6b", "train_4k", 8, 150)
ENERGY_PERIOD = 10e-3
# The finer load: ~9·10^6 samples. The device clock needs jitter <= period
# (the default 200 µs would not do), and RAPL's 1 ms counter quantum is
# that sensor's floor, so this run reads the instant sensor.
ENERGY_FINE_PERIOD, ENERGY_FINE_JITTER = 100e-6, 20e-6


def _example(name):
    """``examples/torch/<name>.py`` as a module."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def energy_phase(dev):
    """``energy_tuning``'s path at its defaults under ``H100_SXM``: region
    costs, the synthesized timeline and the reference's one-shot profile;
    then the same timeline through the device pipeline on the card (the
    ``sample_attr`` kernel; launch counters set to 0 just before and read
    just after) and on the CPU (the plain path). Checks: (a) at 10 ms the
    card's counts equal the CPU's and the sums agree to
    ``PIPELINE_RTOL``; (b) at 100 µs two card runs are bitwise equal;
    (c) the energy-optimal plan over the card's six dominant regions is
    the plan over the CPU's six; (d) the plan spends no more energy than
    the max-performance baseline. Returns the launches and a chunk of
    the 100 µs run for the kernel line's ``energy`` row."""
    import numpy as np
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.core import EnergyProfiler, PowerModel, synthesize
    from repro_torch.core import device_pipeline as dp
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.roofline.cost_model import step_region_costs
    et = _example("energy_tuning")
    model = PowerModel(hw=H100_SXM)
    t0 = time.perf_counter()
    costs = step_region_costs(get_config(ENERGY_ARCH), SHAPES[ENERGY_SHAPE],
                              chips=ENERGY_CHIPS)
    tl = synthesize(costs, steps=ENERGY_STEPS, chips=ENERGY_CHIPS,
                    model=model, seed=0)
    one = EnergyProfiler(period=ENERGY_PERIOD, device=dev).profile_timeline(
        tl, sensor="rapl")
    log(f"energy: {ENERGY_ARCH} x {ENERGY_SHAPE} x {ENERGY_CHIPS} chips x "
        f"{ENERGY_STEPS} steps under {H100_SXM.name}: {len(tl.names)} "
        f"regions, {len(tl.region_ids)} intervals, t_exec={tl.t_exec:.3f} s; "
        f"one-shot profile {one.n_total} samples "
        f"({time.perf_counter() - t0:.2f} s with the synthesis)")

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    with captured_aggregators() as card_aggs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = EnergyProfiler(period=ENERGY_PERIOD, device=dev
                              ).profile_timeline_streaming(
            tl, sensor="rapl", pipeline="device")
        secs = time.perf_counter() - t0
    coarse = {c.__name__: c.launches for c in counters}
    with captured_aggregators() as cpu_aggs:
        cpu = EnergyProfiler(period=ENERGY_PERIOD, device="cpu"
                             ).profile_timeline_streaming(
            tl, sensor="rapl", pipeline="device")
    chunks = dp.num_chunks(tl.t_exec, ENERGY_PERIOD, 65536)
    check(coarse["sample_attr_fold"] == chunks,
          f"energy (a): sample_attr launches {coarse['sample_attr_fold']} "
          f"== chunks {chunks}")
    check(card.n_total == cpu.n_total, "energy (a): n")
    got = card_aggs[0].channel_statistics()
    want = cpu_aggs[0].channel_statistics()
    check(np.array_equal(got[0], want[0]), "energy (a): counts")
    check(all(np.allclose(g, w, rtol=PIPELINE_RTOL, atol=0.0)
              for g, w in zip(got[1:], want[1:])),
          f"energy (a): sums rtol {PIPELINE_RTOL}")
    log(f"energy (a): {card.n_total} samples at {ENERGY_PERIOD * 1e3:g} ms "
        f"(rapl) in {secs:.3f} s on the card, {chunks} chunks, "
        f"{coarse['sample_attr_fold']} sample_attr launches; counts equal to "
        f"the CPU's, sums rtol {PIPELINE_RTOL}")

    fine = EnergyProfiler(period=ENERGY_FINE_PERIOD,
                          jitter=ENERGY_FINE_JITTER, device=dev)
    fine_chunks = dp.num_chunks(tl.t_exec, ENERGY_FINE_PERIOD, 65536)
    runs = []
    for _ in range(2):
        for c in counters:
            c.launches = 0
        with captured_aggregators() as aggs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = fine.profile_timeline_streaming(tl, sensor="instant",
                                                  pipeline="device")
            s = time.perf_counter() - t0
        runs.append(dict(n=est.n_total, seconds=s, agg=aggs[0],
                         launches={c.__name__: c.launches
                                   for c in counters}))
    check(all(r["launches"]["sample_attr_fold"] == fine_chunks for r in runs),
          f"energy (b): sample_attr launches == chunks {fine_chunks}")
    check(_agg_bits_equal(runs[0]["agg"], runs[1]["agg"]),
          "energy (b): two card runs bitwise equal")
    log(f"energy (b): {runs[0]['n']} samples at "
        f"{ENERGY_FINE_PERIOD * 1e6:g} µs (instant, jitter "
        f"{ENERGY_FINE_JITTER * 1e6:g} µs), {fine_chunks} chunks a run; two "
        f"card runs bitwise equal; "
        + ", ".join(f"{r['seconds']:.3f} s ({r['n'] / r['seconds']:.4e} "
                    f"samples/s)" for r in runs))

    kw = dict(chips=ENERGY_CHIPS, objective="energy", model=model)
    base, plan = et.plan_hotspots(costs, card, **kw)
    base_cpu, plan_cpu = et.plan_hotspots(costs, cpu, **kw)
    log(f"energy hotspots: card {[r.name for r in card.dominant(6)]}; CPU "
        f"{[r.name for r in cpu.dominant(6)]}; one-shot "
        f"{[r.name for r in one.dominant(6)]}")
    check(plan == plan_cpu and base == base_cpu,
          "energy (c): the card's plan is the CPU's")
    check(plan.energy <= base.energy, "energy (d): plan <= baseline energy")
    log("energy baseline (max perf):\n" + base.table())
    log("energy energy-optimal per-region plan:\n" + plan.table())
    log(f"energy (c), (d): plans equal; whole-hotspot energy saving "
        f"{(1 - plan.energy / base.energy) * 100:.2f}%, time "
        f"{(plan.time / base.time - 1) * 100:+.2f}% ({et.MODEL_NOTE}; "
        f"priced at {H100_SXM.name}'s peaks)")

    chunk = FullChunk(tl, dev, k=fine_chunks // 2, period=ENERGY_FINE_PERIOD,
                      jitter=ENERGY_FINE_JITTER, name="energy")
    launches = {name: coarse[name] + sum(r["launches"][name] for r in runs)
                for name in coarse}
    check(launches["flash_attention"] == launches["rmsnorm"] == 0,
          f"energy: other kernels launched {launches}")
    return dict(launches=launches, chunk=chunk,
                path=f"energy path: {ENERGY_ARCH} x {ENERGY_SHAPE} timeline "
                     f"({len(tl.names)} regions), "
                     f"{coarse['sample_attr_fold']} launches at "
                     f"{ENERGY_PERIOD * 1e3:g} ms + 2 x {fine_chunks} at "
                     f"{ENERGY_FINE_PERIOD * 1e6:g} µs; timed on chunk "
                     f"k={chunk.k} of the 100 µs run (c=65536, "
                     f"R={chunk.R}, C={chunk.C})")


def cost_model_line(m, spans):
    """The cost model's per-region prefill time under ``H100_SXM``
    (``step_region_costs`` at ``ShapeConfig(kind="prefill")``, each
    region's invocations × ``PowerModel.region_duration`` at its default
    efficiency) beside the device ms by region the model breakdown
    measured; ``attn_qkv``, ``attn_score`` and ``attn_out`` sum onto the
    model's ``attn``. Printed only, not checked."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import PowerModel
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.roofline.cost_model import step_region_costs
    pm = PowerModel(hw=H100_SXM)
    shape = ShapeConfig("prefill", MODEL_PROMPT, MODEL_BATCH, "prefill")
    pred = {}
    for c in step_region_costs(m["cfg"], shape, chips=1):
        r = "attn" if c.name.startswith("attn_") else c.name
        pred[r] = pred.get(r, 0.0) + c.invocations * pm.region_duration(
            c.flops, c.hbm_bytes, c.ici_bytes) * 1e3
    log(f"cost model vs card, {m['cfg'].name} prefill B={MODEL_BATCH} x "
        f"{MODEL_PROMPT} under {H100_SXM.name} (predicted ms / measured "
        f"device ms; printed, not checked): "
        + ", ".join(f"{r} {ms:.3f} / "
                    + (f"{spans[r]:.3f}" if r in spans else "not measured")
                    for r, ms in pred.items())
        + f" (sum {sum(pred.values()):.3f} / "
        f"{sum(spans.get(r, 0.0) for r in pred):.3f})")


# smallest documented size of each example; train_lm's --ckpt-dir is added
EXAMPLES = (("quickstart", ["--steps", "5"]),
            ("train_lm", ["--smoke"]),
            ("serve_demo", ["--requests", "2", "--new-tokens", "16"]),
            ("energy_tuning", []))


def examples_phase():
    """Each of the port's four examples as its own process, on the card
    (their default device), at its smallest documented size; a non-zero
    exit fails the run. Prints each one's seconds and last line."""
    import shutil
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        for name, args in EXAMPLES:
            if name == "train_lm":
                args = args + ["--ckpt-dir", ckpt]
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples", "torch",
                                              f"{name}.py"), *args],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            secs = time.perf_counter() - t0
            if res.returncode != 0:
                log(res.stdout[-4000:])
                log(res.stderr[-4000:])
            check(res.returncode == 0,
                  f"examples: {name} exited {res.returncode}")
            last = res.stdout.strip().splitlines()[-1]
            log(f"examples: {name} {' '.join(args)}: exit 0 in {secs:.2f} s;"
                f" last line: {last.strip()}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 12: the contract auditor on the card.
# ---------------------------------------------------------------------------

def record_served_keys():
    """From now on, the step-function keys of every ``Engine`` built:
    ``{"step": {cfg}, "spec": {(cfg, window, sinks)}}`` (one set add per
    engine, nothing per step)."""
    from repro_torch.serve.engine import Engine
    keys = {"step": set(), "spec": set()}
    orig = Engine.__init__

    def init(self, cfg, params, serve_cfg, *args, **kw):
        orig(self, cfg, params, serve_cfg, *args, **kw)
        keys["step"].add(cfg)
        if serve_cfg.spec_len:
            keys["spec"].add((cfg, serve_cfg.spec_window,
                              serve_cfg.spec_sinks))

    Engine.__init__ = init
    return keys


def recompile_guard(dev, served):
    """(c) One key, one cache entry, on the card after every other phase:
    each kernel library loaded once in this process; the engine's step
    function caches hold one entry per (config[, window, sinks]) served;
    then three staggered requests of different prompt lengths on a
    reduced config add one step-function entry and no rotary one after
    the first step, and ``_rope_freqs`` hits its (d_head, theta, device)
    key."""
    import numpy as np
    import torch
    from repro_torch.analysis.op_audit import jit_cache_size
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.sample_attr import ops as sops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                          _spec_step_fns, _step_fns)
    for name, mod in (("sample_attr", sops), ("flash_attention", fops),
                      ("rmsnorm", rops)):
        info = mod._kernel.cache_info()
        log(f"analysis (c): {name} library loads: {info.misses} "
            f"(calls {info.hits + info.misses})")
        check(info.misses == 1 and info.currsize == 1,
              f"analysis (c): {name} loaded {info.misses} times")
    for fns, key in ((_step_fns, "step"), (_spec_step_fns, "spec")):
        log(f"analysis (c): {fns.__name__}: {jit_cache_size(fns)} entries "
            f"for {len(served[key])} keys served")
        check(jit_cache_size(fns) == len(served[key]),
              f"analysis (c): {fns.__name__} holds {jit_cache_size(fns)} "
              f"entries for {len(served[key])} keys")
    cfg = get_config(MODEL_ARCH).reduced()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    steps0, rope0 = jit_cache_size(_step_fns), L._rope_freqs.cache_info()
    eng = Engine(cfg, params, ServeConfig(max_batch=3, max_len=64,
                                          eos_token=-1), device=dev)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate((5, 9, 17))]
    eng.add_request(reqs[0])
    eng.step()
    rope1 = L._rope_freqs.cache_info()
    for r in reqs[1:]:
        eng.add_request(r)
    for _ in range(40):
        eng.step()
        if all(r is None for r in eng.slot_req):
            break
    check(all(r.done for r in reqs), "analysis (c): probe requests")
    rope2 = L._rope_freqs.cache_info()
    check(jit_cache_size(_step_fns) == steps0 + 1,
          "analysis (c): the probe config's step functions built twice")
    check(rope2.currsize == rope1.currsize and rope2.hits > rope1.hits,
          f"analysis (c): rotary frequencies grew across prompt lengths "
          f"({rope1.currsize} -> {rope2.currsize})")
    L._rope_freqs(cfg.head_dim, cfg.rope_theta, torch.device(dev.type, 0))
    check(L._rope_freqs.cache_info().misses == rope2.misses,
          "analysis (c): the rotary key is not (d_head, theta, device)")
    log(f"analysis (c): prompts of 5, 9 and 17 tokens: step functions "
        f"{steps0} -> {jit_cache_size(_step_fns)}, rotary entries "
        f"{rope0.currsize} -> {rope1.currsize} after the first step -> "
        f"{rope2.currsize} after the rest ({rope2.hits - rope1.hits} hits)")


def analysis_phase(dev, served):
    """(a) the auditor's layer 1 over this checkout; (c) the recompile
    guard (before (b), whose serve audits add their reduced configs to
    the step caches); (b) the 20 hot paths on the card under the
    auditor's dispatch mode, each row printed beside the committed CPU
    budget's counts (not compared: on the card the fold is a ctypes
    kernel the mode does not see), with the contracts that carry over
    checked absolutely."""
    from repro_torch.analysis import BUDGET_PATH, run_audit, scan_repo
    from repro_torch.analysis import baseline as bl
    from repro_torch.analysis.op_audit import audit_hot_paths
    res = run_audit(op_audit=False)
    log(f"analysis (a): layer 1 over {len(scan_repo())} files: "
        f"{len(res.findings)} findings, {len(res.ratchet.new)} new, "
        f"{len(res.ratchet.stale_keys)} stale baseline keys")
    check(res.ratchet.ok and not res.ratchet.stale_keys,
          "analysis (a): " + "; ".join(f.render() for f in res.ratchet.new))
    recompile_guard(dev, served)
    budget = bl.load_budget(BUDGET_PATH)
    reports = audit_hot_paths(device=dev)
    check(sorted(r.name for r in reports) == sorted(budget),
          "analysis (b): hot paths differ from the budget's")
    for r in reports:
        b = budget[r.name]
        log(f"analysis (b): {r.render()} | CPU budget {b['f64_ops']} f64 "
            f"ops, {b['f64_widenings']} widenings, {b['host_callbacks']} "
            f"host waits")
        check(r.donated_aliased == r.donated_expected,
              f"analysis (b): {r.name}: carry in place "
              f"{r.donated_aliased}/{r.donated_expected}")
        if r.name.startswith("serve/"):
            check((r.f64_ops, r.f64_widenings, r.host_callbacks)
                  == (0, 0, 0), f"analysis (b): {r.render()}")
        if r.name.startswith("device_pipeline/"):
            check(r.donated_expected == 4, f"analysis (b): {r.render()}")
            check(r.launches.get("sample_attr_fold", 0) >= 1,
                  f"analysis (b): {r.name} did not launch sample_attr")
        if "/region_run/" in r.name or "/combo_fold/" in r.name:
            check(r.host_callbacks == 0, f"analysis (b): {r.render()}")
        if "/combo_step/" in r.name:
            check(r.callback_prims == ("_local_scalar_dense",),
                  f"analysis (b): {r.render()}")


# ---------------------------------------------------------------------------
# Phase 6: the model paths at full width.
# ---------------------------------------------------------------------------

MODEL_ARCH = "qwen3-1.7b"
MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_DECODE = 4, 2048, 2080, 32
# The recurrent regions, model-inner in serving and training as the rest.
RECURRENT_REGIONS = ("ssm_proj", "ssm_scan", "ssm_out", "ssm_decode",
                     "mlstm_scan", "slstm_scan", "mlstm_decode",
                     "shared_attn")
MODEL_REGIONS = (("embed", "attn", "ffn", "moe_router", "moe_ffn")
                 + RECURRENT_REGIONS + ("lm_head",))
# The later slices' families, each at full width: granite-moe at full
# depth; qwen3-moe's 48 layers cut to 8 (its ~3·10^10 parameters are 58 GB
# in bf16 before the float32 draw they are cast from); internvl2 with its
# stub ViT's 256 patch embeddings ahead of 1 792 tokens; hubert (an
# encoder) forward and loss only.
MOE_ARCH, MOE30_ARCH, VLM_ARCH, AUDIO_ARCH = (
    "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "internvl2-1b",
    "hubert-xlarge")
MOE30_DEPTH, MOE30_DECODE = 8, 8
VLM_PATCHES = 256


def _max_rel(a, b):
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def _model_batch(cfg, B, S, g, dev, patches=0):
    """Random inputs of S positions: ``patches`` patch embeddings (0.1 ·
    normal, the stub ViT's output) ahead of S - patches tokens, or frame
    embeddings for an encoder with precomputed inputs."""
    import torch
    if cfg.embed_inputs:
        return {"embeds": torch.randn(B, S, cfg.d_model, generator=g,
                                      device=dev)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - patches),
                                     generator=g, device=dev)}
    if patches:
        batch["patch_embeds"] = 0.1 * torch.randn(
            B, patches, cfg.d_model, generator=g, device=dev)
    return batch


def _draw(cfg, dev, seed=0):
    """Random float32 master weights from ``seed``, held as a copy in the
    compute dtype; returns (params, count, seconds)."""
    import torch
    from repro_torch.models import model as M
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    master = M.init_params(g, cfg, device=dev)
    p = M.cast_params(master, cfg)
    del master
    torch.cuda.synchronize()
    return p, sum(t.numel() for t in _leaves(p)), time.perf_counter() - t0


def model_phase(dev, arch=MODEL_ARCH, *, depth=None, steps=MODEL_DECODE,
                patches=0):
    """``prefill`` + ``steps`` greedy ``decode_step``s of ``arch`` at full
    width (full depth unless ``depth`` cuts it; bf16 compute, random
    float32 master weights from a seeded generator, held as a bf16 copy;
    B=4 × 2048 positions, for a VLM ``patches`` of them patch
    embeddings). The launch counters are set to 0 just before the main
    path (prefill and decode) and read just after.

    Checks: one flash launch per layer in the prefill and none in decode;
    finite outputs of the expected shapes; the flash prefill's
    last-position logits and its cache within ``MODEL_REL_TOL`` of
    max |.| of the same prefill through ``attn_impl="full"`` (layer 0's
    K/V, computed before any attention, bitwise equal); unless ``steps``
    is cut below ``MODEL_DECODE``, the first decode step's logits within
    the same share of a prefill of the prompt plus that token. A MoE
    model prefills through the capacity gather, which keeps or drops a
    token at an expert's capacity boundary by rounding (two attention
    paths may drop different tokens), and decodes dropless: its checks
    run on prefills at capacity factor E/k, where the gather drops
    nothing (as ``tests/test_arch_smoke.py::test_decode_matches_forward``
    sets it), and the flash-vs-full difference at the config's factor
    is printed, not checked. Its router chooses among near-equal experts
    by rounding too, so each compared run replays the expert choices of
    the run it is compared with (:class:`_Routes`) and the tokens whose
    own choice would have parted are counted.
    The tolerance: the reference's own kernel-vs-plain bf16 spread is
    1.0% of max |logit| through 2 layers (0.031 at 3.06); the two
    attention paths round differently (the kernel rounds p to bf16 per
    128-key tile before its online rescale, the plain path rounds the
    normalised probabilities), and the difference compounds through the
    layers, so 5% is allowed.
    Returns the measurements and the path's launch counts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    B, S, T = MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p, n_params, draw_s = _draw(cfg, dev)
    moe = cfg.family == "moe"
    cut = (f", depth cut to {depth} of {get_config(arch).n_layers} layers"
           if depth is not None else "")
    log(f"model: {arch} {cfg.family} {cfg.n_layers} layers{cut} "
        f"d_model={cfg.d_model} H={cfg.n_heads} KV={cfg.n_kv_heads} "
        f"dh={cfg.head_dim} "
        + (f"experts={cfg.n_experts} top_k={cfg.top_k} moe_d_ff="
           f"{cfg.moe_d_ff} capacity_factor={cfg.capacity_factor} "
           if moe else f"d_ff={cfg.d_ff} ")
        + f"vocab={cfg.vocab_size}: {n_params} parameters drawn and cast "
        f"to bf16 in {draw_s:.2f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = _model_batch(cfg, B, S, g, dev, patches)

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
          f"model {arch}: flash launches per prefill {after_prefill} == "
          f"{cfg.n_layers}")
    check(launches == {"sample_attr_fold": 0, "flash_attention": cfg.n_layers,
                       "rmsnorm": 0},
          f"model {arch}: launches in prefill + decode {launches}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"model {arch}: prefill logits")
    check(tuple(step_logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(step_logits).all()),
          f"model {arch}: decode logits")
    check(int(cur_len[0]) == S + steps, f"model {arch}: cur_len after decode")

    # The checks. A MoE model's capacity gather keeps or drops a token at
    # an expert's capacity boundary by rounding, so two attention paths
    # can drop different tokens: at the config's capacity factor the
    # difference is printed, and the checks run at E/k, where the gather
    # drops nothing. Its router, too, is discontinuous: where a token's
    # k-th and (k+1)-th experts are close, the two paths' rounding can
    # choose another expert, and that token's later hidden states differ
    # by an expert's output. So the compared run replays the flash run's
    # expert choices (weighted by its own probabilities) and the two
    # differ by their attention paths alone; the tokens whose own choice
    # parted are counted.
    cap_note = moved_note = ""
    ccfg, clogits, ccache = cfg, logits, cache
    if moe:
        full_logits, _, _ = M.prefill(p, cfg, batch, T, attn_impl="full")
        cap_note = (f"; at capacity factor {cfg.capacity_factor} (measured, "
                    f"not checked) {_max_rel(logits, full_logits):.4f}")
        del full_logits
        ccfg = cfg.replace(capacity_factor=float(cfg.n_experts / cfg.top_k))
        with _Routes() as fr:
            clogits, ccache, _ = M.prefill(p, ccfg, batch, T,
                                           attn_impl="flash")
        flash_routes = fr.choices(dev)
    with _Routes(replay=flash_routes if moe else []) as ur:
        full_logits, full_cache, _ = M.prefill(p, ccfg, batch, T,
                                               attn_impl="full")
    if moe:
        moved_note = (f"; the full path replays the flash path's expert "
                      f"choices: its own would part for {ur.note()}")
    rel = _max_rel(clogits, full_logits)
    check(rel <= MODEL_REL_TOL, f"model {arch}: flash vs full prefill "
          f"logits {rel:.4f} of max |logit|")
    l0 = ccache["blocks"][0]
    check(all(torch.equal(l0[k][:, :, :S], full_cache["blocks"][0][k][:, :, :S])
              for k in ("k", "v")), f"model {arch}: layer-0 cache bitwise "
          f"equal")
    cache_rel = max(_max_rel(c[k][:, :, :S], f[k][:, :, :S])
                    for c, f in zip(ccache["blocks"], full_cache["blocks"])
                    for k in ("k", "v"))
    check(cache_rel <= MODEL_REL_TOL, f"model {arch}: flash vs full prefill "
          f"cache {cache_rel:.4f} of max |.|")
    agree = (clogits[:, -1].argmax(-1) == full_logits[:, -1].argmax(-1)
             ).float().mean().item()
    del full_cache
    dec = ""
    if steps >= MODEL_DECODE:
        ext_routes = []
        if moe:
            tok0 = clogits[:, -1].argmax(-1, keepdim=True)
            with _Routes() as dr:
                logits0, _ = M.decode_step(
                    p, ccfg, tok0, ccache,
                    torch.full((B,), S, dtype=torch.int32, device=dev))
            k = cfg.top_k
            ext_routes = [torch.cat([a.view(B, S, k), b.view(B, 1, k)], 1)
                          .view(B * (S + 1), k)
                          for a, b in zip(flash_routes, dr.choices(dev))]
        else:
            tok0, logits0 = first
        ext = dict(batch, tokens=torch.cat([batch["tokens"], tok0], dim=1))
        with _Routes(replay=ext_routes) as er:
            ext_logits, _, _ = M.prefill(p, ccfg, ext, T, attn_impl="flash")
        dec_rel = _max_rel(logits0, ext_logits)
        check(dec_rel <= MODEL_REL_TOL,
              f"model {arch}: first decode step vs prefill of S+1 "
              f"positions {dec_rel:.4f} of max |logit|")
        dec = (f"; decode step 1 vs prefill of S+1 positions "
               f"{dec_rel:.4f}"
               + (f" (the prefill replays the flash prefill's and the "
                  f"decode step's expert choices; its own would part for "
                  f"{er.note()})" if moe else ""))
    del ccache
    log(f"model {arch}: flash vs full prefill"
        + (f" at capacity factor {ccfg.capacity_factor} (E/k: nothing "
           f"dropped)" if moe else "")
        + f": logits {rel:.4f} of max |logit| "
        f"({full_logits.float().abs().max().item():.3f}), cache "
        f"{cache_rel:.4f} of max |.|, layer-0 K/V bitwise equal, greedy "
        f"tokens agree on {agree:.2f} of rows (tolerance {MODEL_REL_TOL})"
        + moved_note + dec + cap_note)
    log(f"model {arch}: prefill B={B} S={S}"
        + (f" ({patches} patch embeddings + {S - patches} tokens)"
           if patches else "")
        + f" {prefill_s * 1e3:.2f} ms ({B * S / prefill_s:.1f} tokens/s), "
        f"{after_prefill} flash launches; decode {steps} steps "
        f"{decode_s * 1e3 / steps:.3f} ms per step ({B * steps / decode_s:.1f}"
        f" tokens/s); peak device memory {peak / 2 ** 30:.2f} GiB; launches "
        f"in the main path {launches}")
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / steps,
                peak_bytes=peak, launches=launches, params=p, cfg=cfg,
                batch=batch, cache=cache, tok=tok, cur_len=cur_len - 1)


def vlm_loss_phase(dev):
    """Fused against plain CE (:func:`fused_ce_check`) on full-width,
    full-depth internvl2-1b: float32 master weights from seed 0 that
    require grad, B=2 × 2048 positions, the first 256 of them patch
    embeddings (the loss covers the 1 792 text positions)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = get_config(VLM_ARCH)
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda t: t.requires_grad_(),
                      M.init_params(g, cfg, device=dev))
    batch = _model_batch(cfg, FUSED_CE_B, FUSED_CE_S, g, dev, VLM_PATCHES)
    batch["labels"] = torch.randint(0, cfg.vocab_size, batch["tokens"].shape,
                                    generator=g, device=dev)
    out = fused_ce_check(f"loss {VLM_ARCH}", params, cfg, batch)
    del params, batch
    torch.cuda.empty_cache()
    return out


AUDIO_LOSS_RTOL = 5e-3          # flash vs full loss, bf16, 48 layers


def audio_phase(dev):
    """The encoder path: full-width, full-depth hubert-xlarge (48 layers,
    d 1280, 16/16 heads, dh 80, non-causal, layer norm, gelu; bf16, random
    weights from seed 0) runs ``forward`` on B=4 × 2048 random frame
    embeddings through the flash kernel (launch counters set to 0 just
    before and read just after: 48 launches) against ``attn_impl="full"``
    (logits within ``MODEL_REL_TOL`` of max |logit|), and ``loss_fn`` with
    random unit labels through both paths (finite, within rel
    ``AUDIO_LOSS_RTOL``). Prints forward ms and peak memory."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    cfg = get_config(AUDIO_ARCH)
    B, S = MODEL_BATCH, MODEL_PROMPT
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p, n_params, draw_s = _draw(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = _model_batch(cfg, B, S, g, dev)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                    device=dev)
    with torch.no_grad():
        M.forward(p, cfg, batch, attn_impl="flash")             # warm-up
        torch.cuda.synchronize()
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        logits, aux = M.forward(p, cfg, batch, attn_impl="flash")
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
        full, _ = M.forward(p, cfg, batch, attn_impl="full")
        loss = {impl: float(M.loss_fn(p, cfg, batch, attn_impl=impl)[0])
                for impl in ("flash", "full")}
    check(launches == {"sample_attr_fold": 0, "flash_attention": cfg.n_layers,
                       "rmsnorm": 0}, f"audio: launches {launches}")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
          "audio: forward logits")
    rel = _max_rel(logits, full)
    check(rel <= MODEL_REL_TOL, f"audio: flash vs full logits {rel:.4f} of "
          f"max |logit|")
    lrel = abs(loss["flash"] - loss["full"]) / abs(loss["full"])
    check(all(map(lambda v: v == v and abs(v) < float("inf"),
                  loss.values())) and lrel <= AUDIO_LOSS_RTOL,
          f"audio: loss {loss} (rel {lrel:.2e})")
    log(f"model {AUDIO_ARCH}: audio encoder {cfg.n_layers} layers "
        f"d_model={cfg.d_model} H={cfg.n_heads} KV={cfg.n_kv_heads} "
        f"dh={cfg.head_dim} non-causal, {n_params} parameters drawn in "
        f"{draw_s:.2f} s; forward B={B} S={S} frame embeddings "
        f"{fwd_s * 1e3:.2f} ms ({B * S / fwd_s:.1f} frames/s), peak "
        f"{peak / 2 ** 30:.2f} GiB, launches {launches}; flash vs full "
        f"logits {rel:.4f} of max |logit| (tolerance {MODEL_REL_TOL}); "
        f"loss_fn with labels: flash {loss['flash']:.6f}, full "
        f"{loss['full']:.6f} (rel {lrel:.2e}, tolerance {AUDIO_LOSS_RTOL}; "
        f"ln V = {math.log(cfg.vocab_size):.4f})")
    del p, logits, full
    torch.cuda.empty_cache()
    return dict(forward_ms=fwd_s * 1e3, peak_bytes=peak, launches=launches)


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
    of one flash prefill (not for xlstm: its sLSTM loop is ~4·10^4
    launches a prefill, and ``slstm_breakdown`` traces that loop alone)
    and one decode step: device ms by region (attn holds ln1, the q/k/v/o
    projections, qk-norm, rope, the flash kernel and the cache write; ffn
    holds ln2 and the MLP; zamba2's shared block is ``shared_attn``),
    kernels launched, and the device's busy share (a MoE block's FFN is in
    ``moe_router`` and ``moe_ffn``). Measures only; checks nothing; a
    trace with no device events is reported as not measured."""
    from repro_torch.models import model as M
    p, cfg, batch = m["params"], m["cfg"], m["batch"]
    out = {}
    if cfg.family != "ssm":
        spans, n_kern, busy, wall, kern = _trace(
            lambda: M.prefill(p, cfg, batch, MODEL_MAX_LEN,
                              attn_impl="flash"))
        if busy <= 0:
            log("model breakdown: device time not measured (the profiler "
                "saw no device events)")
            return None
        flash = sum(e.self_device_time_total for e in kern
                    if "fa_wgmma_kernel" in e.key or "fa_fwd_kernel" in e.key
                    ) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        log(f"model breakdown {cfg.name}, one flash prefill: device ms by "
            "region "
            + ", ".join(f"{r} {spans[r]:.3f}" for r in MODEL_REGIONS
                        if r in spans)
            + f" (sum {sum(spans.get(r, 0.0) for r in MODEL_REGIONS):.3f}); "
            f"{n_kern} kernels, device busy {busy:.3f} ms of {wall:.3f} ms "
            f"profiled wall (busy share {busy / wall:.3f}); flash kernel "
            f"{flash:.3f} ms; top kernels: "
            + "; ".join(f"{e.key[:48]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in top))
        out = dict(prefill_region_ms=spans, prefill_busy_ms=busy,
                   flash_ms=flash)
    spans_d, n_kern_d, busy_d, wall_d, _ = _trace(
        lambda: M.decode_step(p, cfg, m["tok"], m["cache"], m["cur_len"]))
    log(f"model breakdown {cfg.name}, one decode step (B={MODEL_BATCH}, "
        f"cache {MODEL_MAX_LEN}): {n_kern_d} kernels, device busy "
        f"{busy_d:.3f} ms of {wall_d:.3f} ms profiled wall (busy share "
        + (f"{busy_d / wall_d:.3f}" if busy_d > 0 else "not measured")
        + "); device ms by region "
        + ", ".join(f"{r} {v:.3f}" for r, v in sorted(spans_d.items())))
    return dict(out, decode_kernels=n_kern_d, decode_busy_ms=busy_d)


HYBRID_ARCH, SSM_ARCH = "zamba2-1.2b", "xlstm-125m"
# The recurrent decode steps are held against a forward over the prompt
# and the decoded tokens, 2 080 positions: the scans need the length to
# be a multiple of their chunk (min(chunk, S)), so that forward runs at
# the largest chunk up to the default 128 that divides it (32).
# Float32, full width and depth: flash against full attention and the
# decode steps against the forward, as a share of max |.| (the
# reference's own decode-vs-forward limit at reduced size is 1e-4).
RECURRENT_F32_REL = 1e-3
# bf16: decode step 1 against the forward at its position, as a share of
# max |logit|, within this multiple of the scans' bf16 rounding spread
# measured in the same run (the prompt's last logits at two chunk
# lengths; NVIDIA H100 80GB HBM3, 700.00 W: zamba2 0.0306 against a
# spread of 0.0346, xlstm 0.0393 against 0.0464).
RECURRENT_BF16_SPREADS = 2
# The cache leaves kept in the cache dtype; every other recurrent leaf
# (state, stabilisers, normalisers) is float32, as in the reference.
CACHE_DTYPE_LEAVES = ("conv_x", "conv_bc", "k", "v")


def recurrent_model_phase(dev, arch):
    """``prefill`` + ``MODEL_DECODE`` greedy ``decode_step``s of a
    recurrent family at full width and depth (zamba2-1.2b: 38 Mamba2
    layers in 6 groups of 6 and a tail of 2, the weight-shared attention
    block after each group; xlstm-125m: 6 mLSTM + sLSTM pairs; bf16
    compute, random float32 master weights from seed 0 held as a bf16
    copy, B=4 × 2048 random tokens). Launch counters are set to 0 just
    before the prefill and read after the decode steps: zamba2's prefill
    launches flash once per group (6; the tail has no attention), xlstm
    none, and decode none.

    Checks, bf16: finite outputs of the expected shapes; the cache's
    dtypes after the decode steps (conv tails and K/V bf16, every other
    leaf float32); the flash
    prefill's logits within ``MODEL_REL_TOL`` of max |logit| of the same
    prefill through ``attn_impl="full"``, and the cache of everything
    ahead of the first attention (zamba2's first group and its shared
    block's K/V; all of xlstm's) bitwise equal; decode step 1 against a
    forward over the prompt and the decoded tokens within
    ``RECURRENT_BF16_SPREADS`` times the bf16 rounding spread of the
    scans (the same prompt's last logits at chunk 128 and at the
    forward's chunk). The rest of the cache and the later decode steps
    are printed: through 2 048 recurrent steps bf16 rounding moves
    more than 5% of max |logit| (xlstm: 15%). Float32 (the same weights,
    cast up): the flash and full prefills' logits and every cache leaf,
    and every decode step against the forward, within
    ``RECURRENT_F32_REL`` of max |.|. Returns the measurements."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    from repro_torch.tree import stacked_paths, tree_leaves, tree_map
    cfg = get_config(arch)
    B, S, T, steps = MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_DECODE
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.n_layers // cfg.attn_every if hybrid else 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p, n_params, draw_s = _draw(cfg, dev)
    shape = (f"{n_attn} groups of {cfg.attn_every} Mamba2 layers + a tail "
             f"of {cfg.n_layers - n_attn * cfg.attn_every} (d_in "
             f"{cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, SSM "
             f"head {cfg.ssm_head_dim}), shared attention H={cfg.n_heads} "
             f"KV={cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff}"
             if hybrid else f"{cfg.n_layers // 2} mLSTM + sLSTM pairs, "
             f"H={cfg.n_heads} dh={cfg.head_dim}")
    log(f"model: {arch} {cfg.family} {cfg.n_layers} layers d_model="
        f"{cfg.d_model} {shape} vocab={cfg.vocab_size}: {n_params} "
        f"parameters drawn and cast to bf16 in {draw_s:.2f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = _model_batch(cfg, B, S, g, dev)

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
    prefill_cache = tree_map(torch.clone, cache)
    cur_len = cur.to(torch.int32).expand(B).contiguous()     # [B]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    fed, outs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_logits, cache = M.decode_step(p, cfg, tok, cache, cur_len)
        fed.append(tok)
        outs.append(step_logits)
        tok = step_logits[:, -1].argmax(-1, keepdim=True)
        cur_len = cur_len + 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check(after_prefill == n_attn, f"model {arch}: flash launches per "
          f"prefill {after_prefill} == {n_attn}")
    check(launches == {"sample_attr_fold": 0, "flash_attention": n_attn,
                       "rmsnorm": 0},
          f"model {arch}: launches in prefill + decode {launches}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"model {arch}: prefill logits")
    check(all(tuple(o.shape) == (B, 1, cfg.vocab_size)
              and bool(torch.isfinite(o).all()) for o in outs),
          f"model {arch}: decode logits")
    check(int(cur_len[0]) == S + steps, f"model {arch}: cur_len after decode")
    dtypes = {path[-1]: str(t.dtype).replace("torch.", "") for path, t in
              zip(stacked_paths(cache), tree_leaves(cache))}
    check(all(d == ("bfloat16" if k in CACHE_DTYPE_LEAVES else "float32")
              for k, d in dtypes.items()),
          f"model {arch}: cache dtypes after decode {dtypes}")

    def by_kind(a, b):
        """max over leaves of _max_rel, by leaf name (k, v, h, conv_x,
        ...)."""
        out = {}
        for path, x, y in zip(stacked_paths(a), tree_leaves(a),
                              tree_leaves(b)):
            out[path[-1]] = max(out.get(path[-1], 0.0), _max_rel(x, y))
        return out

    # bf16: flash against full.
    full_logits, full_cache, _ = M.prefill(p, cfg, batch, T,
                                           attn_impl="full")
    rel = _max_rel(logits, full_logits)
    check(rel <= MODEL_REL_TOL, f"model {arch}: flash vs full prefill "
          f"logits {rel:.4f} of max |logit|")
    ahead = [[c["groups"][0], c["shared_attn"][0]] if hybrid else c
             for c in (prefill_cache, full_cache)]
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(ahead[0]),
                                                tree_leaves(ahead[1]))),
          f"model {arch}: cache ahead of the first attention bitwise equal")
    cache_rel = by_kind(prefill_cache, full_cache)
    del full_cache, prefill_cache
    # bf16: the decode steps against a forward over the prompt and the
    # decoded tokens, and the scans' rounding spread at the same chunks.
    ext = {"tokens": torch.cat([batch["tokens"]] + fed, dim=1)}
    chunk = math.gcd(S + steps, 128)
    fwd, _ = M.forward(p, cfg, ext, attn_impl="flash", ssd_chunk=chunk)
    dec_rel = [_max_rel(o[:, 0], fwd[:, S + i]) for i, o in enumerate(outs)]
    spread = _max_rel(fwd[:, S - 1], logits[:, 0])
    del fwd
    check(dec_rel[0] <= RECURRENT_BF16_SPREADS * spread, f"model {arch} "
          f"bf16: decode step 1 vs the forward {dec_rel[0]:.4f} of max "
          f"|logit|, above {RECURRENT_BF16_SPREADS} x the scans' spread "
          f"{spread:.4f}")
    log(f"model {arch} bf16: flash vs full prefill: logits {rel:.4f} of "
        f"max |logit| ({full_logits.float().abs().max().item():.3f}; "
        f"tolerance {MODEL_REL_TOL}), the cache ahead of the first "
        f"attention bitwise equal, every cache leaf by name (measured, not "
        f"checked): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  cache_rel.items())
        + f"; the {steps} decode steps vs a forward over the prompt and "
        f"the decoded tokens ({S + steps} positions, chunk {chunk}): step "
        f"1 {dec_rel[0]:.4f} of max |logit| (tolerance "
        f"{RECURRENT_BF16_SPREADS} x the bf16 rounding spread of the scans:"
        f" the prompt's last logits at chunk 128 vs chunk {chunk} "
        f"{spread:.4f}); measured, not checked: worst {max(dec_rel):.4f}, "
        f"step {steps} {dec_rel[-1]:.4f}; cache dtypes {dtypes}")
    del full_logits, outs
    log(f"model {arch}: prefill B={B} S={S} {prefill_s * 1e3:.2f} ms "
        f"({B * S / prefill_s:.1f} tokens/s), {after_prefill} flash "
        f"launches; decode {steps} steps {decode_s * 1e3 / steps:.3f} ms "
        f"per step ({B * steps / decode_s:.1f} tokens/s); peak device "
        f"memory {peak / 2 ** 30:.2f} GiB; launches in the main path "
        f"{launches}")
    result = dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / steps,
                  peak_bytes=peak, launches=launches, params=p, cfg=cfg,
                  batch=batch, cache=cache, tok=tok, cur_len=cur_len - 1)

    # float32, the same weights cast up: the numerics, checked.
    cfg32 = cfg.replace(compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), p)
    f32 = {}
    for impl in ("flash", "full"):
        f32[impl] = M.prefill(p32, cfg32, batch, T, attn_impl=impl,
                              cache_dtype=torch.float32)[:2]
    rel32 = _max_rel(f32["flash"][0], f32["full"][0])
    cache32 = by_kind(f32["flash"][1], f32["full"][1])
    c32, tok32, outs32 = f32["flash"][1], fed[0], []
    del f32
    cl = torch.full((B,), S, dtype=torch.int32, device=dev)
    for i in range(steps):
        lg, c32 = M.decode_step(p32, cfg32, fed[i], c32, cl + i)
        outs32.append(lg)
    fwd32, _ = M.forward(p32, cfg32, ext, attn_impl="flash",
                         ssd_chunk=chunk)
    dec32 = [_max_rel(o[:, 0], fwd32[:, S + i]) for i, o in
             enumerate(outs32)]
    del p32, c32, fwd32, outs32
    torch.cuda.empty_cache()
    worst32 = max([rel32, max(dec32)] + list(cache32.values()))
    check(worst32 <= RECURRENT_F32_REL, f"model {arch} float32: flash vs "
          f"full {rel32:.2e}, cache {cache32}, decode vs forward "
          f"{max(dec32):.2e} of max |.| (tolerance {RECURRENT_F32_REL})")
    log(f"model {arch} float32 (the bf16 weights cast up): flash vs full "
        f"prefill logits {rel32:.2e}, cache by name "
        + ", ".join(f"{k} {v:.2e}" for k, v in cache32.items())
        + f"; the {steps} decode steps (the bf16 run's tokens) vs the "
        f"forward: worst {max(dec32):.2e}, step 1 {dec32[0]:.2e}, step "
        f"{steps} {dec32[-1]:.2e} of max |.| (tolerance "
        f"{RECURRENT_F32_REL})")
    return result


def slstm_breakdown(m):
    """The sLSTM scan alone: pair 0's ``slstm_forward`` on a [B, S,
    d_model] bf16 input at the model phase's shape, once untimed, once
    timed (host wall around it, ending in a device sync) and once traced
    (kernels, the device's busy share). Its strictly recurrent loop is S
    steps of a dozen small operations each. Measures only."""
    import torch
    from repro_torch.models.xlstm import slstm_forward
    p, cfg = m["params"]["pairs"][0]["s"], m["cfg"]
    g = torch.Generator(device=m["tok"].device).manual_seed(2)
    x = torch.randn(MODEL_BATCH, MODEL_PROMPT, cfg.d_model, generator=g,
                    device=m["tok"].device).to(torch.bfloat16)
    slstm_forward(p, cfg, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slstm_forward(p, cfg, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _, n_kern, busy, wall, _ = _trace(lambda: slstm_forward(p, cfg, x))
    n_pairs = cfg.n_layers // 2
    log(f"slstm breakdown {cfg.name}: one sLSTM scan at B={MODEL_BATCH} "
        f"S={MODEL_PROMPT} {ms:.2f} ms ({ms / MODEL_PROMPT * 1e3:.1f} us a "
        f"step); x {n_pairs} pairs = {n_pairs * ms:.1f} ms of the "
        f"{m['prefill_ms']:.1f} ms prefill; traced: {n_kern} kernels "
        f"({n_kern / MODEL_PROMPT:.1f} a step), device busy {busy:.3f} ms "
        f"of {wall:.3f} ms profiled wall (busy share "
        + (f"{busy / wall:.3f})" if busy > 0 else "not measured: no device "
           "events)"))
    return dict(ms=ms, kernels=n_kern, busy_ms=busy, wall_ms=wall)


# ---------------------------------------------------------------------------
# Phase 7: the serving engine at full size.
# ---------------------------------------------------------------------------

# The launcher's defaults: 8 requests, prompts of 4-15 tokens, 16 new
# tokens each, 4 slots, 256 cache positions.
SERVE_REQUESTS, SERVE_NEW, SERVE_BATCH, SERVE_LEN = 8, 16, 4, 256
SERVE_INNER = ("embed", "attn", "attn_decode", "attn_score", "ffn",
               "moe_router", "moe_ffn", "lm_head") + RECURRENT_REGIONS
SERVE_SPEC = dict(spec_len=4, spec_window=16, spec_sinks=4)
# Kill the engine in the second wave of requests (steps 16-31 at 16 new
# tokens and 4 slots); snapshots every second step, the last at 20.
SERVE_CRASH_AT = 21
# Partition of the phase energy over requests: k copies of pow/k sum to
# pow within a few ulps.
SERVE_PARTITION_RTOL = 1e-9


@contextlib.contextmanager
def engine_step_times():
    """Wall ms of every prefill (``Engine._place``: one teacher-forced
    decode step per prompt token) and every baseline decode step
    (``Engine._step_baseline``) on any engine while the block runs. Each
    ends in a host read of the sampled tokens, so its device work is
    inside. Yields {"prefill": [(ms, steps)], "decode": [(ms, 1)]}."""
    from repro_torch.serve.engine import Engine
    times = {"prefill": [], "decode": []}
    place, base = Engine._place, Engine._step_baseline

    def timed_place(self, req):
        t0 = time.perf_counter()
        place(self, req)
        times["prefill"].append(((time.perf_counter() - t0) * 1e3,
                                 len(req.prompt)))

    def timed_base(self, step, active):
        t0 = time.perf_counter()
        out = base(self, step, active)
        times["decode"].append(((time.perf_counter() - t0) * 1e3, 1))
        return out

    Engine._place, Engine._step_baseline = timed_place, timed_base
    try:
        yield times
    finally:
        Engine._place, Engine._step_baseline = place, base


def _ms_per_step(entries):
    n = sum(k for _, k in entries)
    return (sum(m for m, _ in entries) / n if n else float("nan")), n


def _streams(done):
    return {r.rid: list(r.out_tokens) for r in done}


def serve_phase(dev, arch=MODEL_ARCH, *, full=True):
    """The serving engine (``repro_torch.launch.serve``) on ``arch`` at
    full size, bf16 compute and cache, random weights from seed 0; with
    ``full`` False only (a).

    (a) the launcher's ``main`` with its defaults, launch counters set to
        0 just before and read just after: every request served, no
        kernel of the port launched (the engine prefills by teacher-forced
        decode steps through the plain ``attention_decode``); prints
        tokens/s, ms per prefill and decode step, peak memory, the host
        sensor and the share of samples in ``<other>``;
    (b) the same traffic with a ``PhaseEnergyAccountant(track_requests=
        True)`` whose marker records every region it is set to: no sample
        and no marker store in a model-inner region (C6), the per-request
        energies partition the phase energy of the samples drained while
        requests were in flight, and ``current_joules_per_token`` quotes;
    (c) three staggered requests give the tokens each gives alone in an
        engine of the same shape;
    (d) speculation (spec_len 4, window 16, sinks 4) token-exact to the
        baseline in float32 compute and cache; in bf16 the share of equal
        tokens and the first difference are printed, not checked (the
        verify's GEMMs have B·L rows, the baseline's B);
    (e) an engine killed at step ``SERVE_CRASH_AT`` and restored from its
        last snapshot finishes with the uninterrupted run's tokens, bit
        for bit, in bf16.
    Returns the launch counts of (a) and the measurements."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import regions
    from repro_torch.core.faults import FaultPlan, InjectedCrash
    from repro_torch.core.sampler import RegionMarker
    from repro_torch.core.sensors import available_host_sensor
    from repro_torch.core.streaming import StreamingAggregator
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (Engine, PhaseEnergyAccountant,
                                          Request, ServeConfig)
    from repro_torch.serve.recovery import restore_engine

    tag = f"serve {arch}"
    # (a) the launcher.
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with engine_step_times() as times:
        done, engine, sess = launcher.main(["--arch", arch])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    est = sess.estimates()
    n_tok = sum(len(r.out_tokens) for r in done)
    check(len(done) == SERVE_REQUESTS and all(r.done for r in done),
          f"serve {arch}: {len(done)}/{SERVE_REQUESTS} requests served")
    check(n_tok == SERVE_REQUESTS * SERVE_NEW,
          f"serve {arch}: {n_tok} tokens out")
    check(launches == {"sample_attr_fold": 0, "flash_attention": 0,
                       "rmsnorm": 0}, f"serve {arch}: launches {launches}")
    by = est.by_name()
    sampled = {n: by[n].n_samples for n in SERVE_INNER
               if n in by and by[n].n_samples}
    check(not sampled, f"{tag} (a): samples in {sampled}")
    pre_ms, pre_n = _ms_per_step(times["prefill"])
    dec_ms, dec_n = _ms_per_step(times["decode"])
    other = est.by_name()["<other>"].n_samples if "<other>" in \
        est.by_name() else 0
    sensor = type(sess.sampler.sensor).__name__
    log(f"{tag} (a): launcher main: served {len(done)}/"
        f"{SERVE_REQUESTS} "
        f"requests, {n_tok} tokens in {est.t_exec:.3f} s of serving "
        f"({n_tok / est.t_exec:.1f} tokens/s; main {main_s:.3f} s with the "
        f"weights drawn); {engine.step_count} engine steps; prefill "
        f"{pre_ms:.3f} ms per step ({pre_n} steps), decode {dec_ms:.3f} ms "
        f"per step ({dec_n} steps); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; host sensor {sensor} "
        f"(available_host_sensor: {type(available_host_sensor()).__name__}); "
        f"{est.n_total} samples, <other> {other / est.n_total:.3f}, none "
        f"in a model-inner region; launches {launches}")
    result = dict(launches=launches, prefill_ms=pre_ms, decode_ms=dec_ms,
                  tokens_per_s=n_tok / est.t_exec, peak_bytes=peak)
    base = _streams(done)
    cfg, params = engine.cfg, engine.params
    del engine, done
    if not full:
        del params
        torch.cuda.empty_cache()
        return result
    scfg = ServeConfig(max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                       eos_token=-1)

    def traffic():
        return launcher.make_requests(cfg, SERVE_REQUESTS, SERVE_NEW)

    # (b) accounting.
    class Recording(RegionMarker):
        def __init__(self):
            super().__init__()
            self.ids = set()

        def set(self, region_id):
            self.ids.add(region_id)
            super().set(region_id)

    acct = PhaseEnergyAccountant(track_requests=True)
    marker = Recording()
    acct.marker = acct.sampler.marker = marker
    inflight = StreamingAggregator(1, domains=acct.domains)
    in_flight = [False]
    acct_drain, sampler_drain = acct.drain, acct.sampler.drain

    def drain(active_requests=None):
        in_flight[0] = bool(active_requests)
        return acct_drain(active_requests=active_requests)

    def drain_samples():
        rids, pows = sampler_drain()
        if in_flight[0] and len(rids):
            n = max(len(regions.registry.names), int(rids.max()) + 1)
            if n > inflight.num_regions:
                inflight.grow(n)
            inflight.update(rids, pows)
        return rids, pows

    acct.drain, acct.sampler.drain = drain, drain_samples
    eng = Engine(cfg, params, scfg, accountant=acct, device=dev)
    with acct:
        done = eng.run_until_drained(traffic())
    check(_streams(done) == base, f"{tag} (b): tokens with the accountant "
          "equal the launcher's")
    names = regions.registry.names
    inner = {names.index(n) for n in SERVE_INNER if n in names}
    counts = acct.agg.counts
    in_inner = {names[i]: int(counts[i]) for i in inner
                if i < len(counts) and counts[i]}
    check(not in_inner, f"{tag} (b): samples in model-inner regions "
          f"{in_inner}")
    check(not marker.ids & inner, f"{tag} (b): marker set to "
          f"{sorted(names[i] for i in marker.ids & inner)}")
    per = acct.request_phase_energy()
    scale = acct.elapsed / acct.agg.n_total
    phases = sorted({p for d in per.values() for p in d}
                    | {names[i] for i in range(inflight.num_regions)
                       if inflight.counts[i]})
    worst = 0.0
    for p in phases:
        i = names.index(p)
        want = scale * float(inflight.chan_psum[i].sum())
        got = sum(d.get(p, 0.0) for d in per.values())
        err = abs(got - want) / max(abs(want), 1e-300)
        worst = max(worst, err)
        check(err <= SERVE_PARTITION_RTOL, f"{tag} (b): requests' energy "
              f"in {p} {got:.9g} J vs in-flight phase energy {want:.9g} J")
    quote = eng.current_joules_per_token()
    tbl = acct.estimates().table
    log(f"{tag} (b): accountant: {acct.agg.n_total} samples, "
        f"{acct.epoch} drains, sensor {type(acct.sampler.sensor).__name__}; "
        f"marker stores to {sorted(names[i] for i in marker.ids)}, none in "
        f"{list(SERVE_INNER)}; per-request energies partition the "
        f"in-flight phase energy of {phases} (worst rel {worst:.2e}; "
        f"{1 - inflight.n_total / acct.agg.n_total:.3f} of samples drained "
        f"with no request in flight); phases J: "
        + ", ".join(f"{tbl.names[i]} {tbl.e_hat[i]:.4f}"
                    for i in range(len(tbl)) if tbl.n_samples[i])
        + f"; J/token {quote.j_per_token:.6g} [{quote.lo:.6g}, "
        f"{quote.hi:.6g}] (alpha {quote.alpha}) over {quote.tokens} tokens "
        f"from {list(quote.phases)}: host-sensor energy, not the card's")
    del eng, acct

    # (c) ragged batching.
    rscfg = ServeConfig(max_batch=3, max_len=64, eos_token=-1)
    rng = np.random.default_rng(42)
    ps = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
          for n in (7, 3, 11)]
    alone = []
    for i, p in enumerate(ps):
        e = Engine(cfg, params, rscfg, device=dev)
        alone.append(e.run_until_drained(
            [Request(rid=i, prompt=p.copy(), max_new_tokens=8)])[0]
            .out_tokens)
    e = Engine(cfg, params, rscfg, device=dev)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=8)
            for i, p in enumerate(ps)]
    for k, r in enumerate(reqs):
        e.add_request(r)
        for _ in range(2 if k < 2 else 40):
            e.step()
            if k == 2 and all(s is None for s in e.slot_req):
                break
    check(all(r.done for r in reqs), f"{tag} (c): staggered requests done")
    check([r.out_tokens for r in reqs] == alone,
          f"{tag} (c): staggered tokens equal each request alone")
    log(f"{tag} (c): 3 staggered requests (prompts 7, 3, 11; 8 new tokens) "
        f"equal each request alone in an engine of the same shape")
    del e

    # (e) recovery, bf16.
    with tempfile.TemporaryDirectory() as snap:
        eng = Engine(cfg, params, scfg, device=dev,
                     faults=FaultPlan(seed=7,
                                      serve_crashes=(SERVE_CRASH_AT,)))
        for r in traffic():
            eng.submit(r)
        before = []
        try:
            for _ in range(500):
                if eng.step_count % 2 == 0:
                    eng.snapshot(snap)
                before += eng.step()
        except InjectedCrash:
            pass
        check(eng.step_count == SERVE_CRASH_AT,
              f"{tag} (e): killed at step {eng.step_count}")
        del eng
        t0 = time.perf_counter()
        eng = restore_engine(cfg, params, scfg, snap, device=dev)
        restore_s = time.perf_counter() - t0
        restored_at = eng.step_count
        after = eng.run_until_drained([])
    merged = {**_streams(before), **_streams(after)}
    check(merged == base, f"{tag} (e): merged streams of {len(before)} "
          f"requests before the kill and {len(after)} after the restore "
          f"equal the uninterrupted run")
    log(f"{tag} (e): killed at step {SERVE_CRASH_AT}, restored from the "
        f"snapshot at step {restored_at} in {restore_s:.3f} s (replay of "
        f"{sum(len(r.prompt) + len(r.out_tokens) for r in after)} tokens "
        f"at most); {len(before)} requests done before, {len(after)} after: "
        f"the merged streams equal the uninterrupted run bit for bit (bf16)")
    del eng

    # (d) speculation: bf16 measured, float32 checked.
    def run(cfg_, params_, scfg_):
        e = Engine(cfg_, params_, scfg_, device=dev)
        t0 = time.perf_counter()
        d = e.run_until_drained(traffic())
        s = time.perf_counter() - t0
        return _streams(d), e, s

    spec_scfg = ServeConfig(max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                            eos_token=-1, **SERVE_SPEC)
    got, e, s = run(cfg, params, spec_scfg)
    pairs = [(a, b) for rid in base for a, b in zip(got[rid], base[rid])]
    same = sum(a == b for a, b in pairs) / len(pairs)
    first = {rid: next((j for j, (a, b) in enumerate(zip(got[rid],
                                                         base[rid]))
                        if a != b), None) for rid in base}
    rep = e.report
    log(f"{tag} (d) bf16 (measured, not checked): speculative tokens equal "
        f"to the baseline {same:.3f}; first difference per request "
        f"{first}; acceptance {rep.accepted}/{rep.drafted}; "
        f"{e.step_count} engine steps in {s:.3f} s")
    del e, params, got
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(compute_dtype="float32")
    g = torch.Generator(device=dev).manual_seed(0)
    p32 = M.init_params(g, cfg32, device=dev)
    base32, e, s0 = run(cfg32, p32, ServeConfig(
        max_batch=SERVE_BATCH, max_len=SERVE_LEN, eos_token=-1,
        cache_dtype="float32"))
    steps0 = e.step_count
    spec32, e, s1 = run(cfg32, p32, ServeConfig(
        max_batch=SERVE_BATCH, max_len=SERVE_LEN, eos_token=-1,
        cache_dtype="float32", **SERVE_SPEC))
    rep = e.report
    check(rep.drafted > 0, f"{tag} (d): speculation ran")
    check(spec32 == base32, f"{tag} (d): float32 speculative tokens equal "
          "the baseline")
    log(f"{tag} (d) float32: speculative tokens equal the baseline "
        f"({sum(map(len, spec32.values()))} tokens); acceptance "
        f"{rep.accepted}/{rep.drafted}, {rep.rollbacks} windows cut; "
        f"baseline {steps0} engine steps in {s0:.3f} s, speculative "
        f"{e.step_count} in {s1:.3f} s")
    if cfg.family in M.RECURRENT:
        recurrent_rollback_check(tag, cfg32, p32, dev, traffic, base32)
    del e, p32
    torch.cuda.empty_cache()
    return dict(result, j_per_token=quote.j_per_token)


def recurrent_rollback_check(tag, cfg, params, dev, traffic, base):
    """Serve (d) for a recurrent family: float32 speculation with rejected
    drafts. Every other draft pass proposes its runner-up token (the
    draft step still advances the recurrent state on it), so windows
    are cut: the engine restores its window-start checkpoint (a clone
    of the cache) and replays the accepted tokens under
    ``serve/replay``. Checks: rejected drafts and cut windows, replay
    steps run, tokens equal the non-speculative run's."""
    from repro_torch.core import regions
    from repro_torch.serve.engine import Engine, ServeConfig
    e = Engine(cfg, params, ServeConfig(
        max_batch=SERVE_BATCH, max_len=SERVE_LEN, eos_token=-1,
        cache_dtype="float32", **SERVE_SPEC), device=dev)
    draft, calls, phases = e._draft_step, [0], []

    def wrong_half_the_time(p, t, c, l, m):
        logits, c = draft(p, t, c, l, m)
        calls[0] += 1
        if calls[0] % 2:
            second = logits.topk(2, dim=-1).indices[..., 1:]
            logits = logits.scatter(-1, second,
                                    logits.amax(-1, True) + 1.0)
        return logits, c

    def spy(name):
        phases.append(name)
        return region(name)
    e._draft_step = wrong_half_the_time
    region = regions.region
    regions.region = spy
    try:
        t0 = time.perf_counter()
        got = _streams(e.run_until_drained(traffic()))
        s = time.perf_counter() - t0
    finally:
        regions.region = region
    rep = e.report
    n_replay = phases.count("serve/replay")
    check(rep.rejected > 0 and rep.rollbacks > 0,
          f"{tag} (d): rejected {rep.rejected}, rollbacks {rep.rollbacks}")
    check(n_replay > 0, f"{tag} (d): no serve/replay phase ran")
    check(got == base, f"{tag} (d): speculative tokens with rejected drafts "
          f"equal the baseline")
    log(f"{tag} (d) float32 with rejected drafts (every other draft pass "
        f"proposes its runner-up): tokens equal the baseline; acceptance "
        f"{rep.accepted}/{rep.drafted}, {rep.rollbacks} windows rolled back "
        f"to the window-start checkpoint, {n_replay} serve/replay phases; "
        f"{e.step_count} engine steps in {s:.3f} s")


# ---------------------------------------------------------------------------
# Phase 8: training at full size.
# ---------------------------------------------------------------------------

# The launcher's defaults (src/repro/launch/train.py): B=8 × 512, lr 3e-4,
# bf16 compute, remat "full", profiling at 5 ms; 8 steps (ckpt_every 10:
# nothing written).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 512
# Regions that take no sample and no marker store when the step runs as
# the reference's jitted step does (C7): the step's own and the model's.
TRAIN_INNER = ("fwd_bwd", "grad_compress", "optimizer", "embed", "attn",
               "attn_score", "ffn", "moe_router", "moe_ffn", "lm_head",
               "loss") + RECURRENT_REGIONS
TRAIN_LOSS_RTOL = 1e-5          # card against CPU, float32
# (b) with compression: the share of elements whose int8 code the card and
# the CPU may round apart (their residuals then differ by a quantum, not
# by rounding), after step 1 and, counting every step, after step 3. A
# fault in the card's compression moves nearly every element.
TRAIN_FLIP_CAP = {1: 1e-4, 3: 2e-3}
TRAIN_NOISE_CAP = 1e-3          # (b) without it: the rounding-led share
# The recurrent families' own caps, each just above its reading on the
# card (NVIDIA H100 80GB HBM3, 700.00 W; reduced xlstm, and reduced
# zamba2 with a tail), where rounding alone parts as many elements
# (scripts/train_rounding_witness.py: the port against itself from
# parameters one ulp apart, on the CPU of the card's host). zamba2's
# codes rounded apart after step 3: card 8 294-8 532 of 759 920, witness
# 8 422 (xlstm keeps the cap above: card 478-485 of 247 812). Rounding-
# led elements without compression: xlstm card 514-523, zamba2 1 631-
# 1 652; the tiny first gradients alone (the rule of every family) are
# 470 and 1 310 of them in the witness (zamba2's B/C and dt projections),
# qwen3's 73, the same as its card reading.
TRAIN_FLIP_CAP_BY_FAMILY = {"hybrid": {1: 1e-4, 3: 1.25e-2}}
TRAIN_NOISE_CAP_BY_FAMILY = {"ssm": 2.5e-3, "hybrid": 2.5e-3}
# (b), moe: the share of a step's routed tokens whose expert choice the
# card and the CPU may round apart (float32 router, TF32 off).
TRAIN_ROUTE_FLIP_CAP = 1e-3
# (b), moe and the recurrent families: an element whose gradient in some
# step differs between the card and the CPU by more than this share of it
# is rounding-led (its gradient is a cancellation of larger terms); moe's
# rounding-led share is capped at TRAIN_MOE_NOISE_CAP (see train_phase),
# the recurrent families' at their own.
TRAIN_GRAD_ROUND_RTOL = 1e-2
TRAIN_MOE_NOISE_CAP = 1e-2
FUSED_CE_RTOL = 1e-3            # fused against plain CE, bf16 logits
FUSED_CE_B, FUSED_CE_S = 2, 2048


def _to(tree, dev):
    """A copy of a train state on ``dev``; parameters require grad."""
    import torch
    from repro_torch.tree import tree_map
    out = tree_map(lambda t: t.detach().to(dev, copy=True), tree)
    tree_map(lambda t: t.requires_grad_(), out["params"])
    return out


def _train_param_check(what, got, want, noise, lr, lrs):
    """Parameters within atol 1e-2·lr, except the ``noise`` elements (see
    ``train_phase`` (b)), which are held to 2·Σlr; returns the worst
    differences (outside, inside) and the noise count."""
    worst, worst_noise, n = 0.0, 0.0, 0
    for a, b, m in zip(got, want, noise):
        d = (a.detach().cpu() - b.detach().cpu()).abs()
        n += int(m.sum())
        worst = max(worst, float(d[~m].max()) if (~m).any() else 0.0)
        worst_noise = max(worst_noise, float(d[m].max()) if m.any() else 0.0)
    check(worst <= 1e-2 * lr, f"{what}: parameters {worst:.3g} apart "
          f"(atol 1e-2·lr = {1e-2 * lr:.3g})")
    check(worst_noise <= 2 * sum(lrs), f"{what}: rounding-led elements "
          f"{worst_noise:.3g} apart (2·Σlr = {2 * sum(lrs):.3g})")
    return worst, worst_noise, n


class _Routes:
    """While active, records each MoE router call's router weight and
    expert choice, by device (``calls``); or, given ``replay`` (one
    [T, k] expert choice per call, in call order), hands each call those
    experts instead, weighted by the call's own router probabilities, and
    records which tokens' own choice would have parted (``parted``)."""

    def __init__(self, replay=None):
        self.replay, self.calls, self.parted = replay, {}, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.mod, self.orig = moe, moe.router

        def rec(p, cfg, x):
            top_p, top_i, aux = self.orig(p, cfg, x)
            if self.replay is None:
                self.calls.setdefault(x.device.type, []).append(
                    (p["router"].data_ptr(), top_i.detach()))
                return top_p, top_i, aux
            want = self.replay[len(self.parted)]
            self.parted.append((top_i.sort(-1).values
                                != want.sort(-1).values).any(-1))
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            w = torch.gather(probs, -1, want)
            return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), \
                want, aux
        moe.router = rec
        return self

    def __exit__(self, *exc):
        self.mod.router = self.orig

    def choices(self, dev):
        """The recorded expert choices on ``dev``, in call order."""
        return [t for _, t in self.calls.get(dev.type, [])]

    def note(self):
        """The replay's parted tokens: a count per call and the share of
        the tokens parted at some call."""
        ever = self.parted[0].clone()
        for m in self.parted[1:]:
            ever |= m
        return (f"{[int(m.sum()) for m in self.parted]} tokens a layer, "
                f"{ever.float().mean().item():.4f} of the tokens at some "
                f"layer (measured, not checked)")

    def compare(self, cpu_params):
        """The calls since the last compare, the CPU's against the card's
        in order: (tokens routed apart, tokens routed, {(layer, expert)}
        the ones routed apart chose on either side)."""
        cpu, card = self.calls.pop("cpu", []), self.calls.pop("cuda", [])
        check(len(cpu) == len(card), f"router calls: {len(cpu)} on the "
              f"CPU, {len(card)} on the card")
        layer = {b["moe"]["router"].data_ptr(): i
                 for i, b in enumerate(cpu_params.get("blocks", []))
                 if "moe" in b}
        moved, n_tok, touched = 0, 0, set()
        for (w, a), (_, b) in zip(cpu, card):
            a, b = a.sort(-1).values, b.cpu().sort(-1).values
            n_tok += len(a)
            for r in (a != b).any(-1).nonzero().flatten().tolist():
                moved += 1
                touched |= {(layer[w], e) for e in
                            set(a[r].tolist()) ^ set(b[r].tolist())}
        return moved, n_tok, touched


def _expert_masks(params, touched):
    """Per leaf of ``params`` (``tree_leaves`` order): True on the
    elements of the (layer, expert) pairs in ``touched`` (the expert's
    up/gate/down slices and its router column)."""
    import torch
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            m = torch.zeros(t.shape, dtype=torch.bool)
            if len(path) == 4 and path[0] == "blocks" and path[2] == "moe":
                for layer, e in touched:
                    if layer == path[1]:
                        if path[3] == "router":
                            m[:, e] = True
                        else:
                            m[e] = True
            out.append(m)
    walk(params, ())
    return out


def fused_ce_check(what, params, cfg, batch, *, peak="backward"):
    """``loss_fn`` forward + backward with ``fuse_ce`` True and False on
    float32 master weights that require grad: losses within rel
    ``FUSED_CE_RTOL`` (bf16 logits), and the fused peak below the plain
    one: of forward + backward, or with ``peak="forward"`` of the
    forward alone (where the [B,S,V] logits are smaller than what the
    backward holds anyway: the fused CE saves only in the forward).
    Prints loss, ms and peak memory of each (forward alone too) and the
    float32 gradients' size, which both backward peaks hold."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    ce = {}
    for fuse in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = M.loss_fn(params, cfg, batch, fuse_ce=fuse)
        fwd_peak = torch.cuda.max_memory_allocated() - base
        grads = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        ce[fuse] = (float(loss.detach()), (time.perf_counter() - t0) * 1e3,
                    torch.cuda.max_memory_allocated() - base, fwd_peak)
        del loss, grads
        torch.cuda.empty_cache()
    rel = abs(ce[True][0] - ce[False][0]) / abs(ce[False][0])
    gib = [{k: v[i] / 2 ** 30 for k, v in ce.items()} for i in (2, 3)]
    grad_gib = sum(t.numel() for t in tree_leaves(params)) * 4 / 2 ** 30
    B, S = batch["labels"].shape
    patches = (f" behind {batch['patch_embeds'].shape[1]} patch embeddings"
               if "patch_embeds" in batch else "")
    log(f"{what}: {cfg.name} loss_fn at B={B} S={S} labelled{patches}, "
        f"forward + backward: fused CE {ce[True][0]:.6f} ({ce[True][1]:.1f} "
        f"ms, peak {gib[0][True]:.2f} GiB above the weights, forward alone "
        f"{gib[1][True]:.2f}), plain {ce[False][0]:.6f} ({ce[False][1]:.1f} "
        f"ms, peak {gib[0][False]:.2f} GiB, forward alone "
        f"{gib[1][False]:.2f}); rel {rel:.2e} (tolerance {FUSED_CE_RTOL}); "
        f"the float32 gradients ({grad_gib:.2f} GiB) are in both peaks; "
        f"the {peak} peaks are checked")
    check(rel <= FUSED_CE_RTOL, f"{what}: fused CE {ce[True][0]} vs plain "
          f"{ce[False][0]} (rel {rel:.2e})")
    i = 2 if peak == "backward" else 3
    check(ce[True][i] < ce[False][i], f"{what}: fused {peak} peak "
          f"{ce[True][i]} not below plain {ce[False][i]}")
    return dict(fused_peak=ce[True][2], plain_peak=ce[False][2],
                fused_fwd_peak=ce[True][3], plain_fwd_peak=ce[False][3])


def _held_losses(cfg, data, params, dev):
    """The losses of the launcher's initial weights (redrawn from seed 0)
    and of ``params`` on the first and on the last step's batch of
    ``data``, without a gradient: {"initial": [first, last], "trained":
    [first, last]}."""
    import torch
    from repro_torch.models import model as M
    out = {}
    for name, p in (("trained", params), ("initial", None)):
        if p is None:
            p = M.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
        with torch.no_grad():
            out[name] = [float(M.loss_fn(p, cfg, {
                k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()})[0])
                for i in (0, TRAIN_STEPS - 1)]
        del p
    return out


def train_breakdown(state, cfg, dev):
    """Where a full-size train step's device time goes, from a
    torch.profiler trace of one more step of the launcher's (B=8 × 512):
    device ms of the ``fwd_bwd`` and ``optimizer`` regions' spans (the
    backward's kernels are issued by the autograd thread, not inside the
    calling thread's range), kernels, the device's busy share and the top
    kernels. Measures only; checks nothing."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, opaque_step
    step = opaque_step(make_train_step(cfg, AdamWConfig(
        total_steps=TRAIN_STEPS, warmup_steps=5)))
    b = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH).batch(TRAIN_STEPS)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    spans, n_kern, busy, wall, kern = _trace(lambda: step(state, batch))
    if busy <= 0:
        log("train breakdown: device time not measured (the profiler saw "
            "no device events)")
        return None
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    opt_ms = spans.get("optimizer", 0.0)
    log(f"train breakdown, one full-size step (B={TRAIN_BATCH} S="
        f"{TRAIN_SEQ}): {n_kern} kernels, device busy {busy:.3f} ms of "
        f"{wall:.3f} ms profiled wall (busy share {busy / wall:.3f}); "
        f"device spans: fwd_bwd {spans.get('fwd_bwd', 0.0):.3f} ms, "
        f"optimizer {opt_ms:.3f} ms; top kernels: "
        + "; ".join(f"{e.key[:48]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms" for e in top))
    return dict(busy_ms=busy, wall_ms=wall, optimizer_ms=opt_ms,
                kernels=n_kern)


def train_phase(dev, arch=MODEL_ARCH):
    """Training (``repro_torch.launch.train``) on the card.

    (a) the launcher at full size with its defaults (``arch``: dense
        qwen3-1.7b, moe granite-moe-1b-a400m, hybrid zamba2-1.2b or ssm
        xlstm-125m; B=8 × 512, bf16, remat
        "full", profiling at 5 ms), 8 steps; launch
        counters set to 0 just before and read just after: no kernel of
        the port launches (neither flash nor rmsnorm has a gradient, and
        the host session folds on the host). Checks: finite losses, the
        last below the first on one batch — the trained weights' loss
        below the first step's loss on the first step's batch and below
        the initial weights' (redrawn from seed 0) on the last step's
        batch (each step's logged loss is on a new batch, and how far
        xlstm-125m's moves in 8 steps is within what rounding alone
        spreads it: ROADMAP C9), ``opt["step"] == 8``, no
        sample and no marker store in a step-inner or model-inner region
        (C7). Prints the parameter count, ms and loss a step, tokens/s
        over steps 3-8, peak memory and the attribution table.
    (b) card against CPU: reduced ``arch`` (zamba2 with one layer more,
        so that it has a tail), float32, one initial state
        drawn on the CPU and copied to the card, 3 steps each for
        ``accum_steps`` 1 and 2 and with compression: losses within rel
        1e-5; parameters within atol 1e-2·lr except where the update
        follows rounding — the CPU run's first gradient below 10·eps
        (Adam's first update lr·g/(|g|+eps) amplifies it, its sign can
        flip) and, with compression, an element whose int8 code the two
        devices round apart in some step (residuals more than 1e-6
        apart); those within 2·Σlr. Without compression the rounding-led
        elements are at most 1e-3 of all; with it, the elements whose
        residuals part are at most 1e-4 of all after step 1 and 2e-3
        after step 3. The worst differences are printed. A MoE router
        whose float32 probabilities round apart can choose another
        expert for a token: the tokens routed apart are counted (at
        most ``TRAIN_ROUTE_FLIP_CAP`` of the routed tokens), printed, and
        the experts they touch (those experts' up/gate/down and router
        column in that layer) count as rounding-led from then on. In a
        MoE model an expert's gradient sums over the few tokens routed to
        it, and many more elements get a gradient that is a cancellation
        of larger terms, at any step: measured on reduced granite-moe
        (accum 2), a step-2 gradient of 1.77e-7 on the CPU and 1.86e-7 on
        the card turned Adam's update -0.026 into 0.0001 (7.95e-6 apart,
        2.6·atol). So for moe, and for the recurrent families (whose B/C
        and dt projections' gradients are small with random weights, and
        whose shared block's gradient sums its uses), an element whose
        gradient in some step (from each device's first moment) differs
        between the two by more than ``TRAIN_GRAD_ROUND_RTOL`` of it is
        rounding-led too. moe's rounding-led elements are capped at
        ``TRAIN_MOE_NOISE_CAP`` of all (measured 6.3e-4 at accum 1,
        2.9e-3 at accum 2; a fault moves nearly every element); the
        recurrent families' rounding-led elements and codes rounded apart
        at the caps of ``TRAIN_NOISE_CAP_BY_FAMILY`` and
        ``TRAIN_FLIP_CAP_BY_FAMILY``, each just above its card reading,
        with what rounding alone parts on the CPU beside it.
    (c) kill and resume at the reduced size of (b) on the card: 4 steps
        with a
        checkpoint every 2, a fresh trainer resumes at step 4 and runs to
        6; its losses at steps 5-6 and its final state equal a straight
        6-step run bit for bit.
    (d) fused CE at full size, B=2 × 2048: ``loss_fn`` with ``fuse_ce``
        True and False agree within rel 1e-3 (bf16 logits); the peak
        memory of forward plus backward of each is printed, and the
        fused one must be lower (for granite-moe, whose [B,S,V] logits,
        at vocab 49 155, are smaller than what its backward holds
        anyway, the forward's peak).
    (e) a gradient through ``attn_impl="flash"`` and through the rmsnorm
        kernel raises on the card (for ssm, which has no attention, the
        kernels alone).
    Returns the launch counts of (a) and the measurements."""
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import regions
    from repro_torch.core.sampler import RegionMarker
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (init_state, make_train_step,
                                        opaque_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    tag = f"train {arch}"
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    try:
        # (a) the launcher at full size.
        counters = launch_counters()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as ckdir:
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            result, sess, trainer = launcher.main([
                "--arch", arch, "--steps", str(TRAIN_STEPS),
                "--ckpt-dir", ckdir, "--log-every", "1"])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated()
            state = trainer.state
            opt_step = int(state["opt"]["step"])
            cfg = get_config(arch)
            held = _held_losses(cfg, trainer.data, state["params"], dev)
            # One more step, through the same trainer and step, under a
            # marker that records every store (C7: the launcher's own
            # session keeps only the last).
            stored = []

            class Recording(RegionMarker):
                def set(self, region_id):
                    stored.append(regions.registry.name_of(region_id))
                    super().set(region_id)

            trainer.cfg.total_steps += 1
            with regions.profiling_session(Recording()):
                trainer.run()
            ckpt_files = os.listdir(ckdir)
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        logged = result["metrics"]
        ms = [m["step_time_s"] * 1e3 for m in logged]
        losses = [m["loss"] for m in logged]
        tok_s = (TRAIN_BATCH * TRAIN_SEQ * (TRAIN_STEPS - 2)
                 / (sum(ms[2:]) / 1e3))
        est = sess.estimates()
        by = est.by_name()
        sampled = {n: by[n].n_samples for n in TRAIN_INNER
                   if n in by and by[n].n_samples}
        inner_stored = sorted(set(stored) & set(TRAIN_INNER))
        check(result["final_step"] == TRAIN_STEPS and len(ms) == TRAIN_STEPS,
              f"{tag} (a): {result['final_step']} steps")
        check(all(np.isfinite(losses)), f"{tag} (a): losses {losses}")
        (init_first, init_last), (first, last) = (held["initial"],
                                                  held["trained"])
        check(abs(init_first - losses[0]) <= 1e-3 * abs(losses[0]),
              f"{tag} (a): the redrawn initial weights give {init_first} "
              f"on the first batch, the launcher {losses[0]}")
        check(first < losses[0] and last < init_last, f"{tag} (a): the "
              f"trained weights' loss on the first step's batch {first} "
              f"(the first loss {losses[0]}), on the last step's {last} "
              f"(the initial weights' {init_last}): not both below")
        check(opt_step == TRAIN_STEPS, f"{tag} (a): opt step {opt_step}")
        check(ckpt_files == [], f"{tag} (a): checkpoint written "
              f"{ckpt_files}")
        check("train_step" in stored, f"{tag} (a): marker stores {stored}")
        check(not sampled, f"{tag} (a): samples in {sampled}")
        check(not inner_stored, f"{tag} (a): marker stored {inner_stored}")
        check(launches == {"sample_attr_fold": 0, "flash_attention": 0,
                           "rmsnorm": 0}, f"{tag} (a): launches {launches}")
        log(f"{tag} (a): launcher main: {arch} {n_params} parameters "
            f"(float32 masters), B={TRAIN_BATCH} S={TRAIN_SEQ}, "
            f"{TRAIN_STEPS} steps in {main_s:.3f} s (weights drawn "
            f"included); ms a step "
            + " ".join(f"{m:.1f}" for m in ms) + "; loss "
            + " ".join(f"{l:.4f}" for l in losses)
            + f" (each on its step's new batch, before the step's update); "
            f"the last below the first, on one batch: the first step's "
            f"{losses[0]:.4f} initial, {first:.4f} trained; the last "
            f"step's {init_last:.4f} initial, {last:.4f} trained"
            + f"; {tok_s:.1f} tokens/s over steps 3-{TRAIN_STEPS}; peak "
            f"device memory {peak / 2 ** 30:.2f} GiB; {est.n_total} samples "
            f"in {sorted(n for n in by if by[n].n_samples)}, none and no "
            f"marker store in {list(TRAIN_INNER)}; launches {launches}")

        if cfg.family == "ssm":
            breakdown = None
            log(f"{tag}: no traced step (~2.5·10^5 launches a step, the "
                f"sLSTM loop's; the model phase traces that loop alone)")
        else:
            breakdown = train_breakdown(state, cfg, dev)

        # (d) fused CE at full size, on the trained weights.
        params = state["params"]
        del trainer, state, result, sess
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size,
                                  (FUSED_CE_B, FUSED_CE_S), generator=g,
                                  device=dev) for k in ("tokens", "labels")}
        ce = fused_ce_check(f"{tag} (d)", params, cfg, batch,
                            peak="backward" if arch == MODEL_ARCH
                            else "forward")
        del params, batch
        torch.cuda.empty_cache()

        # (b) card against CPU, reduced, float32.
        reduced = get_config(arch).reduced()
        if reduced.family == "hybrid" and not (
                reduced.n_layers % reduced.attn_every):
            # One layer more, so the groups have a tail (reduced zamba2:
            # 4 layers at attn_every 2 become two groups and a tail of 1).
            reduced = reduced.replace(n_layers=reduced.n_layers + 1)
        rcfg = reduced.replace(compute_dtype="float32")
        opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
        data = SyntheticTokens(vocab_size=rcfg.vocab_size, seq_len=64,
                               global_batch=4)
        init = init_state(torch.Generator().manual_seed(0), rcfg, opt,
                          compression=True, device="cpu")
        routes = _Routes()
        for accum, comp in ((1, False), (2, False), (1, True)):
            cpu = _to({k: v for k, v in init.items()
                       if comp or k != "residuals"}, "cpu")
            gpu = _to(cpu, dev)
            step = make_train_step(rcfg, opt, accum_steps=accum,
                                   compression=comp)
            n_el = sum(t.numel() for t in tree_leaves(init["params"]))
            flip_caps = TRAIN_FLIP_CAP_BY_FAMILY.get(rcfg.family,
                                                     TRAIN_FLIP_CAP)
            lrs, worst_l, flips, moved, touched = [], 0.0, [], [], set()
            moe = rcfg.family == "moe"
            grad_rule = rcfg.family == "moe" or rcfg.family in M.RECURRENT
            # The first moments before the step, each device's (moe).
            mu0 = [[torch.zeros_like(m) for m in tree_leaves(st["opt"]["mu"])]
                   for st in (cpu, gpu)]
            for i in range(3):
                b = {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in data.batch(i).items()}
                with routes:
                    cpu, mc = step(cpu, b)
                    gpu, mg = step(gpu, {k: v.to(dev)
                                         for k, v in b.items()})
                n_moved, n_routed, t = routes.compare(cpu["params"])
                moved.append(n_moved)
                touched |= t
                check(n_moved <= TRAIN_ROUTE_FLIP_CAP * max(n_routed, 1),
                      f"{tag} (b) accum {accum} compression {comp} step "
                      f"{i + 1}: {n_moved} of {n_routed} routed tokens "
                      f"routed apart (cap {TRAIN_ROUTE_FLIP_CAP})")
                lc, lg = float(mc["loss"]), float(mg["loss"])
                worst_l = max(worst_l, abs(lg - lc) / abs(lc))
                check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc),
                      f"{tag} (b) accum {accum} compression {comp} step "
                      f"{i + 1}: loss {lg} on the card, {lc} on the CPU")
                lrs.append(float(mc["lr"]))
                if i == 0:
                    noise = [((m / (1 - opt.b1)).abs() < 10 * opt.eps)
                             & (m != 0) for m in tree_leaves(cpu["opt"]["mu"])]
                if touched:
                    noise = [n | r for n, r in zip(
                        noise, _expert_masks(cpu["params"], touched))]
                if grad_rule:
                    mu1 = [[m.detach().clone() for m in tree_leaves(
                        st["opt"]["mu"])] for st in (cpu, gpu)]
                    gc, gg = ([(m - opt.b1 * m0) / (1 - opt.b1)
                               for m, m0 in zip(now, before)]
                              for now, before in zip(mu1, mu0))
                    noise = [n | ((c - g.cpu()).abs()
                                  > TRAIN_GRAD_ROUND_RTOL * c.abs())
                             for n, c, g in zip(noise, gc, gg)]
                    mu0 = mu1
                if comp:
                    # Residuals within atol 1e-6 except where a code was
                    # rounded apart; those are counted and capped.
                    apart = [(a - c.cpu()).abs() > 1e-6 for a, c in
                             zip(tree_leaves(cpu["residuals"]),
                                 tree_leaves(gpu["residuals"]))]
                    noise = [n | d for n, d in zip(noise, apart)]
                    flipped = apart if i == 0 else [
                        f | d for f, d in zip(flipped, apart)]
                    n_flip = sum(int(f.sum()) for f in flipped)
                    flips.append(n_flip)
                    cap = flip_caps.get(i + 1)
                    check(cap is None or n_flip <= cap * n_el,
                          f"{tag} (b) compression step {i + 1}: residuals "
                          f"of {n_flip} elements of {n_el} more than 1e-6 "
                          f"apart (cap {cap})")
            worst, worst_n, n = _train_param_check(
                f"{tag} (b) accum {accum} compression {comp}",
                tree_leaves(gpu["params"]), tree_leaves(cpu["params"]),
                noise, opt.lr, lrs)
            cap = (TRAIN_MOE_NOISE_CAP if moe else
                   TRAIN_NOISE_CAP_BY_FAMILY.get(rcfg.family,
                                                 TRAIN_NOISE_CAP))
            check(comp or n <= cap * n_el,
                  f"{tag} (b) accum {accum}: {n} rounding-led elements of "
                  f"{n_el} (cap {cap})")
            log(f"{tag} (b): reduced {arch} ({rcfg.n_layers} layers) "
                f"float32, accum_steps {accum}, compression {comp}: 3 "
                f"steps on the card and on "
                f"the CPU; losses within rel {worst_l:.2e} (tolerance "
                f"{TRAIN_LOSS_RTOL}); parameters {worst:.3g} apart (atol "
                f"1e-2·lr = {1e-2 * opt.lr:.3g}) outside {n} rounding-led "
                f"elements of {n_el}, those {worst_n:.3g} apart"
                + (f"; elements whose residuals were ever more than 1e-6 "
                   f"apart (codes rounded apart), after each step: {flips} "
                   f"(caps {flip_caps} of the elements after steps 1 "
                   f"and 3)" if comp else "")
                + (f"; tokens routed apart in each step {moved} (cap "
                   f"{TRAIN_ROUTE_FLIP_CAP} of the routed tokens), experts "
                   f"they touch {sorted(touched)}" if moe else "")
                + (f"; an element whose gradient in some step differed by "
                   f"more than {TRAIN_GRAD_ROUND_RTOL} of it counts as "
                   f"rounding-led (cap {cap} of the elements)"
                   if grad_rule else ""))
        del init, cpu, gpu

        # (c) kill and resume, reduced, bf16 compute, on the card.
        ccfg = reduced
        copt = AdamWConfig(total_steps=6)
        cdata = SyntheticTokens(vocab_size=ccfg.vocab_size, seq_len=64,
                                global_batch=4)

        def trainer(path, total):
            st = init_state(torch.Generator(device=dev).manual_seed(0),
                            ccfg, copt, device=dev)
            return Trainer(
                TrainerConfig(total_steps=total, ckpt_dir=path,
                              ckpt_every=2, log_every=1),
                opaque_step(make_train_step(ccfg, copt)), st, cdata,
                put_batch=lambda b: {k: torch.from_numpy(v).to(dev)
                                     for k, v in b.items()})

        with tempfile.TemporaryDirectory() as tmp:
            straight = [trainer(os.path.join(tmp, f"s{k}"), 6)
                        for k in range(2)]
            runs = [t.run()["metrics"] for t in straight]
            repeat = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(straight[0].state),
                tree_leaves(straight[1].state)))
            trainer(os.path.join(tmp, "k"), 4).run()
            resumed = trainer(os.path.join(tmp, "k"), 6)
            check(resumed.try_resume() and resumed.step == 4,
                  f"{tag} (c): resumed at step {resumed.step}")
            after = resumed.run()["metrics"]
        want = [m["loss"] for m in runs[0][4:]]
        got = [m["loss"] for m in after]
        check(got == want, f"{tag} (c): losses after the resume {got} vs "
              f"the straight run's {want}")
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed.state), tree_leaves(straight[0].state))),
            f"{tag} (c): final state after the resume equals the straight "
            "run's bit for bit")
        log(f"{tag} (c): reduced {arch} bf16 on the card: 4 steps, "
            f"killed, resumed from the step-4 checkpoint, 2 more: losses "
            f"{got} and the final state equal a straight 6-step run bit for "
            f"bit; two straight runs bitwise equal: {repeat}")
        del straight, resumed

        # (e) gradient refusal on the card.
        eparams = init_state(torch.Generator(device=dev).manual_seed(0),
                             ccfg, copt, device=dev)["params"]
        ebatch = {k: torch.from_numpy(v).to(dev)
                  for k, v in cdata.batch(0).items()}
        q = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        x = torch.randn(8, 256, device=dev, requires_grad=True)
        refused = []
        cases = [("flash_attention", lambda: flash_attention(
                      q, q.detach(), q.detach())),
                 ("rmsnorm", lambda: rmsnorm(
                      x, torch.ones(256, device=dev)))]
        if ccfg.family != "ssm":            # xlstm has no attention
            cases.append(("loss_fn(attn_impl='flash')", lambda: M.loss_fn(
                eparams, ccfg, ebatch, attn_impl="flash")))
        for name, fn in cases:
            try:
                fn()
            except RuntimeError as e:
                check("no gradient" in str(e), f"{tag} (e): {name}: {e}")
                refused.append(name)
            else:
                check(False, f"{tag} (e): {name} gave a tensor without a "
                      f"gradient instead of raising")
        log(f"{tag} (e): a gradient through {refused} raises on the card")
    finally:
        signal.signal(signal.SIGTERM, prev_sigterm)
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, losses=losses, tokens_per_s=tok_s,
                peak_bytes=peak, n_params=n_params, breakdown=breakdown,
                **ce)


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
    served = record_served_keys()
    # The main path runs before any torch.profiler session: a process that
    # has traced the device pays more host time per launch afterwards, and
    # the chunk loop is launch-bound (PERF.md).
    with phase("clock"):
        clock_phase()
    with phase("parity"):
        parity_phase()
    with phase("combo-parity"):
        combo_parity_phase()
    with phase("full"):
        t0 = time.perf_counter()
        tl = full_timeline()
        log(f"full: timeline of {len(tl.names)} regions, "
            f"{len(tl.region_ids)} intervals, {tl.num_domains} rails, "
            f"t_exec={tl.t_exec:.3f} s (synthesized in "
            f"{time.perf_counter() - t0:.1f} s)")
        full = full_phase(tl)
    with phase("combo-full"):
        combo = combo_full_phase(tl)
    with phase("exchange"):
        exchange_phase(full.pop("agg"), combo.pop("agg"), smi)
    with phase("host-seam"):
        host_seam_phase()
    with phase("host-session"):
        host_session_phase(dev)
    with phase("energy"):
        energy = energy_phase(dev)
    with phase("sharding"), watchdog(600, "sharding phase"):
        sharding = sharding_phase(dev)
    with phase("kernel"):
        kernel_phase(dev)
        flash_row = flash_phase(dev)
        rmsnorm_row = rmsnorm_phase(dev)
    with phase("breakdown"):
        fold = breakdown_phase(tl)
        ech = energy.pop("chunk")
        energy_fold = fold_row(f"energy chunk k={ech.k}", ech.R, ech.C,
                               ech.ids, ech.pows, ech.valid)
        del ech
    with phase("combo-fold"):
        combo_fold = combo_fold_phase(combo)
    del tl, combo["chunk"]
    paths = {"energy_launches": energy["launches"],  # path -> launches
             "sharded_launches": sharding["launches"]}
    with phase(f"model {MODEL_ARCH}"):
        model = model_phase(dev)
        bd = model_breakdown(model)
        if bd:
            cost_model_line(model, bd["prefill_region_ms"])
        paths["launches"] = model["launches"]
    del model
    with phase(f"serve {MODEL_ARCH}"):
        paths["serve_launches"] = serve_phase(dev)["launches"]
    with phase(f"train {MODEL_ARCH}"), watchdog(600, "train phase"):
        paths["train_launches"] = train_phase(dev)["launches"]
    with phase(f"model {MOE_ARCH}"):
        moe = model_phase(dev, MOE_ARCH)
        model_breakdown(moe)
        paths["moe_launches"] = moe["launches"]
    del moe
    with phase(f"serve {MOE_ARCH}"):
        paths["moe_serve_launches"] = serve_phase(dev, MOE_ARCH)["launches"]
    with phase(f"train {MOE_ARCH}"), watchdog(600, "moe train phase"):
        paths["moe_train_launches"] = train_phase(dev, MOE_ARCH)["launches"]
    with phase(f"model {MOE30_ARCH}"):
        paths["moe30b_launches"] = model_phase(
            dev, MOE30_ARCH, depth=MOE30_DEPTH, steps=MOE30_DECODE
        )["launches"]
    with phase(f"model {VLM_ARCH}"):
        paths["vlm_launches"] = model_phase(
            dev, VLM_ARCH, patches=VLM_PATCHES)["launches"]
    with phase(f"serve {VLM_ARCH}"):
        paths["vlm_serve_launches"] = serve_phase(
            dev, VLM_ARCH, full=False)["launches"]
    with phase(f"loss {VLM_ARCH}"):
        vlm_loss_phase(dev)
    with phase(f"model {AUDIO_ARCH}"):
        paths["audio_launches"] = audio_phase(dev)["launches"]
    with phase(f"model {HYBRID_ARCH}"):
        hybrid = recurrent_model_phase(dev, HYBRID_ARCH)
        model_breakdown(hybrid)
        paths["hybrid_launches"] = hybrid["launches"]
    del hybrid
    with phase(f"serve {HYBRID_ARCH}"):
        paths["hybrid_serve_launches"] = serve_phase(
            dev, HYBRID_ARCH)["launches"]
    with phase(f"train {HYBRID_ARCH}"), watchdog(900, "hybrid train phase"):
        paths["hybrid_train_launches"] = train_phase(
            dev, HYBRID_ARCH)["launches"]
    with phase(f"model {SSM_ARCH}"):
        ssm = recurrent_model_phase(dev, SSM_ARCH)
        model_breakdown(ssm)
        slstm_breakdown(ssm)
        paths["xlstm_launches"] = ssm["launches"]
    del ssm
    log(f"xlstm_launches: {paths['xlstm_launches']['flash_attention']} "
        f"(xlstm has no attention)")
    with phase(f"serve {SSM_ARCH}"):
        paths["xlstm_serve_launches"] = serve_phase(dev, SSM_ARCH)["launches"]
    with phase(f"train {SSM_ARCH}"), watchdog(900, "ssm train phase"):
        paths["xlstm_train_launches"] = train_phase(dev, SSM_ARCH)["launches"]
    with phase("examples"):
        examples_phase()
    with phase("analysis"):
        analysis_phase(dev, served)

    split = fold.pop("split_ms")
    combo_fold.pop("split_ms")
    energy_fold.pop("split_ms")
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
    energy_path = dict(
        launches=energy["launches"]["sample_attr_fold"], **energy_fold,
        path=energy["path"], check=fold_check)

    def path_launches(kernel):
        return {k: v[kernel] for k, v in paths.items() if k != "launches"}

    kernels = [dict(
        name="sample_attr", route="cuda",
        source="src/repro_torch/kernels/sample_attr/sample_attr.cu",
        replaces="src/repro/kernels/sample_attr/sample_attr.py:80",
        **region_path, paths=[region_path, combo_path, energy_path],
        **path_launches("sample_attr_fold")),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:89",
             launches=paths["launches"]["flash_attention"], **flash_row,
             path=f"{MODEL_ARCH} prefill (one launch per layer); timed at "
                  f"B=4 H=16 KV=8 S=2048 dh=128 bf16 causal; moe_launches "
                  f"{MOE_ARCH}, moe30b_launches {MOE30_ARCH} (8 layers), "
                  f"vlm_launches {VLM_ARCH}, audio_launches {AUDIO_ARCH} "
                  f"(forward), hybrid_launches {HYBRID_ARCH} (one per "
                  f"group: the shared block), xlstm_launches {SSM_ARCH} "
                  f"(no attention), sharded_launches the same prefill "
                  f"under axis_rules on a 1x1 mesh (sharding phase)",
             **path_launches("flash_attention")),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:35",
             launches=paths["launches"]["rmsnorm"], **rmsnorm_row,
             path="not on the model path: the models normalise with "
                  "layers.rmsnorm, as the reference's do; timed at "
                  "[8192, 2048] bf16",
             **path_launches("rmsnorm"))]
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
