"""Where a serving decode step's time goes, on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python3 scripts/serve_step_breakdown.py [--steps 32] [--arch qwen3-1.7b]

Builds the model at full size (bf16, random weights from seed 0), fills
four slots of a 256-position cache and times, in ms per step (host clock
around steps that each end in a host read of the argmax, as the engine's
do), in turns:

* ``model``    — ``model.decode_step`` with the lengths on the device and
                 no write mask (the chip_smoke model phase's step);
* ``masked``   — the same with a write mask (the engine's step function,
                 which also restores the masked-off rows);
* ``engine``   — ``Engine.step`` with four requests in flight (the host
                 copies of tokens, lengths and mask, the step, the argmax
                 read and the scheduler's bookkeeping);
* ``engine+sampler`` — the same inside a host session whose sampler
                 thread reads the host sensor every 2 ms (the launcher's
                 setting), and at 10 ms.

Each variant runs twice, in the order model, masked, engine, sampler 2 ms,
sampler 10 ms, then back; the card's name and power limit lead the
output. Nothing is checked: this measures only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_step_breakdown: torch sees no GPU")
    from repro_torch.configs.registry import get_config
    from repro_torch.core.profiler import EnergyProfiler
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    g = torch.Generator(device=dev).manual_seed(0)
    params = M.cast_params(M.init_params(g, cfg, device=dev), cfg)
    B, T, n = 4, 256, args.steps
    # Long requests, so no slot empties within the measured steps.
    rng = np.random.default_rng(0)

    def engine():
        eng = Engine(cfg, params, ServeConfig(max_batch=B, max_len=T,
                                              eos_token=-1), device=dev)
        for i in range(B):
            eng.add_request(Request(i, rng.integers(
                1, cfg.vocab_size, 8).astype(np.int32),
                max_new_tokens=10 * n))
        return eng

    cache = engine().cache
    tok = torch.ones((B, 1), dtype=torch.int64, device=dev)
    cur = torch.full((B,), 8, dtype=torch.int32, device=dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)

    def model_step(write_mask):
        def step():
            logits, _ = M.decode_step(params, cfg, tok, cache, cur,
                                      write_mask=write_mask)
            logits[:, -1].argmax(-1).cpu()
        return step

    def timed(step):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def in_session(period):
        def run():
            eng = engine()
            with EnergyProfiler(period=period, device=dev).host_session():
                return timed(eng.step)
        return run

    variants = [("model", lambda: timed(model_step(None))),
                ("masked", lambda: timed(model_step(mask))),
                ("engine", lambda: timed(engine().step)),
                ("engine+sampler 2 ms", in_session(2e-3)),
                ("engine+sampler 10 ms", in_session(10e-3))]
    results = {name: [] for name, _ in variants}
    for order in (variants, variants[::-1]):
        for name, run in order:
            results[name].append(run())
    for name, _ in variants:
        ms = results[name]
        print(f"{name}: " + " / ".join(f"{m:.3f}" for m in ms)
              + f" ms per step (B={B}, {T} positions, {n} steps a run)",
              flush=True)


if __name__ == "__main__":
    main()
