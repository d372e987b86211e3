"""Serving demo of the PyTorch port: continuous-batching engine +
per-phase energy profiling.

The port of ``examples/serve_demo.py``. It serves a small causal LM
(reduced qwen3-1.7b, random weights from seed 0) with slot-based
continuous batching on the GPU, or on the CPU with ``--device cpu``, and
profiles prefill vs decode energy with the host-mode ALEA profiler.

    PYTHONPATH=src python examples/torch/serve_demo.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import resolve_device
from repro_torch.core import AttributionReport, EnergyProfiler
from repro_torch.core import regions as regions_mod
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request, ServeConfig


def main(argv=None):
    """Serve, print each request and the attribution table; returns
    ``(requests, done requests, estimates)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("qwen3-1.7b").reduced()
    # Matrices in the compute dtype, as the port's serve launcher holds them.
    params = M.cast_params(
        M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev), cfg)
    engine = Engine(cfg, params, ServeConfig(max_batch=4, max_len=128,
                                             eos_token=-1), device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        rng.integers(4, 12)).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]

    prof = EnergyProfiler(period=2e-3, device=dev)
    with prof.host_session() as sess:
        with regions_mod.region("serve"):
            done = engine.run_until_drained(reqs)
    est = sess.estimates()

    for r in done:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks → "
              f"{len(r.out_tokens)} generated")
    print(f"\ncompleted {len(done)}/{len(reqs)} requests")
    print("\nALEA per-phase attribution:")
    print(AttributionReport(est).table(top=8))
    return reqs, done, est


if __name__ == "__main__":
    main()
