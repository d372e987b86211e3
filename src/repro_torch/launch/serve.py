"""Serving launcher: continuous batching + per-phase energy attribution.

Port of ``src/repro/launch/serve.py``, with ``--device`` (the GPU by
default; ``cpu`` runs the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --requests 8 --new-tokens 16

The weights are random, drawn on the device from seed 0, and held in
the compute dtype (``model.cast_params``).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import resolve_device
from repro_torch.core import AttributionReport, EnergyProfiler
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request, ServeConfig


def make_requests(cfg, n: int, new_tokens: int, seed: int = 0):
    """The launcher's traffic: ``n`` requests with prompts of 4-15 random
    tokens, each asking for ``new_tokens`` tokens."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(4, 16)))
                    .astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(n)]


def main(argv=None):
    """Serve the requests, print the served count and the attribution
    table; returns ``(done requests, engine, host session)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.cast_params(M.init_params(gen, cfg, device=dev), cfg)
    engine = Engine(cfg, params,
                    ServeConfig(max_batch=args.max_batch,
                                max_len=args.max_len, eos_token=-1),
                    device=dev)
    reqs = make_requests(cfg, args.requests, args.new_tokens)

    prof = EnergyProfiler(period=2e-3, device=dev)
    with prof.host_session() as sess:
        done = engine.run_until_drained(reqs)
    print(f"served {len(done)}/{len(reqs)} requests "
          f"({sum(len(r.out_tokens) for r in done)} tokens)")
    print(AttributionReport(sess.estimates()).table(top=8))
    return done, engine, sess


if __name__ == "__main__":
    main()
