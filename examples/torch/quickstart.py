"""Quickstart of the PyTorch port: fine-grain energy profiling of a real
training loop.

The port of ``examples/quickstart.py``. It runs a small LM training loop
(reduced qwen3-1.7b) on the GPU, or on the CPU with ``--device cpu``,
under ALEA's host-mode profiler: a control thread samples a region marker
and the best available power sensor (the §4.8 architecture). Then it
prints the per-region energy attribution table with confidence
intervals.

    PYTHONPATH=src python examples/torch/quickstart.py [--steps 30] \\
        [--device cpu]
"""

import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import resolve_device
from repro_torch.core import AttributionReport, EnergyProfiler
from repro_torch.core import regions as regions_mod
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step, opaque_step


def main(argv=None):
    """Train, profile, print the table; returns (final loss, estimates)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("qwen3-1.7b").reduced()
    opt_cfg = AdamWConfig(total_steps=args.steps)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                       opt_cfg, device=dev)
    # The reference jits the step; opaque_step is its counterpart (the
    # step's inner regions label the trace and take no samples).
    step = opaque_step(make_train_step(cfg, opt_cfg))
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=128,
                           global_batch=8)

    prof = EnergyProfiler(period=2e-3, jitter=3e-4, device=dev)
    with prof.host_session() as sess:
        for i in range(args.steps):
            with regions_mod.region("data_load"):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.batch(i).items()}
            with regions_mod.region("train_step"):
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])     # waits for the device
    est = sess.estimates()
    print(f"\nfinal loss: {loss:.4f}")
    print(f"samples: {est.n_total}  wall: {est.t_exec:.2f}s\n")
    print(AttributionReport(est).table())
    hot = est.dominant(1)[0]
    print(f"\nhotspot: {hot.name} — {hot.p_hat*100:.0f}% of time, "
          f"{hot.e_hat:.1f} J estimated")
    return loss, est


if __name__ == "__main__":
    main()
