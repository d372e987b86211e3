"""End-to-end training example of the PyTorch port: ~100M-parameter LM, a
few hundred steps, with checkpointing/restart, watchdog, and continuous
ALEA profiling.

The port of ``examples/train_lm.py``, on the GPU by default
(``--device cpu`` runs the plain PyTorch path). ``--smoke`` shrinks
everything for a quick sanity pass. Kill the process mid-run and rerun:
it resumes from the latest atomic checkpoint.

    PYTHONPATH=src python examples/torch/train_lm.py --smoke
    PYTHONPATH=src python examples/torch/train_lm.py --steps 300
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core import AttributionReport, EnergyProfiler
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step, opaque_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

# ~100M params: 12L × d768 × ff3072, 32k vocab.
LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_head=64, d_ff=3072, vocab_size=32000, remat="dots")


def main(argv=None):
    """Train and print the log and the attribution table; returns
    ``(trainer result, trainer)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = LM_100M
    if args.smoke:
        cfg = cfg.reduced()
        args.steps, args.batch, args.seq = 20, 4, 128

    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                       opt_cfg, device=dev)
    n = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"model: {cfg.name}  params: {n/1e6:.1f}M")

    step = opaque_step(make_train_step(cfg, opt_cfg))
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(args.steps // 4, 10), log_every=10)
    trainer = Trainer(tcfg, step, state, data,
                      put_batch=lambda b: {k: torch.from_numpy(v).to(dev)
                                           for k, v in b.items()})
    if trainer.try_resume():
        print(f"resumed from checkpoint at step {trainer.step}")

    prof = EnergyProfiler(period=5e-3, device=dev)
    with prof.host_session() as sess:
        result = trainer.run()
    est = sess.estimates()

    for m in result["metrics"]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e} {m['step_time_s']*1e3:.0f}ms")
    print(f"\nstragglers: {result['straggler_events']}")
    print("\nALEA energy attribution (host run):")
    print(AttributionReport(est).table(top=8))
    return result, trainer


if __name__ == "__main__":
    main()
