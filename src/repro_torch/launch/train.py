"""Training launcher: ``--arch <id>`` selectable configs.

Port of ``src/repro/launch/train.py`` on one card, with ``--device`` (the
GPU by default; ``cpu`` runs the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu

``--smoke`` shrinks the config for a laptop-scale sanity pass. The
weights are random, drawn on the device from seed 0. ALEA host-mode
profiling is on by default (the paper's capped-overhead continuous
profiling), with the step run inside ``regions.opaque()``
(:func:`repro_torch.train.step.opaque_step`, the counterpart of the
reference's ``jax.jit``).

``--mesh DxM`` (or ``PxDxM``) trains sharded: the state becomes DTensors
placed by ``param_specs(state, rules, fsdp=True)`` and the step runs
under ``axis_rules(make_rules(mesh))``, as the reference's does. One
process per rank: ``torchrun --nproc-per-node=N -m
repro_torch.launch.train --mesh DxM ...`` sets up the process group
(NCCL on the GPU, gloo with ``--device cpu``), whose world size must be
D·M; ``--mesh 1x1`` in a plain process sets up a world of one.
Checkpoints hold whole tensors (rank 0 writes), so a sharded run's
checkpoint restores into an unsharded run and back.
"""

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import resolve_device
from repro_torch.core import AttributionReport, EnergyProfiler
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import parse_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import params as sp
from repro_torch.sharding.rules import axis_rules, make_rules
from repro_torch.train.step import init_state, make_train_step, opaque_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves


def main(argv=None):
    """Train, print the parameter count, the attribution table and the
    last logged steps; returns ``(trainer result, host session or None,
    trainer)`` (the session is None under ``--no-profile``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 or 2x16x16")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--compression", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between the metrics the result logs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        args.steps = min(args.steps, 20)
        args.batch, args.seq = 4, 128
    if cfg.embed_inputs:
        raise SystemExit(f"{args.arch} is encoder-only with a stub frontend;"
                         " use the masked-prediction example instead")
    dev = resolve_device(args.device)
    if args.mesh and dist.is_initialized() and dev.type == "cuda":
        # torchrun's ranks: one card each
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parse_mesh(args.mesh, device=dev)
    rules = make_rules(mesh) if mesh else None
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    ctx = axis_rules(rules) if rules is not None else contextlib.nullcontext()
    with ctx:
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           opt_cfg, compression=args.compression,
                           device=dev)
        put = lambda b: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                         for k, v in b.items()}
        if rules is not None:
            state = sp.distribute(state, sp.param_specs(state, rules,
                                                        fsdp=True), rules)

            def put(b, _put=put):
                b = _put(b)
                return sp.distribute(b, sp.batch_specs(b, rules), rules)
        step = opaque_step(make_train_step(cfg, opt_cfg,
                                           compression=args.compression))
        n = sum(x.numel() for x in tree_leaves(state["params"]))
        print(f"arch={cfg.name} params={n/1e6:.1f}M steps={args.steps}")

        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
        trainer = Trainer(
            TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 4, 10),
                          log_every=args.log_every),
            step, state, data, put_batch=put)
        if trainer.try_resume():
            print(f"resumed at step {trainer.step}")

        sess = None
        if args.no_profile:
            result = trainer.run()
        else:
            prof = EnergyProfiler(period=5e-3, device=dev)
            with prof.host_session() as sess:
                result = trainer.run()
            print(AttributionReport(sess.estimates()).table(top=10))

    for m in result["metrics"][-5:]:
        print(f"step {m['step']:6d} loss {m['loss']:.4f} "
              f"({m['step_time_s']*1e3:.0f} ms)")
    print(f"stragglers: {result['straggler_events']}")
    return result, sess, trainer


if __name__ == "__main__":
    main()
