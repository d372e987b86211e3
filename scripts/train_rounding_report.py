"""Where a train step's parameters part between the GPU and the CPU.

Run from the repository root on a machine with a GPU:

    python3 scripts/train_rounding_report.py [--arch granite-moe-1b-a400m]
        [--accum 2] [--top 8]

Runs chip_smoke's card-vs-CPU training comparison (train phase (b)):
the reduced ``--arch`` in float32, one initial state drawn on the CPU
from seed 0 and copied to the card, three steps of ``make_train_step``
on each (B=4 × 64 synthetic tokens, lr 3e-4, warmup 2,
``accum_steps=--accum``). Then, for the ``--top`` elements whose
parameters part the most outside the first-step rule's rounding-led
elements (first gradient below 10·eps), it prints each step's gradient
(recovered from the first moment) and Adam's normalised update
``m̂/(√v̂+eps)`` on both devices: where a gradient is a cancellation of
larger terms, the devices' rounding is a visible share of it, and the
update, which divides by the gradient's own scale, carries that share.
The card's name and power limit lead the output. Nothing is checked:
this measures only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("train_rounding_report: torch sees no GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import stacked_paths, tree_leaves, tree_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch).reduced().replace(compute_dtype="float32")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=4)
    cpu = init_state(torch.Generator().manual_seed(0), cfg, opt,
                     device="cpu")
    gpu = tree_map(lambda t: t.detach().to(dev, copy=True), cpu)
    tree_map(lambda t: t.requires_grad_(), gpu["params"])
    step = make_train_step(cfg, opt, accum_steps=args.accum)
    paths = stacked_paths(cpu["params"])
    hist = {"cpu": [], "gpu": []}       # per step: (mu, nu, params)
    for i in range(3):
        b = {k: torch.from_numpy(v.copy()) for k, v in data.batch(i).items()}
        cpu, _ = step(cpu, b)
        gpu, _ = step(gpu, {k: v.to(dev) for k, v in b.items()})
        for name, st in (("cpu", cpu), ("gpu", gpu)):
            hist[name].append([[t.detach().cpu().clone()
                                for t in tree_leaves(tree)]
                               for tree in (st["opt"]["mu"],
                                            st["opt"]["nu"], st["params"])])
    noise = [((m / (1 - opt.b1)).abs() < 10 * opt.eps) & (m != 0)
             for m in hist["cpu"][0][0]]
    diffs = [(a - b).abs() for a, b in zip(hist["cpu"][2][2],
                                           hist["gpu"][2][2])]
    worst = []
    for li, (d, m) in enumerate(zip(diffs, noise)):
        d = d.masked_fill(m, 0).flatten()
        top = torch.topk(d, min(args.top, d.numel()))
        worst += [(v, li, j) for v, j in zip(top.values.tolist(),
                                             top.indices.tolist())]
    print(f"{cfg.name} float32, accum_steps {args.accum}: the {args.top} "
          f"elements parted most (after 3 steps; atol 1e-2·lr = "
          f"{1e-2 * opt.lr:.3g}) outside {sum(int(m.sum()) for m in noise)}"
          f" first-step rounding-led elements")
    for v, li, j in sorted(worst, reverse=True)[:args.top]:
        line = [f"{v:.3g} {'/'.join(map(str, paths[li]))}[{j}]"]
        for name in ("cpu", "gpu"):
            gs, us, prev = [], [], 0.0
            for s in range(3):
                mu = hist[name][s][0][li].flatten()[j].item()
                nu = hist[name][s][1][li].flatten()[j].item()
                gs.append((mu - opt.b1 * prev) / (1 - opt.b1))
                prev = mu
                bc1, bc2 = 1 - opt.b1 ** (s + 1), 1 - opt.b2 ** (s + 1)
                us.append((mu / bc1) / ((nu / bc2) ** 0.5 + opt.eps))
            line.append(f"{name}: gradient per step "
                        f"{[f'{g:.3g}' for g in gs]}, update "
                        f"{[f'{u:.4g}' for u in us]}")
        print("  " + " | ".join(line))


if __name__ == "__main__":
    main()
