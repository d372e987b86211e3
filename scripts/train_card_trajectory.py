"""The training launcher's loss trajectory on the card, in bf16 and in
float32, and the port's train step on the card against the same step on
the CPU, at full width.

Run from the repository root on a machine with a GPU:

    python3 scripts/train_card_trajectory.py

(1) xlstm-125m, for compute dtypes bfloat16 (the launcher's) and
    float32: the launcher's initial state (``init_state`` drawn on the
    card from seed 0), its optimizer schedule (lr 3e-4, 8 total steps,
    warmup 5) and its ``SyntheticTokens`` batches (B=8 × 512), 8 steps
    of ``make_train_step``. Prints each step's loss and the loss of the
    initial and of the trained weights on the first and on the last
    step's batch.
(2) Float32, one initial state drawn on the CPU from seed 0: before each
    of 3 steps the card takes the CPU's state, so both start each step
    from one state. Prints both losses and how far the card's parameters
    are from the CPU's after the step (the largest difference, the share
    of elements more than 1e-2·lr apart).

The card's name and power limit lead the output. Nothing is checked:
this measures only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, CPU_STEPS = "xlstm-125m", 8, 3
BATCH, SEQ = 8, 512                     # the launcher's defaults


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_card_trajectory: torch sees no GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = get_config(ARCH)
    opt = AdamWConfig(lr=3e-4, total_steps=STEPS,
                      warmup_steps=max(STEPS // 20, 5))
    data = SyntheticTokens(vocab_size=base.vocab_size, seq_len=SEQ,
                           global_batch=BATCH)

    def on(device, b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def held(params, cfg, device):
        with torch.no_grad():
            return [float(M.loss_fn(params, cfg,
                                    on(device, data.batch(i)))[0])
                    for i in (0, STEPS - 1)]

    for dtype in ("bfloat16", "float32"):
        cfg = base.replace(compute_dtype=dtype)
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           opt, device=dev)
        init = tree_map(lambda t: t.detach().clone(), state["params"])
        step = make_train_step(cfg, opt)
        losses = []
        t0 = time.perf_counter()
        for i in range(STEPS):
            state, m = step(state, on(dev, data.batch(i)))
            losses.append(float(m["loss"]))
        s = time.perf_counter() - t0
        h0, h1 = held(init, cfg, dev), held(state["params"], cfg, dev)
        print(f"(1) {ARCH} {dtype} on the card, the launcher's state "
              f"and schedule, B={BATCH} S={SEQ}, {STEPS} steps in "
              f"{s:.1f} s: losses " + " ".join(f"{x:.6f}" for x in losses)
              + f"; the first batch: initial {h0[0]:.6f}, trained "
              f"{h1[0]:.6f}; the last step's batch: initial {h0[1]:.6f}, "
              f"trained {h1[1]:.6f}", flush=True)
        del state, init, step
        torch.cuda.empty_cache()

    cfg = base.replace(compute_dtype="float32")
    cpu = init_state(torch.Generator().manual_seed(0), cfg, opt,
                     device="cpu")
    step = make_train_step(cfg, opt)
    for i in range(CPU_STEPS):
        card = tree_map(lambda t: t.detach().to(dev, copy=True), cpu)
        tree_map(lambda t: t.requires_grad_(), card["params"])
        b = data.batch(i)
        t0 = time.perf_counter()
        cpu, mc = step(cpu, on("cpu", b))
        s = time.perf_counter() - t0
        card, mg = step(card, on(dev, b))
        lr = float(mc["lr"])
        d = [(g.detach().cpu() - c.detach()).abs() for g, c in
             zip(tree_leaves(card["params"]), tree_leaves(cpu["params"]))]
        n_el = sum(x.numel() for x in d)
        n_out = sum(int((x > 1e-2 * lr).sum()) for x in d)
        print(f"(2) {ARCH} float32 step {i + 1} from one state: loss "
              f"card {float(mg['loss']):.6f} CPU {float(mc['loss']):.6f}; "
              f"parameters after the step: max "
              f"{max(float(x.max()) for x in d):.3g} apart, {n_out} of "
              f"{n_el} elements ({n_out / n_el:.3g}) more than 1e-2·lr = "
              f"{1e-2 * lr:.3g} apart (CPU step {s:.1f} s)", flush=True)
        del card


if __name__ == "__main__":
    main()
