"""How many elements rounding alone parts in chip_smoke's card-vs-CPU
training check, measured on the CPU between two runs that differ only by
rounding.

Run from the repository root:

    PYTHONPATH=src python scripts/train_rounding_witness.py \
        [--arch qwen3-1.7b xlstm-125m zamba2-1.2b ...]

Repeats train phase (b) of ``chip_smoke.py`` with a second CPU run in
the card's place: the reduced ``--arch`` in float32 (zamba2 with one
layer more, so that it has a tail), one initial state drawn by the port
from seed 0 (``init_state`` on the CPU), three steps of
``make_train_step`` on the same B=4 × 64 synthetic tokens (lr 3e-4,
warmup 2, 10 total), for ``accum_steps`` 1 and 2 and with compression.
The second run is the port again, from the same state with every
parameter moved by one ulp (``nextafter`` away from zero), a difference
of the size the card's summation order makes. (The JAX reference is no
such witness: its AdamW rounds the moments differently, so the
gradients recovered from them part on rows that got none, and its
reduced zamba2 trains to NaN, ROADMAP C8.)

It counts chip_smoke's rounding-led elements by chip_smoke's rules: the
first run's first gradient below 10·eps (the rule of every family); an
element whose gradient in some step (from each run's first moment)
differs by more than 1e-2 of the first run's (the rule of moe and the
recurrent families); and, with compression, an element whose residuals
are more than 1e-6 apart (an int8 code rounded apart), after each step.
Prints each count as a share of the elements, beside the largest
parameter difference outside them. Nothing is checked: this measures
only.
"""

from __future__ import annotations

import argparse

GRAD_ROUND_RTOL = 1e-2          # chip_smoke's TRAIN_GRAD_ROUND_RTOL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3-1.7b", "xlstm-125m", "zamba2-1.2b"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    def leaves(state, key):
        tree = state["opt"]["mu"] if key == "mu" else state[key]
        return [x.detach().numpy().astype(np.float64)
                for x in tree_leaves(tree)]

    for arch in args.arch:
        pcfg = get_config(arch).reduced()
        if pcfg.family == "hybrid" and not pcfg.n_layers % pcfg.attn_every:
            pcfg = pcfg.replace(n_layers=pcfg.n_layers + 1)
        pcfg = pcfg.replace(compute_dtype="float32")
        popt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
        data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=64,
                               global_batch=4)
        init = init_state(torch.Generator().manual_seed(0), pcfg, popt,
                          compression=True, device="cpu")
        for accum, comp in ((1, False), (2, False), (1, True)):
            start = {k: v for k, v in init.items()
                     if comp or k != "residuals"}
            a = tree_map(lambda t: t.detach().clone(), start)
            tree_map(lambda t: t.requires_grad_(), a["params"])
            pstep = make_train_step(pcfg, popt, accum_steps=accum,
                                    compression=comp)
            b = tree_map(lambda t: t.detach().clone(), start)
            b["params"] = tree_map(lambda t: torch.nextafter(
                t.detach(), torch.where(t < 0, -torch.inf, torch.inf)
            ).requires_grad_(), b["params"])
            mu0 = [[np.zeros_like(m) for m in leaves(a, "mu")]] * 2
            flips = []
            for i in range(3):
                batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in data.batch(i).items()}
                a, _ = pstep(a, batch)
                b, _ = pstep(b, batch)
                mu1 = [leaves(a, "mu"), leaves(b, "mu")]
                if i == 0:
                    first = [(np.abs(m / (1 - popt.b1)) < 10 * popt.eps)
                             & (m != 0) for m in mu1[0]]
                    grad = [np.zeros(m.shape, bool) for m in mu1[0]]
                ga, gb = ([(m - popt.b1 * m0) / (1 - popt.b1)
                           for m, m0 in zip(now, before)]
                          for now, before in zip(mu1, mu0))
                grad = [n | (np.abs(y - x) > GRAD_ROUND_RTOL * np.abs(x))
                        for n, x, y in zip(grad, ga, gb)]
                mu0 = mu1
                if comp:
                    apart = [np.abs(x - y) > 1e-6 for x, y in zip(
                        leaves(a, "residuals"), leaves(b, "residuals"))]
                    flipped = apart if i == 0 else [
                        f | d for f, d in zip(flipped, apart)]
                    flips.append(sum(int(f.sum()) for f in flipped))
            n_el = sum(m.size for m in first)
            extra = flipped if comp else [np.zeros(m.shape, bool)
                                          for m in first]
            n_first = sum(int((f | e).sum()) for f, e in zip(first, extra))
            noise = [f | g | e for f, g, e in zip(first, grad, extra)]
            n_grad = sum(int(m.sum()) for m in noise)
            d = [np.abs(x - y) for x, y in zip(leaves(a, "params"),
                                               leaves(b, "params"))]
            worst = max(float(x[~m].max()) if (~m).any() else 0.0
                        for x, m in zip(d, noise))
            print(f"{arch} reduced ({pcfg.n_layers} layers) float32, "
                  f"accum_steps {accum}, compression {comp}, port vs port "
                  f"one ulp apart on the CPU: rounding-led elements of "
                  f"{n_el}: {n_first} ({n_first / n_el:.3e}) by the "
                  f"first-gradient rule, {n_grad} ({n_grad / n_el:.3e}) "
                  f"with the gradient rule; parameters {worst:.3g} apart "
                  f"outside those (1e-2·lr = {1e-2 * popt.lr:.3g})"
                  + (f"; residuals more than 1e-6 apart after each step "
                     f"{flips} ("
                     + ", ".join(f"{f / n_el:.3e}" for f in flips)
                     + " of the elements)" if comp else ""), flush=True)


if __name__ == "__main__":
    main()
