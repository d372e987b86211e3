"""The loss trajectory of the JAX reference's train step and the port's,
from one initial state, on the CPU.

Run from the repository root (both packages on the path):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_trajectory.py \
        [--arch xlstm-125m] [--reduced] [--batch 4] [--seq 128] \
        [--steps 8] [--dtype float32]

Draws the reference's initial state (``init_state`` from PRNGKey(0)),
converts it for the port (``convert.train_state_from_jax``) and runs
``--steps`` steps of each package's ``make_train_step`` on the same
``SyntheticTokens`` batches with the training launcher's optimizer
schedule (lr 3e-4, ``total_steps=--steps``, ``warmup_steps=max(steps //
20, 5)``). Prints each step's loss from both and, at the end, each
package's loss on the last step's batch with the initial weights (a
loss that does not fall over the run shows up in both). Without
``--reduced`` the config is the full one: mind the host's memory.

Two witnesses tell a fault of the port from the run's own sensitivity
to rounding, once the trajectories part:

- ``--resync``: before each step the port takes the reference's state
  as it stands, so each step starts from one state on both sides. Prints
  the two losses of that state and, after the step, how far the port's
  parameters are from the reference's (the largest difference, and the
  share of elements more than 1e-2·lr apart). A fault moves every step;
  rounding moves a few elements, by about an lr.
- ``--perturb``: a second reference run from the same state with every
  parameter moved by one ulp (``nextafter`` away from zero). Prints both
  reference runs' losses each step: how far the reference parts from
  itself through rounding alone.

Nothing is checked: this measures only.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--resync", action="store_true")
    ap.add_argument("--perturb", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import registry as r_registry
    from repro.models import model as r_model
    from repro.optim import adamw as r_adamw
    from repro.train import step as r_step
    from repro_torch.configs import registry as p_registry
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model as p_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    def cfg_of(registry):
        cfg = registry.get_config(args.arch)
        return (cfg.reduced() if args.reduced else cfg).replace(
            compute_dtype=args.dtype)
    rcfg, pcfg = cfg_of(r_registry), cfg_of(p_registry)
    kw = dict(lr=3e-4, total_steps=args.steps,
              warmup_steps=max(args.steps // 20, 5))
    ropt, popt = r_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rs = jax.tree.map(np.asarray, jax.jit(
        lambda k: r_step.init_state(k, rcfg, ropt))(jax.random.PRNGKey(0)))
    init = rs["params"]
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    pstep = make_train_step(pcfg, popt)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)
    # The perturbed reference run: every parameter one ulp further from 0.
    qs = dict(rs, params=jax.tree.map(
        lambda x: np.nextafter(x, np.where(x < 0, -np.inf, np.inf)
                               .astype(x.dtype)), init)
    ) if args.perturb else None
    print(f"{args.arch}{' reduced' if args.reduced else ''} {args.dtype} "
          f"B={args.batch} S={args.seq}, {args.steps} steps, {kw}"
          + (", resync" if args.resync else "")
          + (", perturbed reference" if args.perturb else ""))
    for i in range(args.steps):
        b = data.batch(i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if args.resync:
            ps = train_state_from_jax(jax.tree.map(np.asarray, rs), pcfg,
                                      device="cpu")
        rs, rm = rstep(rs, jb)
        ps, pm = pstep(ps, {k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in b.items()})
        lr = float(rm["lr"])
        line = (f"step {i + 1}: reference {float(rm['loss']):.6f} port "
                f"{float(pm['loss']):.6f} lr {lr:.3g}")
        if args.resync:
            want = tree_leaves(params_from_jax(
                jax.tree.map(np.asarray, rs["params"]), pcfg, device="cpu"))
            got = tree_leaves(ps["params"])
            d = [(g.detach() - w).abs() for g, w in zip(got, want)]
            n_el = sum(x.numel() for x in d)
            n_out = sum(int((x > 1e-2 * lr).sum()) for x in d)
            line += (f"; after the step from the reference's state, port "
                     f"vs reference parameters: max "
                     f"{max(float(x.max()) for x in d):.3g}, {n_out} of "
                     f"{n_el} elements ({n_out / n_el:.3g}) more than "
                     f"1e-2·lr apart")
        if args.perturb:
            qs, qm = rstep(qs, jb)
            line += f"; perturbed reference {float(qm['loss']):.6f}"
        print(line, flush=True)
    last = data.batch(args.steps - 1)
    r0 = float(r_model.loss_fn(init, rcfg, {
        k: jnp.asarray(v) for k, v in last.items()})[0])
    with torch.no_grad():
        p0 = float(p_model.loss_fn(
            params_from_jax(init, pcfg, device="cpu"), pcfg,
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in last.items()})[0])
    print(f"the initial weights on the last step's batch: reference "
          f"{r0:.6f} port {p0:.6f}")


if __name__ == "__main__":
    main()
