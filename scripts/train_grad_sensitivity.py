"""How far rounding alone moves xlstm-125m's training gradient at full
width, in the JAX reference and in the port, on the CPU.

Run from the repository root (both packages on the path):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_grad_sensitivity.py

Trains the reference 3 steps from its initial state
(``init_state`` from PRNGKey(0); lr 3e-4, 8 total steps, warmup 5, the
training launcher's schedule) on its ``SyntheticTokens`` batches (B=8 ×
512), in float32.
At that state, on the next batch, it takes the loss's gradient several ways
and prints the relative distance (‖a − b‖ / ‖b‖ over every parameter)
between them:

- the reference's ``loss_fn`` under ``jax.grad`` and ``jax.jit`` (as its
  train step takes it), against the same parameters one ulp apart;
- the reference's ``loss_fn``, against the reference's blocks chained
  by hand: the embedding, each xLSTM pair's ``jax.vjp`` called eagerly,
  then the final norm, the head and the mean cross-entropy;
- the port's ``loss_fn`` under autograd, against the port's blocks
  chained the same way; and the two chains against each other, with the
  relative distance of their activations after each pair.

Nothing is checked: this measures only.
"""

from __future__ import annotations

STEPS, BATCH, SEQ = 3, 8, 512


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import registry as r_registry
    from repro.models import model as r_model
    from repro.models import transformer as r_tb
    from repro.models.layers import norm as r_norm
    from repro.optim import adamw as r_adamw
    from repro.train import step as r_step
    from repro_torch.configs import registry as p_registry
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model as p_model
    from repro_torch.models import transformer as p_tb
    from repro_torch.tree import tree_leaves

    arch = "xlstm-125m"
    rcfg = r_registry.get_config(arch).replace(compute_dtype="float32")
    pcfg = p_registry.get_config(arch).replace(compute_dtype="float32")
    ropt = r_adamw.AdamWConfig(lr=3e-4, total_steps=8, warmup_steps=5)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=SEQ,
                           global_batch=BATCH)
    rs = jax.jit(lambda k: r_step.init_state(k, rcfg, ropt))(
        jax.random.PRNGKey(0))
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    for i in range(STEPS):
        rs, _ = rstep(rs, {k: jnp.asarray(v)
                           for k, v in data.batch(i).items()})
    P = jax.tree.map(np.asarray, rs["params"])
    b = data.batch(STEPS)
    toks, labels = b["tokens"], b["labels"]
    rb = {k: jnp.asarray(v) for k, v in b.items()}

    def rel(a, b):
        a, b = list(a), list(b)
        return (sum(float(np.sum((np.asarray(x, np.float64)
                                  - np.asarray(y, np.float64)) ** 2))
                    for x, y in zip(a, b))
                / sum(float(np.sum(np.asarray(y, np.float64) ** 2))
                      for y in b)) ** 0.5

    def as_port(tree):          # reference layout → the port's leaves
        return [t.detach().numpy() for t in tree_leaves(
            params_from_jax(jax.tree.map(np.asarray, tree), pcfg,
                            device="cpu"))]

    rgrad = jax.jit(jax.grad(lambda p: r_model.loss_fn(p, rcfg, rb)[0]))
    g_ref = rgrad(jax.tree.map(jnp.asarray, P))
    ulp = jax.tree.map(lambda x: np.nextafter(
        x, np.where(x < 0, -np.inf, np.inf).astype(x.dtype)), P)
    g_ulp = rgrad(jax.tree.map(jnp.asarray, ulp))

    # The reference's chain: its pairs' vjps called one by one.
    n_pairs = rcfg.n_layers // 2
    pair = [jax.tree.map(lambda a: jnp.asarray(a[k]), P["pairs"])
            for k in range(n_pairs)]
    xs = [jnp.asarray(P["embed"])[toks]]
    vjps = []
    for k in range(n_pairs):
        x, vjp = jax.vjp(lambda p, x: r_tb.xlstm_pair_forward(
            p, rcfg, x, None)[0], pair[k], xs[-1])
        xs.append(x)
        vjps.append(vjp)

    def head(x):
        h = r_norm(jax.tree.map(jnp.asarray, P["final_norm"]), x,
                   kind=rcfg.norm_kind, eps=rcfg.norm_eps)
        logits = h @ jnp.asarray(P["lm_head"])
        return jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jnp.asarray(labels)[..., None], -1)[..., 0])

    g = jax.grad(head)(xs[-1])
    for k in reversed(range(n_pairs)):
        _, g = vjps[k](g)
    embed_ref = np.zeros(P["embed"].shape, np.float32)
    np.add.at(embed_ref, toks.reshape(-1),
              np.asarray(g).reshape(-1, pcfg.d_model))

    # The port's whole gradient and its chain.
    pp = params_from_jax(P, pcfg, device="cpu")
    leaves = tree_leaves(pp)
    for t in leaves:
        t.requires_grad_()
    pl = p_model.loss_fn(pp, pcfg, {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in b.items()})[0]
    g_port = [t.numpy() for t in torch.autograd.grad(pl, leaves)]
    del pl
    px = [torch.from_numpy(np.array(xs[0])).requires_grad_()]
    outs = []
    for k in range(n_pairs):
        out = p_tb.xlstm_pair_forward(pp["pairs"][k], pcfg, px[-1], None)[0]
        outs.append(out)
        px.append(out.detach().requires_grad_())
    with torch.no_grad():
        cot = torch.from_numpy(np.asarray(jax.grad(head)(
            jnp.asarray(px[-1].numpy()))))
    for k in reversed(range(n_pairs)):
        (cot,) = torch.autograd.grad(outs[k], [px[k]], cot)
    embed_port = torch.zeros(P["embed"].shape).index_add_(
        0, torch.from_numpy(toks.reshape(-1).astype(np.int64)),
        cot.reshape(-1, pcfg.d_model)).numpy()
    i_embed = next(i for i, t in enumerate(leaves) if t is pp["embed"])

    print(f"{arch} float32, B={BATCH} S={SEQ}, the reference's state "
          f"after {STEPS} steps, batch {STEPS}:")
    print(f"  reference jit vs the same at parameters one ulp apart: "
          f"{rel(as_port(g_ulp), as_port(g_ref)):.3g}")
    print(f"  port vs reference (each loss_fn's whole gradient): "
          f"{rel(g_port, as_port(g_ref)):.3g}")
    print(f"  embedding gradient: reference loss_fn vs the reference's "
          f"chain {rel([np.asarray(g_ref['embed'])], [embed_ref]):.3g}; "
          f"port loss_fn vs the port's chain "
          f"{rel([g_port[i_embed]], [embed_port]):.3g}; the port's chain "
          f"vs the reference's {rel([embed_port], [embed_ref]):.3g}")
    print("  activations after each pair, the port's chain vs the "
          "reference's: " + ", ".join(
              f"{rel([px[k + 1].detach().numpy()], [xs[k + 1]]):.3g}"
              for k in range(n_pairs)))


if __name__ == "__main__":
    main()
