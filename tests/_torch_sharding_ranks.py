"""Rank bodies for the port's 4-rank sharding tests (spawned by
``tests/test_torch_sharding.py`` and ``tests/test_torch_pipeline.py``).

Each CPU rank joins a gloo group through a ``file://`` store under the
test's ``tmp_path`` (no port is bound), runs the same code, and rank 0
pickles what it measured to ``<root>/rank0.pkl``. Inputs come from numpy
with a seed; the weights from the port's seeded ``init_params``.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RANKS = 4


def spawn(fn, root, timeout=150.0):
    """Run ``fn(rank, root)`` in four fresh CPU processes and return what
    rank 0 pickled; fail (and stop them) if any raises or they outlive
    ``timeout``."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=(str(root),), nprocs=RANKS, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return pickle.loads((Path(root) / "rank0.pkl").read_bytes())


def _join(rank, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=RANKS)


def _dump(rank, root, out, name="rank0"):
    if rank == 0:
        with open(f"{root}/{name}.pkl", "wb") as f:
            pickle.dump(out, f)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _moe_cfg():
    from repro_torch.configs.registry import get_config
    # Dropless capacity: EP truncates per-shard, the local path globally —
    # equality needs no drops on either path.
    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(
        compute_dtype="float32")
    return cfg.replace(capacity_factor=float(cfg.n_experts / cfg.top_k))


def moe_train_step(root):
    """(2, 2) ("data", "model") mesh: the reduced qwen3-moe-30b-a3b train
    step (DP x TP x EP + FSDP state) against the single-process step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.dryrun import build_rules
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import axis_rules
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = _moe_cfg()
    opt_cfg = AdamWConfig(grad_clip=1e9)
    shape = ShapeConfig("t", 64, 8, "train")
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=8)
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}

    def fresh():
        return init_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                          device="cpu")
    step = make_train_step(cfg, opt_cfg)
    s_ref, m_ref = step(fresh(), batch)

    mesh = make_small_mesh(2, 2, device="cpu")
    rules = build_rules(cfg, shape, mesh)
    with axis_rules(rules):
        state = fresh()
        state = sp.distribute(state, sp.param_specs(state, rules, fsdp=True),
                              rules)
        b = sp.distribute(batch, sp.batch_specs(batch, rules), rules)
        s_dist, m_dist = make_train_step(cfg, opt_cfg)(state, b)
        got = [_full(t).detach() for t in tree_leaves(s_dist["params"])]
    want = [t.detach() for t in tree_leaves(s_ref["params"])]
    return {"loss_single": float(m_ref["loss"]),
            "loss_dist": float(m_dist["loss"]),
            "max_param_diff": max(float((a - b).abs().max())
                                  for a, b in zip(want, got)),
            "n_leaves": len(got),
            "rules": dict(rules.mapping)}


def dense_prefill_decode(root):
    """(2, 2) mesh: the reduced qwen3-1.7b prefill and a decode step under
    the rules (sharded params, batch and cache) against the unsharded
    ones, float32."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import build_rules
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import axis_rules
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen3-1.7b").reduced().replace(compute_dtype="float32")
    B, S, T = 4, 32, 40
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    p = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    f32 = torch.float32
    with torch.no_grad():
        lp, cache, cl = M.prefill(p, cfg, {"tokens": tokens}, T,
                                  cache_dtype=f32)
        ld, cache = M.decode_step(p, cfg, nxt, cache, S)
    mesh = make_small_mesh(2, 2, device="cpu")
    out = {}
    pre = build_rules(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    dec = build_rules(cfg, ShapeConfig("d", T, B, "decode"), mesh)
    with torch.no_grad():
        with axis_rules(pre):
            pd = sp.distribute(p, sp.param_specs(p, pre), pre)
            tb = sp.distribute({"tokens": tokens},
                               sp.batch_specs({"tokens": tokens}, pre), pre)
            lp2, cache2, _ = M.prefill(pd, cfg, tb, T, cache_dtype=f32)
            out["prefill_placements"] = str(lp2.placements)
            lp2 = _full(lp2)
            c_full = [_full(t) for t in tree_leaves(cache2)]
        with axis_rules(dec):
            pd = sp.distribute(p, sp.param_specs(p, dec), dec)
            plain = M.init_cache(cfg, B, T, dtype=f32, device="cpu")
            it = iter(c_full)
            plain = {"blocks": [{k: next(it) for k in sorted(c)}
                                for c in plain["blocks"]]}
            cd = sp.distribute(plain, sp.cache_specs(plain, dec), dec)
            nb = sp.distribute({"tokens": nxt},
                               sp.batch_specs({"tokens": nxt}, dec), dec)
            ld2, cd = M.decode_step(pd, cfg, nb["tokens"], cd, S)
            ld2 = _full(ld2)
            c2 = [_full(t) for t in tree_leaves(cd)]
    out["prefill_err"] = float((lp - lp2).abs().max())
    out["prefill_scale"] = float(lp.abs().max())
    out["cache_prefill_err"] = max(float((a - b).abs().max()) for a, b in
                                   zip(tree_leaves(M.prefill(
                                       p, cfg, {"tokens": tokens}, T,
                                       cache_dtype=f32)[1]), c_full))
    out["decode_err"] = float((ld - ld2).abs().max())
    out["cache_decode_err"] = max(float((a - b).abs().max())
                                  for a, b in zip(tree_leaves(cache), c2))
    return out


def moe_expert_parallel(root):
    """(2, 2) mesh: expert-parallel ``moe_ffn`` (experts over "model",
    tokens over "data") against the local dispatch, forward and
    gradient."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_rules
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import moe as MoE
    from repro_torch.sharding import params as sp
    from repro_torch.sharding.rules import axis_rules

    cfg = _moe_cfg()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model),
                                             np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model),
                                             np.float32))
    p = MoE.moe_init(torch.Generator().manual_seed(1), cfg)

    def run(params, xx, ww, gather):
        params = {k: v.detach().requires_grad_() for k, v in params.items()}
        xx = xx.detach().requires_grad_()
        y, aux = MoE.moe_ffn(params, cfg, xx)
        loss = (y * ww).sum() + aux
        loss.backward()
        return ([gather(y).detach(), gather(xx.grad)]
                + [gather(params[k].grad) for k in ("up", "gate", "down",
                                                    "router")])
    want = run(p, x, w, lambda t: t)
    mesh = make_small_mesh(2, 2, device="cpu")
    rules = build_rules(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    with axis_rules(rules):
        pd = sp.distribute({"moe": p}, sp.param_specs(
            {"blocks": [{"moe": p}]}, rules)["blocks"][0], rules)["moe"]
        xd = sp.distribute({"x": x, "w": w}, sp.batch_specs(
            {"x": x, "w": w}, rules), rules)
        got = run(pd, xd["x"], xd["w"], _full)
    names = ["y", "dx", "dup", "dgate", "ddown", "drouter"]
    return {n: float((a - b).abs().max()) for n, a, b in
            zip(names, want, got)} | {
        "scale_" + n: float(a.abs().max()) for n, a in zip(names, want)}


def numerics(rank, root):
    """Every numerics body in turn (one spawn for the file)."""
    _join(rank, root)
    out = {}
    for fn in (moe_train_step, dense_prefill_decode, moe_expert_parallel):
        out[fn.__name__] = fn(root)
        dist.barrier()
    _dump(rank, root, out)
    dist.destroy_process_group()


def pipeline(rank, root):
    """A 4-stage ``pipe`` mesh: ``pipeline_forward`` with L=8, D=16,
    B=12, M=6 against the sequential layers."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.pipeline import pipeline_forward

    _join(rank, root)
    L, D, B, M = 8, 16, 12, 6
    rng = np.random.default_rng(0)
    w = torch.from_numpy(0.3 * rng.standard_normal((L, D, D), np.float32))
    x = torch.from_numpy(rng.standard_normal((B, D), np.float32))

    def layer(wi, h):
        return torch.tanh(h @ wi)

    def stage_fn(ws, h):           # ws: [L/S, D, D]
        for wi in ws:
            h = layer(wi, h)
        return h

    ref = x
    for i in range(L):
        ref = layer(w[i], ref)
    mesh = make_mesh((RANKS,), ("pipe",), device="cpu")
    run = pipeline_forward(stage_fn, mesh, axis="pipe", n_micro=M)
    out = run(w, x)
    errs = [None] * RANKS
    dist.all_gather_object(errs, float((out - ref).abs().max()))
    _dump(rank, root, {"errs": errs})
    dist.destroy_process_group()
