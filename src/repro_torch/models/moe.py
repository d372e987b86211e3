"""Top-k MoE with capacity-based dispatch, on one card.

Port of ``src/repro/models/moe.py``, its local path: all experts on one
device. The router runs in float32 (softmax, top-k, renormalisation and
the Switch load-balance loss); the experts run either

  * on a capacity gather (:func:`_dispatch_local`; forward and prefill):
    each expert takes its top-capacity tokens by combine weight, runs its
    FFN on the gathered slab and the weighted outputs are combined per
    token (tokens over an expert's capacity are dropped and pass through
    on the residual path); or
  * dropless (:func:`_dispatch_dense`; decode): each token runs its own
    top-k experts' weights, gathered per token, so a row's output never
    depends on the other rows of the batch.

Two points where PyTorch differs from XLA shape the code:

* **Ties.** ``jax.lax.top_k`` breaks ties by the lower index;
  ``torch.topk`` promises no order. Both selections (the router's top-k
  experts and each expert's top-capacity tokens) go through a stable
  descending sort, which keeps the lower index first. Every token an
  expert does not route scores 0, so an expert whose capacity exceeds
  its routed count fills the slab with tied zero-weight picks: those
  contribute exactly 0 and are the same tokens as the reference's.
* **No float atomics.** The reference combines with a scatter-add
  (``y.at[tok_idx].add``) and the slab gather's gradient is another; on
  CUDA those are float atomics, so two runs would differ in the last
  bits. Here each token finds its (at most k) slab rows through an
  inverse map and sums them in a fixed order, and both the slab gather
  and the combine are :class:`_RowGather` calls, whose backward is
  the same gather the other way round.

Expert parallelism (the reference's ``shard_map`` branch) runs whenever
the rules in force (:func:`repro_torch.sharding.rules.axis_rules`) map
``experts`` to a mesh axis: each rank keeps its DP shard of the tokens
(whole over the expert axis) and its block of ``E / n`` experts, runs the
capacity gather over those experts alone (capacity from the per-DP-shard
token count; dropless means capacity = that count), and one all-reduce
over the expert axis sums the ranks' partial outputs. That all-reduce is
:func:`repro_torch.sharding.rules.psum_whole`, whose backward passes
the (already whole) gradient through, so training works; the combine stays free of float
atomics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models.layers import Params, dense_init
from repro_torch.sharding.rules import (P, current_rules, mesh_shape,
                                       placements, psum_whole, whole_middle,
                                       whole_middle_grad)

__all__ = ["moe_init", "moe_ffn", "router"]


def moe_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The router [d, E] and the expert stacks up/gate [E, d, ff] and
    down [E, ff, d], float32, drawn from ``generator``."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def stack(d_in, d_out):
        return torch.stack([dense_init(generator, d_in, d_out)
                            for _ in range(E)])
    return {"router": dense_init(generator, d, E),
            "up": stack(d, ff), "gate": stack(d, ff), "down": stack(ff, d)}


def _top(scores: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``scores`` and their
    indices, ties to the lower index (``jax.lax.top_k``'s order)."""
    idx = torch.sort(scores.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def router(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x: [T,d] → (combine weights [T,k] float32, expert indices [T,k],
    aux loss)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top(probs, cfg.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary loss.
    # The first choice's one-hot, by comparison (``F.one_hot`` reads its
    # input's range back to the host on the CPU).
    E = cfg.n_experts
    first = top_i[:, :1] == torch.arange(E, device=top_i.device)
    f = first.to(torch.float32).mean(0)
    pr = probs.mean(0)
    aux = cfg.router_aux_coeff * E * torch.sum(f * pr)
    return top_p, top_i, aux


def _expert_compute(up, gate, down, x_slab):
    """Batched expert FFN. x_slab: [E, C, d] → [E, C, d]."""
    dt = x_slab.dtype
    h = F.silu(torch.bmm(x_slab, gate.to(dt))) * torch.bmm(x_slab, up.to(dt))
    return torch.bmm(h, down.to(dt))


def _dispatch_dense(up, gate, down, x, top_p, top_i):
    """Dropless per-token dispatch: gather each token's top-k experts'
    weights and run them directly (T·k expert rows). Only decode-sized T
    takes it: the gathered weights are [T, k, d, ff]."""
    dt = x.dtype
    gu, gg, gd = up[top_i].to(dt), gate[top_i].to(dt), down[top_i].to(dt)
    h = F.silu(torch.einsum("td,tkdf->tkf", x, gg))
    h = h * torch.einsum("td,tkdf->tkf", x, gu)
    h = h * top_p[..., None].to(dt)
    return torch.einsum("tkf,tkfd->td", h, gd)


class _RowGather(torch.autograd.Function):
    """``out[i] = Σ_j src[fwd[i, j]]`` over the entries ``fwd[i, j] <
    len(src)`` (the others add nothing), in the order of j.

    ``bwd`` is the same map the other way round: ``bwd[s, :]`` lists the
    rows of ``out`` that read row ``s`` of ``src`` (out-of-range entries
    for none), so the gradient is a gather too and no float atomic adds
    in either direction."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _gather_sum(src, fwd)

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        return _gather_sum(grad, bwd), None, None


def _gather_sum(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = src.shape[0]
    valid = idx < n
    rows = src[torch.where(valid, idx, 0).reshape(-1)].reshape(
        *idx.shape, *src.shape[1:])
    rows = rows.masked_fill(~valid.reshape(*idx.shape,
                                           *([1] * (src.dim() - 1))), 0)
    return rows.sum(1)


def _dispatch_local(up, gate, down, x, top_p, top_i, *, e0: int = 0,
                    n_local: int | None = None, n_total: int | None = None,
                    capacity: int):
    """Capacity-gather dispatch over experts ``[e0, e0 + n_local)`` of
    ``n_total`` (all of them by default); ``up``/``gate``/``down`` hold
    those ``n_local`` experts.

    x: [T,d]; top_p/top_i: [T,k] (global expert ids). Each expert takes
    its ``capacity`` (clipped to T) highest-scoring tokens; a routed token
    that misses its expert's capacity is dropped there, and a token's
    experts outside the block add nothing here. Returns y [T,d]."""
    T = x.shape[0]
    E = up.shape[0]
    if n_local is not None and n_local != E:
        raise ValueError(f"_dispatch_local: {E} expert weights for a block "
                         f"of {n_local}")
    del n_total
    experts = torch.arange(e0, e0 + E, device=x.device)
    match = top_i[None, :, :] == experts[:, None, None]          # [E, T, k]
    score = torch.where(match, top_p[None, :, :],
                        torch.zeros((), dtype=top_p.dtype,
                                    device=x.device)).sum(-1)   # [E, T]
    cap = min(capacity, T)
    w, tok_idx = _top(score, cap)                                # [E, C]
    with torch.no_grad():
        # slot[e, t]: token t's row in expert e's slab, or E·cap.
        none = E * cap
        rows = (torch.arange(E, device=x.device)[:, None] * cap
                + torch.arange(cap, device=x.device)[None, :])
        slot = torch.full((E, T), none, dtype=torch.int64, device=x.device)
        slot.scatter_(1, tok_idx, rows)
        # Each token's rows in its k experts' slabs, in the order of its
        # top-k (``none`` for an expert outside the block); its slab rows
        # elsewhere are zero-weight filler picks.
        li = top_i.T.to(torch.int64) - e0                           # [k, T]
        inside = (li >= 0) & (li < E)
        tok_rows = torch.where(
            inside, torch.gather(slot, 0, li.clamp(0, E - 1)), none).T
        # Each slab row's token, or T for a filler row.
        real = torch.zeros(none + 1, dtype=torch.bool, device=x.device)
        real[tok_rows.reshape(-1)] = True
        row_tok = torch.where(real[:none], tok_idx.reshape(-1), T)[:, None]
        fill_tok = tok_idx.reshape(-1, 1)
    # The slab holds the filler rows too, as the reference's does; their
    # gradient is exactly 0 (their weight is 0), so the backward reads
    # only the real rows.
    x_slab = _RowGather.apply(x, fill_tok, tok_rows)
    y_slab = _expert_compute(up, gate, down, x_slab.reshape(E, cap, -1))
    y_slab = y_slab * w[..., None].to(y_slab.dtype)
    return _RowGather.apply(y_slab.reshape(E * cap, -1), tok_rows, row_tok)


def _moe_ffn_ep(p: Params, cfg: ModelConfig, x2: torch.Tensor, top_p,
                top_i, rules, expert_axis: str, *, dropless: bool):
    """Expert-parallel dispatch (the reference's ``shard_map`` branch):
    tokens sharded over the DP axes and whole over ``expert_axis``, the
    expert stacks split over ``expert_axis``; one all-reduce sums the
    ranks' outputs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    E = cfg.n_experts
    shape = mesh_shape(rules.mesh)
    mesh = rules.dmesh
    n_shards = shape[expert_axis]
    if E % n_shards:
        raise ValueError(f"moe_ffn: {E} experts over {n_shards} shards")
    n_local = E // n_shards
    batch_axes = rules.mapping.get("batch")
    dp_axes = (() if batch_axes is None else
               (batch_axes,) if isinstance(batch_axes, str)
               else tuple(batch_axes))
    dp = 1
    for a in dp_axes:
        dp *= shape[a]
    # Per-DP-shard token count sets capacity (tokens are sharded over DP
    # axes and whole over the expert axis inside the block).
    t_local = max(x2.shape[0] // dp, 1)
    cap = t_local if dropless else max(
        int(cfg.capacity_factor * t_local * cfg.top_k / E), 1)

    names = tuple(mesh.mesh_dim_names)
    tok_pl = placements(P(batch_axes, None), mesh)
    tok_grad = tuple(Partial() if n == expert_axis else pl
                     for n, pl in zip(names, tok_pl))
    w_pl = placements(P(expert_axis, None, None), mesh)
    # each DP shard's tokens give a part of the experts' gradient
    w_grad = tuple(Partial() if t.is_shard() else pl
                   for t, pl in zip(tok_pl, w_pl))

    def local(t, pl, grad_pl=None):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * len(names),
                                   run_check=False)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        return t.to_local(grad_placements=grad_pl)

    xl = local(x2, tok_pl, tok_grad)
    pl_ = local(top_p, tok_pl, tok_grad)
    il = local(top_i, tok_pl)
    up, gate, down = (local(p[k], w_pl, w_grad)
                      for k in ("up", "gate", "down"))
    e0 = mesh.get_coordinate()[names.index(expert_axis)] * n_local
    y = _dispatch_local(up, gate, down, xl, pl_.to(xl.dtype), il, e0=e0,
                        n_local=n_local, n_total=E, capacity=cap)
    y = psum_whole(y, [mesh.get_group(expert_axis)])
    y = DTensor.from_local(y, mesh, tok_pl, run_check=False,
                           shape=x2.shape, stride=x2.stride())
    # plain tokens in, plain tokens out
    return y if isinstance(x2, DTensor) else y.full_tensor()


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
            dropless: bool = False):
    """MoE FFN over x: [B,S,d] (or [T,d]). Returns (y, aux_loss).

    ``dropless=True`` guarantees no token is ever dropped. Decode paths
    use it: at decode batch sizes the capacity heuristic quantizes to ~1
    slot, which would make each slot's output depend on which other
    requests share the batch; dropless dispatch keeps every row's
    computation row-local, so continuous batching is token-exact against
    single-request decoding. Local (unsharded) dropless routes through
    :func:`_dispatch_dense` (T·k expert-rows); the expert-parallel path
    (the rules in force map ``experts`` to a mesh axis) keeps the
    capacity gather with capacity = local token count (a dense gather
    would need other shards' expert weights)."""
    orig_shape = x.shape
    x2 = whole_middle(x).reshape(-1, orig_shape[-1])
    with region("moe_router"):
        top_p, top_i, aux = router(p, cfg, x2)
    rules = current_rules()
    expert_axis = None if rules is None else rules.mapping.get("experts")
    if expert_axis is not None and rules.mesh is not None:
        with region("moe_ffn"):
            y = _moe_ffn_ep(p, cfg, x2, top_p, top_i, rules, expert_axis,
                            dropless=dropless)
        return whole_middle_grad(y.reshape(orig_shape)), aux
    if dropless:
        with region("moe_ffn"):
            y = _dispatch_dense(p["up"], p["gate"], p["down"], x2, top_p,
                                top_i)
        return y.reshape(orig_shape), aux
    cap = max(int(cfg.capacity_factor * x2.shape[0] * cfg.top_k
                  / cfg.n_experts), 1)
    with region("moe_ffn"):
        y = _dispatch_local(p["up"], p["gate"], p["down"], x2,
                            top_p.to(x2.dtype), top_i, capacity=cap)
    return y.reshape(orig_shape), aux
