"""The train step: loss → grad → (compress) → AdamW, with optional
gradient-accumulation microbatching.

Port of ``src/repro/train/step.py`` on one card. The state is the port's
tree ``{"params", "opt": {"mu", "nu", "step"}[, "residuals"]}``
(:func:`repro_torch.convert.train_state_from_jax` carries the reference's
across); the step differentiates :func:`repro_torch.models.model.loss_fn`
with ``torch.autograd.grad`` and updates the state in place (the
reference donates it). Its metrics stay device tensors: a caller reads
them only when it logs.

:func:`opaque_step` is the counterpart of the reference's ``jax.jit``
around the step: the jitted step runs its ``region`` calls only while it
is traced, so on every later call a profiling sample lands in the
trainer's ``train_step`` region, never in ``fwd_bwd``, ``optimizer`` or a
layer. The port's eager step would mark them on every call, so the
launcher runs it inside ``regions.opaque()``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import regions
from repro_torch.core.regions import region
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_decompress, compress_init
from repro_torch.tree import LAYER_AXIS, stacked_paths, tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "make_train_step", "opaque_step"]

TrainState = dict[str, Any]


def init_state(generator: torch.Generator, cfg: ModelConfig,
               opt_cfg: AdamWConfig, *, compression: bool = False,
               device="cuda") -> TrainState:
    """Random float32 parameters from ``generator`` (on ``device``), which
    require grad, with zero AdamW moments (and zero residuals with
    ``compression``)."""
    del opt_cfg
    params = tree_map(lambda t: t.requires_grad_(),
                      M.init_params(generator, cfg, device=device))
    state: TrainState = {"params": params, "opt": adamw_init(params)}
    if compression:
        state["residuals"] = compress_init(params)
    return state


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    attn_impl: str = "full", ssd_chunk: int = 128,
                    accum_steps: int = 1, compression: bool = False,
                    unroll: bool = False, q_chunk: int = 1024,
                    ce_chunk: int = 512):
    """Returns train_step(state, batch) -> (state, metrics). The state's
    tensors are updated in place and the state returned."""

    def loss(params, batch):
        if cfg.bf16_gather:
            # The reference's mixed-precision layout: matrices cast to
            # bf16 before the loss (its FSDP gathers move half the bytes).
            # "Matrix" is ndim >= 2 in its layer-stacked tree, so a block's
            # [d] norm scale (stacked [L, d] there) is cast too.
            paths = iter(stacked_paths(params))
            params = tree_map(
                lambda w: (w.to(torch.bfloat16)
                           if w.ndim + next(paths).count(LAYER_AXIS) >= 2
                           else w), params)
        return M.loss_fn(params, cfg, batch, attn_impl=attn_impl,
                         ssd_chunk=ssd_chunk, unroll=unroll,
                         q_chunk=q_chunk, ce_chunk=ce_chunk)

    def grad_fn(params, leaves, batch):
        l, metrics = loss(params, batch)
        grads = torch.autograd.grad(l, leaves)
        # A sharded parameter's gradient comes back as DTensor leaves it
        # (often a partial sum): place it as its parameter is, for the
        # in-place optimizer.
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if hasattr(g, "placements")
                 and tuple(g.placements) != tuple(p.placements) else g
                 for g, p in zip(grads, leaves)]
        return l.detach(), metrics, grads

    def compute_grads(params, batch):
        # A restored state's tensors come back without requires_grad.
        leaves = [t if t.requires_grad else t.requires_grad_()
                  for t in tree_leaves(params)]
        if accum_steps == 1:
            l, metrics, grads = grad_fn(params, leaves, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            # Microbatch accumulation over static slices of the batch dim.
            B = next(iter(batch.values())).shape[0]
            mb_size = B // accum_steps
            grads = None
            lsum = 0.0
            for i in range(accum_steps):
                mb = {k: v[i * mb_size:(i + 1) * mb_size]
                      for k, v in batch.items()}
                li, _, g = grad_fn(params, leaves, mb)
                lsum = lsum + li
                if grads is None:
                    grads = [a.to(torch.float32) for a in g]
                else:
                    grads = [a.add_(b.to(torch.float32))
                             for a, b in zip(grads, g)]
            grads = [g.div_(accum_steps) for g in grads]
            l = lsum / accum_steps
            metrics = {"ce": l, "aux": torch.zeros((), device=l.device)}
        it = iter(grads)
        return l, metrics, tree_map(lambda _: next(it), params)

    def train_step(state: TrainState, batch):
        with region("fwd_bwd"):
            l, metrics, grads = compute_grads(state["params"], batch)
        new_state = dict(state)
        if compression:
            with region("grad_compress"):
                grads, new_state["residuals"] = compress_decompress(
                    grads, state["residuals"])
        with region("optimizer"):
            params, opt, opt_metrics = adamw_update(
                opt_cfg, state["params"], grads, state["opt"])
        new_state["params"] = params
        new_state["opt"] = opt
        metrics = {k: _whole(v)
                   for k, v in dict(metrics, loss=l, **opt_metrics).items()}
        return new_state, metrics

    return train_step


def _whole(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def opaque_step(train_step):
    """``train_step`` run inside ``regions.opaque()`` on every call: its
    regions label the trace and leave the profiling marker alone, as the
    reference's jitted step's do after its trace."""
    @functools.wraps(train_step)
    def step(state, batch):
        with regions.opaque():
            return train_step(state, batch)
    return step
