"""AdamW + LR schedules + global-norm clipping, from scratch.

Port of ``src/repro/optim/adamw.py``, written as the reference writes it
(not ``torch.optim.AdamW``, which rounds the same formula differently and
has no place for the schedule and the clip). States are the port's trees
(:mod:`repro_torch.tree`); master weights stay float32 and gradients may
arrive in bfloat16 (cast up inside).

:func:`adamw_update` updates the parameters and the moments in place,
under ``torch.no_grad()``: that is the port's form of the reference's
``donate_argnums=(0,)``, and at qwen3-1.7b's full size it saves 8 GB of
float32 copies of each. A caller that needs the old state again clones
it first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import LAYER_AXIS, stacked_paths, tree_leaves, tree_map

Params = Any

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Params) -> dict:
    """Zero float32 moments shaped like ``params`` and step 0 (int32), on
    the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads · min(1, max_norm / max(|grads|, 1e-9)) in float32, norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def sched(step):
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay_frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * decay_frac))
        mult = torch.where(step < cfg.warmup_steps, warm,
                           cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
        return cfg.lr * mult
    return sched


def linear_warmup(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    def sched(step):
        return cfg.lr * torch.clamp(step.to(torch.float32)
                                    / max(cfg.warmup_steps, 1), max=1.0)
    return sched


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: dict, *, schedule=None):
    """One AdamW step, in place. Returns (params, state, metrics): the
    same parameter and moment tensors, updated, and ``state["step"]``
    advanced.

    As the reference: the gradients are clipped by their global norm
    first; the bias corrections ``1 - b**step`` are float32 tensors; weight
    decay is added to the update before the learning rate multiplies it,
    on the leaves the reference decays: those of ndim >= 2 in its
    layer-stacked layout, so a leaf inside one of the port's per-layer
    lists counts its layer axis (a block's norm scale is decayed, the
    final norm's is not)."""
    sched = schedule or cosine_schedule(cfg)
    step = state["step"] + 1
    lr = sched(step)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), step_f)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), step_f)

    for p, g, mu, nu, path in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["mu"]), tree_leaves(state["nu"]),
            stacked_paths(params)):
        g = g.to(torch.float32) * scale          # clip_by_global_norm's value
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if p.ndim + path.count(LAYER_AXIS) >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics
