"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

Port of ``src/repro/sharding/pipeline.py``. For meshes with a pipeline
axis, layers are partitioned into S stages; microbatches stream through
stages with point-to-point boundary transfers. The schedule is the
classic GPipe fill-drain loop: with M microbatches and S stages, bubble
fraction = (S−1)/(M+S−1).

Each rank holds its stage's layers (a contiguous slice of the stacked
parameters) and runs the same loop as every other stage (SPMD): at tick
t stage 0 injects microbatch ``clip(t, 0, M−1)``, every stage runs its
layers, then the activations rotate one stage forward
(``dist.batch_isend_irecv`` on the pipe axis's process group: the
reference's ``ppermute``); the last stage emits microbatch t − (S−1) at
ticks t ≥ S − 1. A masked all-reduce over the axis (the reference's
masked ``psum``, in effect a broadcast from the last stage) gives every
rank the outputs. Works with any per-stage block fn of signature
``(stage_params, x) -> x``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

__all__ = ["pipeline_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _rotate(y: torch.Tensor, group, stage: int, n_stages: int
            ) -> torch.Tensor:
    """Stage s's ``y`` to stage s+1 (the last stage's to stage 0)."""
    if n_stages == 1:
        return y
    dst = dist.get_global_rank(group, (stage + 1) % n_stages)
    src = dist.get_global_rank(group, (stage - 1) % n_stages)
    y = y.contiguous()
    recv = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return recv


def pipeline_forward(block_fn: Callable, mesh, *, axis: str = "pipe",
                     n_micro: int):
    """Build a pipelined forward: (stage_params, x) → y.

    Args:
      block_fn: per-stage function ``(stage_params, x_micro) -> x_micro``;
        stage_params are the layers owned by one stage (leading dim =
        layers-per-stage, sliced here).
      mesh: a ``DeviceMesh`` with a dim named ``axis``.
      n_micro: number of microbatches (global batch must divide).

    Returns a function ``f(params_stacked, x) -> y`` where
    ``params_stacked`` leaves have leading dim n_stages·layers_per_stage
    (the same full tensors on every rank) and x is [B, ...] (the same on
    every rank); y is x after all stages, microbatched, on every rank.
    """
    n_stages = int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)

    def staged(params_local, x_local):
        # params_local: this stage's layers [L/S, ...]; x_local: the full
        # microbatch set [M, B/M, ...] (replicated over the pipe axis).
        M = n_micro
        T = M + n_stages - 1          # schedule ticks
        buf = torch.zeros_like(x_local[0])
        out = torch.zeros_like(x_local)
        for t in range(T):
            # Which microbatch does stage 0 inject at tick t?
            inject = x_local[min(max(t, 0), M - 1)]
            cur = inject if stage == 0 else buf
            y = block_fn(params_local, cur)
            # Rotate stage s → s+1 (last stage's output is collected).
            nxt = _rotate(y, group, stage, n_stages)
            # Last stage emits microbatch (t - (S-1)) at ticks ≥ S-1.
            if t >= n_stages - 1 and stage == n_stages - 1:
                out[min(max(t - (n_stages - 1), 0), M - 1)] = y
            buf = nxt
        # Only the last stage holds real outputs; broadcast them.
        out = torch.where(torch.tensor(stage == n_stages - 1,
                                       device=out.device),
                          out, torch.zeros_like(out))
        if n_stages > 1:
            dist.all_reduce(out, group=group)
        return out

    def run(params_stacked, x):
        B = x.shape[0]
        assert B % n_micro == 0, (B, n_micro)
        xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])

        def mine(w):            # layers split over stages
            per = w.shape[0] // n_stages
            return w[stage * per:(stage + 1) * per]
        out = staged(tree_map(mine, params_stacked), xm)
        return out.reshape(B, *x.shape[1:])

    return run
