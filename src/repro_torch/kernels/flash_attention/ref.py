"""Plain PyTorch version of the flash-attention forward.

It computes what the TPU kernel (``src/repro/kernels/flash_attention/
flash_attention.py``) computes: scores, probabilities and the
probability-value product all in float32, the causal mask by index
(key ``col`` attends to query ``row`` iff ``col <= row``), masked scores
set to ``NEG_INF``, the denominator clamped at 1e-30, output cast to
``q``'s dtype. (The JAX package's own ``ref.py`` casts the probabilities
to ``v``'s dtype before the second product; its kernel does not, and this
version follows the kernel.)

GQA: ``k``/``v`` may carry fewer heads than ``q`` (any divisor); query
head ``h`` reads key/value head ``h // (H // KV)``, as ``jnp.repeat`` on
the head axis lays them out. The CPU path of
:mod:`repro_torch.kernels.flash_attention.ops` runs this, and
``chip_smoke.py`` holds the CUDA kernel against it on the GPU.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref"]

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal: bool = True):
    """q: [B, H, S, dh]; k/v: [B, KV, T, dh] with KV dividing H →
    [B, H, S, dh] in q's dtype."""
    H, KV = q.shape[1], k.shape[1]
    if H % KV:
        raise ValueError(f"attention_ref: {KV} kv heads do not divide {H}")
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    dh = q.shape[-1]
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * dh ** -0.5
    if causal:
        S, T = q.shape[2], k.shape[2]
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full((), NEG_INF,
                                                    device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, v.to(torch.float32)) / l).to(q.dtype)
