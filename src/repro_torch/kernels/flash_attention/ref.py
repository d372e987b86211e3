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

:func:`attention_wgmma_emulation` repeats, for the CPU tests only, the
numerics of the kernel's tensor-core route, so that a test can show on
the CPU that they fit the reference's limit.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "attention_wgmma_emulation"]

NEG_INF = -2.0e38
LOG2E = 1.4426950408889634


def _repeat_kv(q, k, v):
    H, KV = q.shape[1], k.shape[1]
    if H % KV:
        raise ValueError(f"attention_ref: {KV} kv heads do not divide {H}")
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    return k, v


def attention_ref(q, k, v, *, causal: bool = True):
    """q: [B, H, S, dh]; k/v: [B, KV, T, dh] with KV dividing H →
    [B, H, S, dh] in q's dtype."""
    k, v = _repeat_kv(q, k, v)
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


def attention_wgmma_emulation(q, k, v, *, causal: bool = True,
                              block: int = 128):
    """The tensor-core route's arithmetic in plain PyTorch (tests only):
    keys in tiles of ``block``; float32 scores; an online softmax in base 2
    (log2 e folded into the scale, the running max kept in those units),
    rescaling (l, acc) once per tile; l summed from the float32
    probabilities; the probabilities rounded to q's dtype before the
    float32-accumulated P·V; the end divided by max(l, 1e-30) and cast to
    q's dtype. Shapes as :func:`attention_ref`."""
    k, v = _repeat_kv(q, k, v)
    S, T, dh = q.shape[2], k.shape[2], q.shape[-1]
    c = dh ** -0.5 * LOG2E
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    m = torch.full((*q.shape[:3], 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, T, block):
        s = torch.matmul(qf, kf[:, :, k0:k0 + block].transpose(-1, -2))
        if causal:
            cols = torch.arange(k0, min(k0 + block, T),
                                device=q.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).to(torch.float32),
                                         vf[:, :, k0:k0 + block])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
