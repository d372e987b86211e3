"""GQA attention: full / chunked-prefill / flash / cached-decode paths.

Port of ``src/repro/models/attention.py`` on one card. GQA is computed in
MHA form on the plain paths: KV heads are repeated to the full head count
(``repeat_interleave`` on the head axis, which is ``jnp.repeat``'s
layout). The reference's sharding constraints have no counterpart on one
card and are dropped.

``impl`` selects the attention of a full-sequence forward:
``"full"`` materialises [Sq, Skv] scores, ``"chunked"`` loops over query
chunks (bounded memory), and ``"flash"`` — the counterpart of the
reference's ``"pallas"`` — goes to the hand-written flash-attention
kernel (:mod:`repro_torch.kernels.flash_attention`), which reads the KV
heads directly instead of their repetition. As in the reference, the
flash path masks by index while the others mask by ``positions``; prefill
positions are an arange, so the two agree.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models.layers import (Params, apply_rope, dense_init,
                                       linear, rmsnorm)

__all__ = ["NEG_INF", "attention", "attention_decode", "attention_init",
           "attention_prefill"]

NEG_INF = -2.0e38


def attention_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dh, H, KV, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p: Params = {
        "wq": dense_init(generator, d, H * dh),
        "wk": dense_init(generator, d, KV * dh),
        "wv": dense_init(generator, d, KV * dh),
        "wo": dense_init(generator, H * dh, d, scale=(H * dh) ** -0.5),
    }
    if cfg.qk_norm:
        dev = generator.device
        p["q_norm"] = {"scale": torch.ones(dh, dtype=torch.float32,
                                           device=dev)}
        p["k_norm"] = {"scale": torch.ones(dh, dtype=torch.float32,
                                           device=dev)}
    return p


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x [B,S,d] → q [B,H,S,dh], k/v [B,KV,S,dh] (roped, normed)."""
    B, S, _ = x.shape
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = linear(p["wq"], x).reshape(B, S, H, dh).transpose(1, 2)
    k = linear(p["wk"], x).reshape(B, S, KV, dh).transpose(1, 2)
    v = linear(p["wv"], x).reshape(B, S, KV, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, eps=cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B,KV,S,dh] → [B,H,S,dh] (``jnp.repeat`` layout: head h reads KV
    head h // q_per_kv)."""
    if cfg.q_per_kv != 1:
        t = t.repeat_interleave(cfg.q_per_kv, dim=1)
    return t


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """MHA scaled-dot-product. q: [B,H,Sq,dh], k/v: [B,H,Skv,dh], mask
    broadcastable to [B,H,Sq,Skv] (True = attend). fp32 softmax."""
    dh = q.shape[-1]
    scores = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    scores = scores * (dh ** -0.5)
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _merge_heads(p: Params, out: torch.Tensor) -> torch.Tensor:
    """[B,H,S,dh] → o-proj → [B,S,d]."""
    B, H, S, dh = out.shape
    out = out.transpose(1, 2).reshape(B, S, H * dh)
    return linear(p["wo"], out)


def _attend(cfg: ModelConfig, q, k, v, positions, *, impl: str,
            q_chunk: int):
    """Core attention. q: [B,H,S,dh]; k/v: [B,KV,S,dh] → [B,H,S,dh]."""
    S = q.shape[2]

    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal)
    if impl not in ("full", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"(full, chunked, flash)")

    kr = _repeat_kv(k, cfg)
    vr = _repeat_kv(v, cfg)

    def mask_for(pos_q):
        if not cfg.causal:
            return torch.ones((1, 1, 1, 1), dtype=torch.bool,
                              device=q.device)
        return positions[:, None, None, :] <= pos_q[:, None, :, None]

    if impl == "full" or S <= q_chunk:
        with region("attn_score"):
            return _sdpa(q, kr, vr, mask_for(positions))

    # chunked: a loop over query chunks; keys/values stay whole.
    if S % q_chunk:
        raise ValueError(f"chunked attention needs S % q_chunk == 0, got "
                         f"S={S}, q_chunk={q_chunk}")
    outs = []
    for i in range(0, S, q_chunk):
        with region("attn_score"):
            outs.append(_sdpa(q[:, :, i:i + q_chunk], kr, vr,
                              mask_for(positions[:, i:i + q_chunk])))
    return torch.cat(outs, dim=2)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, impl: str = "full",
              q_chunk: int = 1024) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill).

    impl: "full" materializes [Sq,Skv] scores (small seq);
          "chunked" loops over query chunks (bounded memory);
          "flash" dispatches to the flash-attention kernel.
    """
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(cfg, q, k, v, positions, impl=impl, q_chunk=q_chunk)
    return _merge_heads(p, out)


def attention_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, max_len: int, *,
                      impl: str = "chunked", q_chunk: int = 1024,
                      cache_dtype=torch.bfloat16):
    """Prefill: forward over the prompt AND populate a [.., max_len, ..]
    KV cache (zeros past the prompt). Returns (y, cache_k, cache_v)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(cfg, q, k, v, positions, impl=impl, q_chunk=q_chunk)
    y = _merge_heads(p, out)
    shape = (B, cfg.n_kv_heads, max_len, cfg.head_dim)
    ck = torch.zeros(shape, dtype=cache_dtype, device=x.device)
    cv = torch.zeros(shape, dtype=cache_dtype, device=x.device)
    ck[:, :, :S] = k
    cv[:, :, :S] = v
    return y, ck, cv


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cur_len, *, window: int | None = None,
                     sinks: int = 0, write_mask: torch.Tensor | None = None):
    """Cached decode over S >= 1 fresh positions. x: [B,S,d]; cache_k/v:
    [B,KV,T,dh]; cur_len: [] or [B] int = number of valid positions
    already in the cache, per row. Query j of row b lands at cache
    position ``cur_len[b] + j`` (the write start is clamped to
    ``[0, T - S]``, as ``dynamic_update_slice`` clamps it); a scalar
    ``cur_len`` broadcasts to the whole batch.

    ``window`` switches on the sliding-window draft mask (StreamingLLM):
    each query attends only to the last ``window`` cache positions plus
    the first ``sinks`` positions; ``None`` keeps the full causal mask.

    The cache is updated IN PLACE and returned (the reference returns a
    new cache; updating in place saves a copy of the cache per step).
    ``write_mask`` [B] bool, when given, keeps the old entries of the
    False rows: every row attends over its fresh K/V, as in the
    reference, and the False rows' writes are undone afterwards.

    Returns (y [B,S,d], cache_k, cache_v).
    """
    B, S, _ = x.shape
    T = cache_k.shape[2]
    dev = x.device
    cl = torch.as_tensor(cur_len, dtype=torch.int64, device=dev)
    cl = cl.expand(B) if cl.ndim == 0 else cl
    positions = cl[:, None] + torch.arange(S, device=dev)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)

    # Write each row's new K/V at that row's own position.
    rows = torch.arange(B, device=dev)[:, None]
    at = cl.clamp(0, T - S)[:, None] + torch.arange(S, device=dev)[None, :]
    if write_mask is not None:
        old_k, old_v = cache_k[rows, :, at], cache_v[rows, :, at]
    cache_k[rows, :, at] = k.transpose(1, 2).to(cache_k.dtype)
    cache_v[rows, :, at] = v.transpose(1, 2).to(cache_v.dtype)

    with region("attn_decode"):
        t_idx = torch.arange(T, device=dev)[None, None, None, :]
        pos_q = positions[:, None, :, None]
        valid = t_idx <= pos_q
        if window is not None:
            keep = t_idx > pos_q - window
            if sinks:
                keep = keep | (t_idx < sinks)
            valid = valid & keep
        if cfg.decode_grouped and cfg.q_per_kv > 1:
            # Grouped form: contract q-groups directly against the raw
            # [B,KV,T,dh] cache, with no head repetition.
            KV, G, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
            qg = q.reshape(B, KV, G, S, dh).to(torch.float32)
            kc = cache_k.to(torch.float32)
            scores = torch.einsum("bkgqd,bktd->bkgqt", qg, kc) * dh ** -0.5
            scores = torch.where(valid[:, :, None], scores,
                                 torch.full((), NEG_INF, device=dev))
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bkgqt,bktd->bkgqd", probs,
                               cache_v.to(torch.float32))
            out = out.reshape(B, KV * G, S, dh).to(q.dtype)
        else:
            kr = _repeat_kv(cache_k.to(q.dtype), cfg)
            vr = _repeat_kv(cache_v.to(q.dtype), cfg)
            out = _sdpa(q, kr, vr, valid)
    y = _merge_heads(p, out)

    if write_mask is not None:
        # Put the False rows' old entries back through a select, not a
        # boolean index: a boolean index waits for the device to size its
        # result, which would stall the host once per layer.
        wm = write_mask.to(device=dev, dtype=torch.bool)[:, None, None, None]
        cache_k[rows, :, at] = torch.where(wm, cache_k[rows, :, at], old_k)
        cache_v[rows, :, at] = torch.where(wm, cache_v[rows, :, at], old_v)
    return y, cache_k, cache_v
