"""GQA attention: full / chunked-prefill / flash / cached-decode paths.

Port of ``src/repro/models/attention.py`` on one card. GQA is computed in
MHA form on the plain paths: KV heads are repeated to the full head count
(``repeat_interleave`` on the head axis, which is ``jnp.repeat``'s
layout). Activations are constrained by logical axes where the
reference's are (:func:`repro_torch.sharding.rules.constrain`: a no-op
outside ``axis_rules`` and on plain tensors, a DTensor redistribution
under them).

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

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models.layers import (Params, apply_rope, dense_init,
                                       linear, rmsnorm)
from repro_torch.sharding.rules import (block_of, blockwise, constrain,
                                       current_rules)

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
    # Sharded projections split on whole heads (or are gathered whole
    # where the head count does not divide the mesh axis) before the
    # head axis is split out.
    q = constrain(linear(p["wq"], x), "batch", "seq", "heads")
    k = constrain(linear(p["wk"], x), "batch", "seq", "kv_heads")
    v = constrain(linear(p["wv"], x), "batch", "seq", "kv_heads")
    q = q.reshape(B, S, H, dh).transpose(1, 2)
    k = k.reshape(B, S, KV, dh).transpose(1, 2)
    v = v.reshape(B, S, KV, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, eps=cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "heads", "seq", "head_dim")
    k = constrain(k, "batch", "kv_heads", "seq", "head_dim")
    v = constrain(v, "batch", "kv_heads", "seq", "head_dim")
    return q, k, v


def _repeat_kv(t: torch.Tensor, cfg: ModelConfig, *,
               seq_axis: str | None) -> torch.Tensor:
    """[B,KV,S,dh] → [B,H,S,dh] (``jnp.repeat`` layout: head h reads KV
    head h // q_per_kv); keeps the head axis TP-shardable.

    When the KV-cache *sequence* is sharded (flash-decoding split-K for
    GQA groups narrower than the TP axis), the head axis must stay
    replicated — both can't land on the same mesh axis."""
    if cfg.q_per_kv != 1:
        t = t.repeat_interleave(cfg.q_per_kv, dim=1)
    r = current_rules()
    head_axis = "heads"
    if (seq_axis is not None and r is not None
            and r.mapping.get(seq_axis) is not None):
        head_axis = None
    return constrain(t, "batch", head_axis, seq_axis, "head_dim")


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
    return constrain(linear(p["wo"], out), "batch", "seq", "embed")


def _attend(cfg: ModelConfig, q, k, v, positions, *, impl: str,
            q_chunk: int):
    """Core attention. q: [B,H,S,dh]; k/v: [B,KV,S,dh] → [B,H,S,dh]."""
    if impl == "flash":
        return _flash(q, k, v, causal=cfg.causal)
    if impl not in ("full", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"(full, chunked, flash)")

    kr = _repeat_kv(k, cfg, seq_axis="seq")
    vr = _repeat_kv(v, cfg, seq_axis="seq")
    core = functools.partial(_attend_core, cfg, impl=impl, q_chunk=q_chunk)
    return blockwise(core, q, (0, 1),
                     [(q, (0, 1)), (kr, (0, 1)), (vr, (0, 1)),
                      (positions, (0, None))], (0, 1))


def _attend_core(cfg: ModelConfig, q, kr, vr, positions, *, impl: str,
                 q_chunk: int):
    """Full or chunked attention of q over the repeated kr/vr [B,H,S,dh]
    (on a rank: its block of rows and heads)."""
    S = q.shape[2]

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


def _flash(q, k, v, *, causal: bool) -> torch.Tensor:
    """The flash kernel on q [B,H,S,dh], k/v [B,KV,S,dh]. DTensors run
    it on each rank's local heads (``local_map``): batch and heads may be
    sharded, the sequence and head dim must be whole on every rank (the
    kernel attends over the whole sequence), so q/k/v are first
    redistributed to that; a rank's q heads read its own KV heads, which
    holds when KV heads are sharded as q heads are (each rank's group is
    the whole group) or replicated (then each rank takes its groups' KV
    heads out of the full set)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not _is_dtensor(q):
        return fa_ops.flash_attention(q, k, v, causal=causal)
    return _flash_local(q, k, v, causal=causal)


def _flash_local(q, k, v, *, causal: bool) -> torch.Tensor:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh

    def whole(t, keep: tuple[int, ...]):
        # keep the shards of the dims in ``keep``; gather the others
        pl = tuple(pp if pp.is_shard() and pp.dim in keep else Replicate()
                   for pp in t.placements)
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)

    q = whole(q, (0, 1))
    H, KV = q.shape[1], k.shape[1]
    r, n = block_of(q, 1)        # this rank's block of heads, of n
    kv_follows = n > 1 and KV % n == 0
    # k/v: q's batch shards; q's head shards too when KV heads divide
    kv_pl = tuple(pp if pp != Shard(1) or kv_follows else Replicate()
                  for pp in q.placements)
    k = k if tuple(k.placements) == kv_pl else k.redistribute(mesh, kv_pl)
    v = v if tuple(v.placements) == kv_pl else v.redistribute(mesh, kv_pl)
    group, per = H // KV, H // n
    slice_kv = n > 1 and not kv_follows
    if slice_kv and per % group and group % per:
        raise ValueError(f"flash: {H} q heads over {n} ranks do not split "
                         f"into whole GQA groups of {group}")

    def body(ql, kl, vl):
        if slice_kv:
            # this rank's q heads read these KV heads of the full set
            lo, hi = r * per // group, ((r + 1) * per - 1) // group + 1
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return fa_ops.flash_attention(ql, kl, vl, causal=causal)

    fn = local_map(body, out_placements=(q.placements,),
                   in_placements=(q.placements, k.placements, v.placements),
                   device_mesh=mesh)
    return fn(q, k, v)


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
    # zeros past the prompt, per block of rows and heads on DTensors
    pad = functools.partial(_pad_cache, n=max_len - S, dtype=cache_dtype)
    ck = blockwise(pad, k, (0, 1), [(k, (0, 1))], (0, 1))
    cv = blockwise(pad, v, (0, 1), [(v, (0, 1))], (0, 1))
    ck = constrain(ck, "batch", "kv_heads", "kv_seq", "head_dim")
    cv = constrain(cv, "batch", "kv_heads", "kv_seq", "head_dim")
    return y, ck, cv


def _pad_cache(t: torch.Tensor, *, n: int, dtype) -> torch.Tensor:
    """t [B,KV,S,dh] in ``dtype`` with ``n`` zero positions after S."""
    return F.pad(t.to(dtype), (0, 0, 0, n))


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
    # A sharded cache is written in place as it is placed (the caller's
    # ``cache_specs``): a redistributed copy would lose the write.
    sharded = _is_dtensor(cache_k)

    # Write each row's new K/V at that row's own position.
    rows = torch.arange(B, device=dev)[:, None]
    at = cl.clamp(0, T - S)[:, None] + torch.arange(S, device=dev)[None, :]
    if sharded:
        _write_sharded(cache_k, k, at[:, 0], write_mask)
        _write_sharded(cache_v, v, at[:, 0], write_mask)
    else:
        if write_mask is not None:
            old_k, old_v = cache_k[rows, :, at], cache_v[rows, :, at]
        cache_k[rows, :, at] = k.transpose(1, 2).to(cache_k.dtype)
        cache_v[rows, :, at] = v.transpose(1, 2).to(cache_v.dtype)

    with region("attn_decode"):
        out = _decode_attend(cfg, q, cache_k, cache_v, positions,
                             window=window, sinks=sinks)
    y = _merge_heads(p, out)

    if write_mask is not None and not sharded:
        # Put the False rows' old entries back through a select, not a
        # boolean index: a boolean index waits for the device to size its
        # result, which would stall the host once per layer.
        wm = write_mask.to(device=dev, dtype=torch.bool)[:, None, None, None]
        cache_k[rows, :, at] = torch.where(wm, cache_k[rows, :, at], old_k)
        cache_v[rows, :, at] = torch.where(wm, cache_v[rows, :, at], old_v)
    return y, cache_k, cache_v


def _decode_core(cfg: ModelConfig, q, cache_k, cache_v, positions, *,
                 window, sinks, kv_slice=None):
    """Decode attention of q [B,H,S,dh] at ``positions`` [B,S] over the
    cache [B,KV,T,dh] (on a rank: its block of rows and heads; with
    ``kv_slice`` (lo, hi) the full KV set, of which its q heads read
    those)."""
    if kv_slice is not None:
        cache_k = cache_k[:, kv_slice[0]:kv_slice[1]]
        cache_v = cache_v[:, kv_slice[0]:kv_slice[1]]
    B, H, S, dh = q.shape
    KV, T = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    dev = q.device
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
        qg = q.reshape(B, KV, G, S, dh).to(torch.float32)
        kc = cache_k.to(torch.float32)
        scores = torch.einsum("bkgqd,bktd->bkgqt", qg, kc) * dh ** -0.5
        scores = torch.where(valid[:, :, None], scores,
                             torch.full((), NEG_INF, device=dev))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqt,bktd->bkgqd", probs,
                           cache_v.to(torch.float32))
        return out.reshape(B, KV * G, S, dh).to(q.dtype)
    kr, vr = cache_k.to(q.dtype), cache_v.to(q.dtype)
    if G != 1:
        kr = kr.repeat_interleave(G, dim=1)
        vr = vr.repeat_interleave(G, dim=1)
    return _sdpa(q, kr, vr, valid)


def _decode_attend(cfg: ModelConfig, q, cache_k, cache_v, positions, *,
                   window, sinks):
    """:func:`_decode_core`; on DTensors per block of rows and heads
    (the cache's sequence whole on every rank)."""
    if not _is_dtensor(q):
        return _decode_core(cfg, q, cache_k, cache_v, positions,
                            window=window, sinks=sinks)
    H, KV = q.shape[1], cache_k.shape[1]
    q = constrain(q, "batch", "heads", None, "head_dim")
    r, n = block_of(q, 1)        # this rank's block of heads, of n
    follows = n == 1 or KV % n == 0
    kv_slice = None
    if not follows:
        group, per = H // KV, H // n
        if per % group and group % per:
            raise ValueError(f"decode: {H} q heads over {n} ranks do not "
                             f"split into whole GQA groups of {group}")
        kv_slice = (r * per // group, ((r + 1) * per - 1) // group + 1)
    kvd = (0, 1 if follows else None)

    def core(q_, k_, v_, pos_):
        return _decode_core(cfg, q_, k_, v_, pos_, window=window,
                            sinks=sinks, kv_slice=kv_slice)
    return blockwise(core, q, (0, 1),
                     [(q, (0, 1)), (cache_k, kvd), (cache_v, kvd),
                      (positions, (0, None))], (0, 1))


def _is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _offset(t, dim: int) -> int:
    """Where this rank's block of DTensor ``t`` starts along ``dim``
    (even shards)."""
    r, n = block_of(t, dim)
    return r * (t.shape[dim] // n)


def _write_sharded(cache, new, start, write_mask) -> None:
    """Decode's cache write on a sharded cache, in place: row b of ``new``
    [B,KV,S,dh] lands at positions ``start[b] + [0, S)`` of ``cache``
    [B,KV,T,dh] (a DTensor). Each rank rewrites its own block: a local
    position takes the new entry whose index it is, if any (and if the
    row's ``write_mask`` is set), else keeps its own."""
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    want = tuple(Replicate() if pp.is_shard() and pp.dim == 2 else pp
                 for pp in cache.placements)
    new = new.redistribute(mesh, want) if _is_dtensor(new) else new
    nl = new.to_local() if _is_dtensor(new) else new
    cl = cache.to_local()
    Bl, KVl, Tl, dh = cl.shape
    S = nl.shape[2]
    b0, t0 = _offset(cache, 0), _offset(cache, 2)
    st = start.to(cl.device)[b0:b0 + Bl]
    j = (torch.arange(Tl, device=cl.device)[None, :] + t0
         - st[:, None])                                       # [Bl, Tl]
    keep_new = (j >= 0) & (j < S)
    if write_mask is not None:
        wm = write_mask.to(device=cl.device, dtype=torch.bool)
        keep_new = keep_new & wm[b0:b0 + Bl, None]
    idx = j.clamp(0, S - 1)[:, None, :, None].expand(Bl, KVl, Tl, dh)
    taken = torch.gather(nl.to(cl.dtype), 2, idx)
    cl.copy_(torch.where(keep_new[:, None, :, None], taken, cl))
