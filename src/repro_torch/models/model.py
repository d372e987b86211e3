"""Top-level model assembly for the dense family: init / forward /
prefill / cache / decode.

Port of ``src/repro/models/model.py``. The reference stacks the layers on
a leading axis and scans over them; here ``p["blocks"]`` and the KV
cache's ``cache["blocks"]`` are Python lists with one dict per layer, and
a Python loop runs the layers (:func:`repro_torch.convert.params_from_jax`
unstacks the reference's weights). The other families raise
``NotImplementedError`` naming ROADMAP A7.

Entry points run where their tensors live: :func:`init_params` and
:func:`init_cache` take ``device=`` (the GPU unless the caller asks for
the CPU), the rest follow the parameters and inputs they are given.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core.regions import region
from repro_torch.models import transformer as tb
from repro_torch.models.layers import (Params, dense_init, embed_init, norm,
                                       norm_init)

__all__ = ["init_params", "cast_params", "forward", "prefill",
           "init_cache", "decode_step", "decode_verify",
           "reset_cache_slots"]


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random float32 master weights, drawn from ``generator``, which must
    live on ``device`` (the weights are drawn where they stay)."""
    tb.check_family(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on "
                         f"{generator.device}, the weights go to {dev}")
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model),
        "final_norm": norm_init(cfg.d_model, cfg.norm_kind, generator.device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size),
        "blocks": [tb.tblock_init(generator, cfg)
                   for _ in range(cfg.n_layers)],
    }


def cast_params(p: Params, cfg: ModelConfig) -> Params:
    """A copy of ``p`` with every matrix (embedding, projections, head)
    held in the compute dtype; norm scales and biases stay float32.

    The model casts each matrix to the activation dtype at every use
    (``layers.linear``, the embedding gather, the head), so the numbers
    are the same: this only saves the cast at every call. Made once at
    load."""
    dt = _compute_dtype(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.to(dt) if x.ndim >= 2 else x
    return conv(p)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed(p: Params, cfg: ModelConfig, batch: dict):
    """Token embedding → x [B,S,d] (compute dtype), positions [B,S]."""
    dt = _compute_dtype(cfg)
    tokens = batch["tokens"]
    with region("embed"):
        x = p["embed"].to(dt)[tokens]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _backbone(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, attn_impl: str = "full",
              q_chunk: int = 1024):
    """All blocks (no embed / final norm / head). Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pl in p["blocks"]:
        x, a = tb.tblock_forward(pl, cfg, x, positions,
                                 attn_impl=attn_impl, q_chunk=q_chunk)
        aux = aux + a
    return x, aux


def forward(p: Params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "full", q_chunk: int = 1024):
    """Full-sequence forward → logits [B, S, V], aux loss."""
    x, positions = _embed(p, cfg, batch)
    x, aux = _backbone(p, cfg, x, positions, attn_impl=attn_impl,
                       q_chunk=q_chunk)
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = x @ p["lm_head"].to(x.dtype)
    return logits, aux


def prefill(p: Params, cfg: ModelConfig, batch: dict, max_len: int, *,
            attn_impl: str = "chunked", cache_dtype=torch.bfloat16,
            q_chunk: int = 1024):
    """Inference prefill: forward over the prompt, returning (logits of the
    last position [B,1,V], populated cache, cur_len = S)."""
    x, positions = _embed(p, cfg, batch)
    S = x.shape[1]
    caches = []
    for pl in p["blocks"]:
        x, c = tb.tblock_prefill(pl, cfg, x, positions, max_len,
                                 attn_impl=attn_impl,
                                 cache_dtype=cache_dtype, q_chunk=q_chunk)
        caches.append(c)
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = x[:, -1:, :] @ p["lm_head"].to(x.dtype)
    return (logits, {"blocks": caches},
            torch.tensor(S, dtype=torch.int32, device=x.device))


# ---------------------------------------------------------------------------
# Cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zero KV cache: ``{"blocks": [{"k", "v"} per layer]}``, each
    [batch, KV, max_len, dh]."""
    tb.check_family(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"blocks": [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)}
                       for _ in range(cfg.n_layers)]}


def reset_cache_slots(cfg: ModelConfig, cache: Params,
                      slot_mask: torch.Tensor) -> Params:
    """Zero the cache rows of every True entry of ``slot_mask`` [B], in
    place (slot admission for continuous batching); returns the cache."""
    tb.check_family(cfg)
    for c in cache["blocks"]:
        for t in c.values():
            t[slot_mask.to(device=t.device, dtype=torch.bool)] = 0
    return cache


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, cur_len, *,
                write_mask: torch.Tensor | None = None,
                window: int | None = None, sinks: int = 0):
    """One decode step. tokens: [B,S] int; S=1 is the classic
    single-token step, S>1 scores several positions (the speculative
    verify sweep).

    ``cur_len`` is [] or [B] int — per-row cache depth; position j of row
    b lands at cache position ``cur_len[b] + j``. ``write_mask`` [B]
    bool, when given, confines cache mutation to True rows; logits are
    still computed for every row. ``window``/``sinks`` select the
    StreamingLLM sliding-window mask of the speculative draft.

    The cache is updated in place and returned. Returns
    (logits [B,S,V], cache).
    """
    dt = _compute_dtype(cfg)
    with region("embed"):
        x = p["embed"].to(dt)[tokens]
    for pl, cl in zip(p["blocks"], cache["blocks"]):
        x, _ = tb.tblock_decode(pl, cfg, x, cl, cur_len, window=window,
                                sinks=sinks, write_mask=write_mask)
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = x @ p["lm_head"].to(x.dtype)
    return logits, cache


def decode_verify(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Params, cur_len, *,
                  write_mask: torch.Tensor | None = None):
    """Self-speculative verify: score L >= 1 positions in one step.

    For the dense family this is the multi-position :func:`decode_step`:
    each query row attends over the full cache under its own causal mask.
    Returns ``(logits [B,L,V], cache)``.
    """
    return decode_step(p, cfg, tokens, cache, cur_len,
                       write_mask=write_mask)
