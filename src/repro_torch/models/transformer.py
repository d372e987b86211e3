"""Block composition: the standard transformer block (dense / moe /
audio / vlm), with init / forward / prefill / decode.

Port of the standard-block half of ``src/repro/models/transformer.py``.
Block forwards return ``(x, aux)`` as the reference's do: aux is the MoE
load-balancing loss, 0 for the other families. A MoE block's FFN is
:func:`repro_torch.models.moe.moe_ffn` (regions ``moe_router`` and
``moe_ffn``, with no ``ffn`` region around them, as in the reference):
the capacity path in forward and prefill, dropless in decode. The xLSTM
and zamba2 blocks (the recurrent families) are not ported yet (ROADMAP
A7(d)/(e)) and raise.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import Params, mlp, mlp_init, norm, norm_init

__all__ = ["FAMILIES", "check_family", "tblock_init", "tblock_forward",
           "tblock_prefill", "tblock_decode"]

# The families built of the standard attention block.
FAMILIES = ("dense", "moe", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family whose blocks the port does not have yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP A7(d)/(e)); the port runs the {', '.join(FAMILIES)} "
            f"families")


def tblock_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    check_family(cfg)
    dev = generator.device
    p: Params = {
        "ln1": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "ln2": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "attn": attn_mod.attention_init(generator, cfg),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(generator, cfg)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                            gated=cfg.gated_mlp)
    return p


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
         decode: bool = False):
    """The block's FFN on ``ln2(x)`` → (y, aux; None for a dense FFN).
    A dense FFN runs in the ``ffn`` region outside decode (the
    reference's decode block has no region there); a MoE FFN marks its
    own (``moe_router``, ``moe_ffn``) and is dropless in decode."""
    h = norm(p["ln2"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p["moe"], cfg, h, dropless=decode)
    with contextlib.nullcontext() if decode else region("ffn"):
        y = mlp(p["mlp"], h, gated=cfg.gated_mlp, act=cfg.act)
    return y, None


def tblock_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, *, attn_impl: str = "full",
                   q_chunk: int = 1024):
    check_family(cfg)
    with region("attn"):
        h = attn_mod.attention(
            p["attn"], cfg, norm(p["ln1"], x, kind=cfg.norm_kind,
                                 eps=cfg.norm_eps),
            positions, impl=attn_impl, q_chunk=q_chunk)
    x = x + h
    y, aux = _ffn(p, cfg, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def tblock_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, max_len: int, *,
                   attn_impl: str = "chunked", cache_dtype=torch.bfloat16,
                   q_chunk: int = 1024):
    check_family(cfg)
    with region("attn"):
        h, ck, cv = attn_mod.attention_prefill(
            p["attn"], cfg, norm(p["ln1"], x, kind=cfg.norm_kind,
                                 eps=cfg.norm_eps),
            positions, max_len, impl=attn_impl, cache_dtype=cache_dtype,
            q_chunk=q_chunk)
    x = x + h
    y, _ = _ffn(p, cfg, x)
    return x + y, {"k": ck, "v": cv}


def tblock_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Params, cur_len, *, window: int | None = None,
                  sinks: int = 0, write_mask: torch.Tensor | None = None):
    """One block of a cached decode step; the layer's cache is updated in
    place (``write_mask`` False rows keep their entries) and returned.

    A MoE block is dropless here: capacity drops depend on the batch's
    composition, which would break continuous batching's equivalence
    with single-request runs."""
    check_family(cfg)
    h, ck, cv = attn_mod.attention_decode(
        p["attn"], cfg, norm(p["ln1"], x, kind=cfg.norm_kind,
                             eps=cfg.norm_eps),
        cache["k"], cache["v"], cur_len, window=window, sinks=sinks,
        write_mask=write_mask)
    x = x + h
    y, _ = _ffn(p, cfg, x, decode=True)
    return x + y, {"k": ck, "v": cv}
