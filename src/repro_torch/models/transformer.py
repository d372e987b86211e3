"""Block composition: the dense transformer block, with init / forward /
prefill / decode.

Port of the dense half of ``src/repro/models/transformer.py``. Block
forwards return ``(x, aux)`` as the reference's do (aux is the MoE
load-balancing loss there; 0 for dense blocks). The MoE, xLSTM and
zamba2 blocks are not ported yet (ROADMAP A7) and raise.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import Params, mlp, mlp_init, norm, norm_init

__all__ = ["tblock_init", "tblock_forward", "tblock_prefill",
           "tblock_decode"]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family whose blocks the port does not have yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP A7); the port runs the dense family")


def tblock_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    check_family(cfg)
    dev = generator.device
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "ln2": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "attn": attn_mod.attention_init(generator, cfg),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff,
                        gated=cfg.gated_mlp),
    }


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return mlp(p["mlp"], norm(p["ln2"], x, kind=cfg.norm_kind,
                              eps=cfg.norm_eps),
               gated=cfg.gated_mlp, act=cfg.act)


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
    with region("ffn"):
        y = _ffn(p, cfg, x)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


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
    with region("ffn"):
        y = _ffn(p, cfg, x)
    return x + y, {"k": ck, "v": cv}


def tblock_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Params, cur_len, *, window: int | None = None,
                  sinks: int = 0, write_mask: torch.Tensor | None = None):
    """One block of a cached decode step; the layer's cache is updated in
    place (``write_mask`` False rows keep their entries) and returned."""
    check_family(cfg)
    h, ck, cv = attn_mod.attention_decode(
        p["attn"], cfg, norm(p["ln1"], x, kind=cfg.norm_kind,
                             eps=cfg.norm_eps),
        cache["k"], cache["v"], cur_len, window=window, sinks=sinks,
        write_mask=write_mask)
    x = x + h
    return x + _ffn(p, cfg, x), {"k": ck, "v": cv}
