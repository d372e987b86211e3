"""Block composition: the standard transformer block (dense / moe /
audio / vlm), the xLSTM pair (ssm) and the zamba2 group of Mamba2 layers
with its weight-shared attention block (hybrid), each with init /
forward / prefill / decode.

Port of ``src/repro/models/transformer.py``. Block forwards return
``(x, aux)`` as the reference's do: aux is the MoE load-balancing loss,
0 for the other families. A MoE block's FFN is
:func:`repro_torch.models.moe.moe_ffn` (regions ``moe_router`` and
``moe_ffn``, with no ``ffn`` region around them, as in the reference):
the capacity path in forward and prefill, dropless in decode. A zamba2
group is a list of layers (the reference stacks them and scans); the
shared block runs under the ``shared_attn`` region.

Decode functions update the layer's cache in place and return it: a
``write_mask`` [B] keeps the False rows' entries (KV rows and recurrent
state alike), as the reference's ``_mask_cache`` does on its new trees.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import region
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import Params, mlp, mlp_init, norm, norm_init

__all__ = ["ATTN_FAMILIES", "FAMILIES", "check_family", "tblock_init",
           "tblock_forward", "tblock_prefill", "tblock_decode",
           "xlstm_pair_init", "xlstm_pair_forward", "xlstm_pair_prefill",
           "xlstm_pair_decode", "shared_attn_init", "shared_attn_forward",
           "shared_attn_prefill", "shared_attn_decode", "zamba_group_init",
           "zamba_group_forward", "zamba_group_prefill",
           "zamba_group_decode"]

# The families built of the standard attention block, and all six.
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the models do not know, as the
    reference's ``init_params`` does."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _commit(cache: Params, new: Params, write_mask) -> Params:
    """Write a layer's new state into its cache in place, in the cache's
    dtypes; rows where ``write_mask`` [B] is False keep their state."""
    for k, t in cache.items():
        if isinstance(t, dict):
            _commit(t, new[k], write_mask)
            continue
        n = new[k].to(t.dtype)
        if hasattr(t, "placements") and tuple(n.placements) != tuple(
                t.placements):
            n = n.redistribute(t.device_mesh, t.placements)
        if write_mask is not None:
            wm = write_mask.to(device=t.device, dtype=torch.bool)
            n = torch.where(wm.view(-1, *[1] * (t.ndim - 1)), n, t)
        t.copy_(n)
    return cache


# -- standard transformer block (dense / moe / audio / vlm) -------------------

def tblock_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
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
    h, ck, cv = attn_mod.attention_decode(
        p["attn"], cfg, norm(p["ln1"], x, kind=cfg.norm_kind,
                             eps=cfg.norm_eps),
        cache["k"], cache["v"], cur_len, window=window, sinks=sinks,
        write_mask=write_mask)
    x = x + h
    y, _ = _ffn(p, cfg, x, decode=True)
    return x + y, {"k": ck, "v": cv}


# -- xLSTM pair (mLSTM block + sLSTM block) -----------------------------------

def xlstm_pair_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "ln_m": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "ln_s": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "m": xlstm_mod.mlstm_init(generator, cfg),
        "s": xlstm_mod.slstm_init(generator, cfg),
    }


def _ln(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return norm(p, x, kind=cfg.norm_kind, eps=cfg.norm_eps)


def xlstm_pair_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions, *, attn_impl: str = "full",
                       chunk: int = 128):
    del positions, attn_impl
    x = x + xlstm_mod.mlstm_forward(p["m"], cfg, _ln(p["ln_m"], cfg, x),
                                    chunk=chunk)
    x = x + xlstm_mod.slstm_forward(p["s"], cfg, _ln(p["ln_s"], cfg, x))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def xlstm_pair_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions, *, chunk: int = 128):
    del positions
    h, cm = xlstm_mod.mlstm_forward(p["m"], cfg, _ln(p["ln_m"], cfg, x),
                                    chunk=chunk, return_cache=True)
    x = x + h
    h, cs = xlstm_mod.slstm_forward(p["s"], cfg, _ln(p["ln_s"], cfg, x),
                                    return_cache=True)
    return x + h, {"m": cm, "s": cs}


def xlstm_pair_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, cur_len, *,
                      write_mask: torch.Tensor | None = None):
    del cur_len
    h, cm = xlstm_mod.mlstm_decode(p["m"], cfg, _ln(p["ln_m"], cfg, x),
                                   cache["m"])
    x = x + h
    h, cs = xlstm_mod.slstm_decode(p["s"], cfg, _ln(p["ln_s"], cfg, x),
                                   cache["s"])
    return x + h, _commit(cache, {"m": cm, "s": cs}, write_mask)


# -- zamba2 hybrid: groups of mamba2 layers + a weight-shared attn block ------

def shared_attn_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "ln2": norm_init(cfg.d_model, cfg.norm_kind, dev),
        "attn": attn_mod.attention_init(generator, cfg),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff,
                        gated=cfg.gated_mlp),
    }


def _shared_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor):
    return x + mlp(p["mlp"], _ln(p["ln2"], cfg, x), gated=cfg.gated_mlp,
                   act=cfg.act)


def shared_attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, *, attn_impl: str = "full",
                        q_chunk: int = 1024):
    with region("shared_attn"):
        x = x + attn_mod.attention(p["attn"], cfg, _ln(p["ln1"], cfg, x),
                                   positions, impl=attn_impl,
                                   q_chunk=q_chunk)
        return _shared_mlp(p, cfg, x)


def shared_attn_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, max_len: int, *,
                        attn_impl: str = "chunked",
                        cache_dtype=torch.bfloat16, q_chunk: int = 1024):
    with region("shared_attn"):
        h, ck, cv = attn_mod.attention_prefill(
            p["attn"], cfg, _ln(p["ln1"], cfg, x), positions, max_len,
            impl=attn_impl, cache_dtype=cache_dtype, q_chunk=q_chunk)
        return _shared_mlp(p, cfg, x + h), {"k": ck, "v": cv}


def shared_attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       cache: Params, cur_len, *, window: int | None = None,
                       sinks: int = 0,
                       write_mask: torch.Tensor | None = None):
    h, ck, cv = attn_mod.attention_decode(
        p["attn"], cfg, _ln(p["ln1"], cfg, x), cache["k"], cache["v"],
        cur_len, window=window, sinks=sinks, write_mask=write_mask)
    return _shared_mlp(p, cfg, x + h), {"k": ck, "v": cv}


def zamba_group_init(generator: torch.Generator, cfg: ModelConfig,
                     group_size: int) -> list:
    """``group_size`` mamba2 layers, a list of {"ln", "ssm"}."""
    dev = generator.device
    return [{"ln": norm_init(cfg.d_model, cfg.norm_kind, dev),
             "ssm": ssm_mod.ssm_init(generator, cfg)}
            for _ in range(group_size)]


def zamba_group_forward(p: list, cfg: ModelConfig, x: torch.Tensor, *,
                        chunk: int = 128):
    for pl in p:
        x = x + ssm_mod.ssm_forward(pl["ssm"], cfg, _ln(pl["ln"], cfg, x),
                                    chunk=chunk)
    return x


def zamba_group_prefill(p: list, cfg: ModelConfig, x: torch.Tensor, *,
                        chunk: int = 128):
    caches = []
    for pl in p:
        y, c = ssm_mod.ssm_forward(pl["ssm"], cfg, _ln(pl["ln"], cfg, x),
                                   chunk=chunk, return_cache=True)
        x = x + y
        caches.append(c)
    return x, caches


def zamba_group_decode(p: list, cfg: ModelConfig, x: torch.Tensor,
                       caches: list, *,
                       write_mask: torch.Tensor | None = None):
    for pl, cl in zip(p, caches):
        y, new = ssm_mod.ssm_decode(pl["ssm"], cfg, _ln(pl["ln"], cfg, x),
                                    cl)
        _commit(cl, new, write_mask)
        x = x + y
    return x, caches
