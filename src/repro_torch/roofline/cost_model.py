"""Analytic per-region cost model: (arch × shape) → list[RegionCost].

Used to synthesize device timelines for ALEA validation (§5 protocol) and
the §7 energy-optimization use cases. Totals are cross-checked against the
dry-run's compiled cost_analysis in tests (MODEL_FLOPS ratio) — this model
intentionally counts *useful* work (causal attention halved, no remat
recompute), so it is the 6·N·D-style denominator, not the HLO numerator.

All FLOPs/bytes are whole-step (all chips), matching RegionCost semantics;
``ici_bytes`` is per-chip link traffic.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.timeline import RegionCost

__all__ = ["step_region_costs"]


def _attn_region(cfg: ModelConfig, tokens: int, kv_len: int, *,
                 training: bool, n_layers: int, causal: bool) -> list[RegionCost]:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mult = 3 if training else 1          # fwd + 2x bwd
    proj_flops = 2 * tokens * d * dh * (H + 2 * KV) + 2 * tokens * H * dh * d
    score_flops = 2 * tokens * kv_len * dh * H * 2
    if causal and kv_len == 0:
        pass
    if causal and kv_len > 1:
        score_flops //= 2                # causal triangle
    bytes_proj = 2 * (tokens * d * 2 + d * dh * (H + 2 * KV))
    bytes_score = 2 * tokens * H * dh * 2 + 2 * tokens * KV * dh * 2 * (
        kv_len // max(tokens, 1) if kv_len > tokens else 1)
    return [
        RegionCost("attn_qkv", mult * proj_flops * 0.6,
                   mult * bytes_proj, invocations=n_layers),
        RegionCost("attn_score", mult * score_flops,
                   mult * bytes_score, invocations=n_layers),
        RegionCost("attn_out", mult * proj_flops * 0.4,
                   mult * bytes_proj * 0.4, invocations=n_layers),
    ]


def _ffn_region(cfg: ModelConfig, tokens: int, *, training: bool,
                n_layers: int) -> list[RegionCost]:
    d = cfg.d_model
    mult = 3 if training else 1
    if cfg.family == "moe":
        ff = cfg.moe_d_ff
        flops = 2 * tokens * cfg.top_k * 3 * d * ff
        wbytes = cfg.n_experts * 3 * d * ff * 2
        return [
            RegionCost("moe_router", mult * 2 * tokens * d * cfg.n_experts,
                       mult * tokens * d * 2, invocations=n_layers),
            RegionCost("moe_ffn", mult * flops, mult * (wbytes + tokens * d * 4),
                       ici_bytes=2 * tokens * d * 2 / 16,  # dispatch+combine
                       invocations=n_layers),
        ]
    n_mats = 3 if cfg.gated_mlp else 2
    ff = cfg.d_ff
    flops = 2 * tokens * n_mats * d * ff
    wbytes = n_mats * d * ff * 2
    return [RegionCost("ffn", mult * flops,
                       mult * (wbytes + tokens * d * 4),
                       invocations=n_layers)]


def _ssm_region(cfg: ModelConfig, tokens: int, *, training: bool,
                n_layers: int) -> list[RegionCost]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    mult = 3 if training else 1
    proj = 2 * tokens * d * (2 * d_in + 2 * N + H) + 2 * tokens * d_in * d
    scan = tokens * (cfg.ssm_head_dim * N * H * 6)    # SSD state updates
    return [
        RegionCost("ssm_proj", mult * proj,
                   mult * (tokens * d * 2 + d * 2 * d_in * 2),
                   invocations=n_layers),
        RegionCost("ssm_scan", mult * scan,
                   mult * tokens * d_in * 4, invocations=n_layers),
    ]


def step_region_costs(cfg: ModelConfig, shape: ShapeConfig,
                      *, chips: int = 256) -> list[RegionCost]:
    """Per-region costs of one step (train/prefill/decode per shape.kind)."""
    training = shape.kind == "train"
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (S if shape.kind != "decode" else 1)
    kv_len = S
    costs: list[RegionCost] = []

    # Embedding + head + loss.
    emb_bytes = tokens * cfg.d_model * 4 * (3 if training else 1)
    costs.append(RegionCost("embed", 0.0, emb_bytes))
    head_flops = 2 * tokens * cfg.d_model * cfg.vocab_size
    costs.append(RegionCost(
        "lm_head", (3 if training else 1) * head_flops,
        cfg.d_model * cfg.vocab_size * 2 + tokens * cfg.vocab_size * 4))
    if training:
        costs.append(RegionCost("loss", 6 * tokens * cfg.vocab_size,
                                tokens * cfg.vocab_size * 8))

    L = cfg.n_layers
    fam = cfg.family
    if fam in ("dense", "moe", "audio", "vlm"):
        costs += _attn_region(cfg, tokens, kv_len, training=training,
                              n_layers=L, causal=cfg.causal)
        costs += _ffn_region(cfg, tokens, training=training, n_layers=L)
    elif fam == "ssm":        # xLSTM: mLSTM ~ attnless linear + sLSTM scan
        costs += _ssm_region(
            cfg.replace(ssm_expand=1, ssm_state=cfg.head_dim,
                        ssm_head_dim=cfg.head_dim),
            tokens, training=training, n_layers=L)
    else:                      # hybrid
        n_attn = L // cfg.attn_every
        costs += _ssm_region(cfg, tokens, training=training, n_layers=L)
        costs += _attn_region(cfg, tokens, kv_len, training=training,
                              n_layers=n_attn, causal=True)
        costs += _ffn_region(cfg.replace(family="dense"), tokens,
                             training=training, n_layers=n_attn)

    if training:
        # Optimizer + gradient all-reduce/reduce-scatter over DP.
        n_params = cfg.param_count()
        costs.append(RegionCost("optimizer", 8 * n_params, 16 * n_params))
        costs.append(RegionCost("grad_allreduce", 0.0, 2 * n_params * 4,
                                ici_bytes=2 * n_params * 4 / chips))
    return costs
