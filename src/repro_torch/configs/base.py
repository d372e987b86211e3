"""Model/shape/run configuration dataclasses (the framework's config system).

One ``ModelConfig`` per assigned architecture lives in
``src/repro_torch/configs/<id>.py``; reduced smoke variants derive via
``ModelConfig.reduced()``. Input-shape cells are ``ShapeConfig`` instances
(shared across LM-family archs per the assignment).

A plain-Python copy of the JAX package's ``configs`` (no framework
imports on either side); the port's tests hold every config equal to the
reference's field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 ⇒ d_model // n_heads
    # attention
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 1e4
    use_rope: bool = True
    norm_kind: str = "rms"           # "rms" | "layer"
    gated_mlp: bool = True
    act: str = "silu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0              # zamba2: shared attn block period
    # xLSTM
    slstm_every: int = 0             # xlstm: sLSTM block period (rest mLSTM)
    # frontends (vlm/audio): inputs are precomputed embeddings (stub)
    embed_inputs: bool = False       # True ⇒ input_specs provide [B,S,d] embeds
    # numerics / training
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "none"              # none | dots | full
    compute_dtype: str = "bfloat16"
    # perf knobs (§Perf hillclimb; safe defaults = paper-faithful baseline)
    bf16_gather: bool = False        # cast params bf16 BEFORE FSDP gathers
    decode_grouped: bool = False     # GQA decode without KV-head repetition
    kv_cache_dtype: str = "bfloat16"  # "float8_e4m3fn" halves decode reads
    disable_sp: bool = False         # no seq_act sharding (tiny-d archs)

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads,
                                  4 * self.n_kv_heads // self.n_heads or 1)),
            d_head=32,
            d_ff=256,
            vocab_size=256,
        )
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.slstm_every:
            kw.update(slstm_every=2)
        return self.replace(name=self.name + "-smoke", **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, L = self.d_model, self.n_layers
        dh, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        n_attn = L if not self.attn_every else (L // self.attn_every)
        n_ssm = 0
        if self.family in ("ssm", "hybrid"):
            n_ssm = L
            attn_layers = 1 if self.attn_every else 0  # zamba2 shared block
        else:
            attn_layers = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * dh * (H + 2 * KV) + H * dh * d
            per_layer += attn
        if self.family == "moe":
            ff = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        elif self.family in ("dense", "audio", "vlm"):
            ff = (3 if self.gated_mlp else 2) * d * self.d_ff
        else:
            ff = 0
        per_layer += ff
        total = emb + L * per_layer
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ssm = (d * (2 * d_in + 2 * self.ssm_state) + d_in * d
                   + d_in * self.ssm_conv)
            total += n_ssm * ssm
            if self.attn_every:  # one shared attn+mlp block
                total += d * dh * (H + 2 * KV) + H * dh * d + 3 * d * self.d_ff
        if self.family == "ssm" and self.slstm_every:
            pass  # xlstm counts handled by ssm term approximation
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dh, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (H + 2 * KV) + H * dh * d
        ff = self.top_k * 3 * d * self.moe_d_ff + d * self.n_experts
        return int(emb + L * (attn + ff))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The assignment's four LM shapes.
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in
                                  (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)}
