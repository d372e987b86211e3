"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE, LayerNorm, plain-GELU MLP. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
    d_ff=24576, vocab_size=49152,
    norm_kind="layer", gated_mlp=False, act="gelu",
    rope_theta=1e5, remat="full",
)
