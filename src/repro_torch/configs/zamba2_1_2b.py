"""zamba2-1.2b [hybrid] — 38 Mamba2 layers + ONE weight-shared attention
(+MLP) block invoked every 6 layers: d_model=2048, shared attn 32H MHA,
d_ff=8192, vocab=32000, ssm_state=64. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_head_dim=64, ssm_expand=2,
    attn_every=6, remat="full",
)
