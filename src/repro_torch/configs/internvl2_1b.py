"""internvl2-1b [vlm] — InternViT (stub frontend: precomputed patch embeds)
+ Qwen2-0.5B LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

N_PATCHES = 256  # stub ViT frontend emits this many patch embeddings

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151655,
    rope_theta=1e6, remat="full",
)
