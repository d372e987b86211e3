"""hubert-xlarge [audio] — encoder-only (w2v2 arch): 48L d_model=1280
16H MHA d_ff=5120 vocab=504 (masked-unit prediction). The conv waveform
frontend is a STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab_size=504,
    causal=False, use_rope=False, norm_kind="layer", gated_mlp=False,
    act="gelu", embed_inputs=True, remat="full",
)
