"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304; alternating
mLSTM (matrix memory) + sLSTM (scalar memory) blocks. [arXiv:2405.04517;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
    d_ff=0, vocab_size=50304,
    use_rope=False, slstm_every=2, remat="full",
)
