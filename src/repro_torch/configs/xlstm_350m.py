"""xLSTM 350M [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,              # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    ssm_expand=2,
    slstm_every=4,       # every 4th block is an sLSTM block (1:3 ratio)
    citation="arXiv:2405.04517",
)
