"""Hymba 1.5B [hybrid] — parallel attention + mamba heads, meta tokens
[arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=2048,   # SWA on most layers (global on a few, cf. paper)
    meta_tokens=128,
    rope_theta=10000.0,
    citation="arXiv:2411.13676",
)
