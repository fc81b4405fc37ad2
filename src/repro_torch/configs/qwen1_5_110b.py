"""Qwen1.5 110B [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    citation="hf:Qwen/Qwen1.5-0.5B",
)
