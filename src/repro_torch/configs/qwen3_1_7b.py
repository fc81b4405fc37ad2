"""Qwen3 1.7B [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    # sliding-window serve variant enables the long_500k demonstration
    # (see DESIGN.md section 7); training/prefill use full causal attention.
    citation="hf:Qwen/Qwen3-8B",
)
