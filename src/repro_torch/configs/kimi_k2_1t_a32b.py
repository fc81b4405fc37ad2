"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,          # dense-FFN size for the leading dense layer(s)
    vocab_size=163840,
    num_experts=384,
    num_shared_experts=1,
    moe_top_k=8,
    d_expert=2048,
    first_dense_layers=1,
    rope_theta=50000.0,
    citation="arXiv:2501.kimi2 (paper-table)",
)
