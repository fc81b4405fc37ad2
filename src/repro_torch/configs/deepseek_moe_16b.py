"""DeepSeekMoE 16B [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,          # first layer is a dense FFN (DeepSeekMoE design)
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
    citation="arXiv:2401.06066",
)
