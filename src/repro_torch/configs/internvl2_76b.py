"""InternVL2 76B [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].
Vision encoder + projector are STUBS: input_specs() provides precomputed
patch embeddings (B, num_patches, d_model) alongside text tokens."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    input_mode="tokens+patches",
    num_patches=256,
    rope_theta=1000000.0,
    citation="arXiv:2404.16821",
)
