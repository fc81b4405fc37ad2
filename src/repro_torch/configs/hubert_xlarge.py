"""HuBERT X-Large [audio] — encoder-only, wav2vec2 backbone
[arXiv:2106.07447]. Conv/mel frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, T, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,      # masked-prediction codebook
    causal=False,        # encoder-only: bidirectional attention, no decode
    input_mode="embeddings",
    rope_theta=10000.0,
    citation="arXiv:2106.07447",
)
