"""Uniform model API of the port: the family registry and the batch
builders (the JAX package's ``models/api.py``).

  init_params(gen, cfg, device) -> params
  forward(params, cfg, batch, *, use_pallas=False) -> (logits, aux)
  loss_fn(params, cfg, batch, *, use_pallas=False) -> (loss, metrics)
  init_cache(cfg, batch, seq_len, dtype=None, device="cuda") -> cache
  prefill(params, cfg, batch, cache_len, *, use_pallas=False)
      -> (last-position logits (B, V), cache)
  decode_step(params, cfg, cache, tokens, *, use_pallas=False)
      -> (logits (B, V), cache)

  batch_shapes(cfg, batch, seq_len) -> {name: (shape, dtype)}
  make_batch(gen, cfg, batch, seq_len) -> one synthetic training batch

``use_pallas`` runs full-sequence attention through the hand-written flash
kernel (``kernels/ops.py::flash_attention``), as the JAX package's flag
runs its Pallas kernel; it has no gradient. The dense, MoE, audio and VLM
families are the transformer's, the hybrid family is Hymba's
(``models/hymba.py``) and the SSM family xLSTM's (``models/xlstm.py``);
those two accept ``use_pallas`` and ignore it, as JAX's do.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hymba, transformer, xlstm

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "audio": transformer,
    "vlm": transformer,
    "ssm": xlstm,
    "hybrid": hymba,
}


def get_model(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def init_params(gen, cfg: ModelConfig, device="cuda"):
    """Random f32 params on ``device``; ``device="meta"`` gives shapes only
    (``gen`` is then unused)."""
    return get_model(cfg).init(gen, cfg, torch.device(device))


def forward(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    return get_model(cfg).forward(params, cfg, batch, use_pallas=use_pallas)


def loss_fn(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    return get_model(cfg).loss_fn(params, cfg, batch, use_pallas=use_pallas)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda"):
    return get_model(cfg).init_cache(cfg, batch, seq_len, dtype=dtype,
                                     device=device)


def decode_step(params, cfg: ModelConfig, cache, tokens, *,
                use_pallas: bool = False):
    return get_model(cfg).decode_step(params, cfg, cache, tokens,
                                      use_pallas=use_pallas)


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            use_pallas: bool = False):
    """Process a prompt batch -> (last-position logits, decode-ready cache)."""
    return get_model(cfg).prefill(params, cfg, batch, cache_len,
                                  use_pallas=use_pallas)


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes and dtypes of one *training* batch for this config."""
    shapes = {}
    if cfg.input_mode == "tokens":
        shapes["tokens"] = ((batch, seq_len), torch.int32)
        shapes["labels"] = ((batch, seq_len), torch.int32)
    elif cfg.input_mode == "embeddings":
        # audio stub: frame embeddings of the (stubbed) conv/mel frontend
        shapes["embeddings"] = ((batch, seq_len, cfg.d_model), torch.float32)
        shapes["labels"] = ((batch, seq_len), torch.int32)
    elif cfg.input_mode == "tokens+patches":
        # vlm stub: ViT/projector patch embeddings, then text tokens
        shapes["patches"] = ((batch, cfg.num_patches, cfg.d_model),
                             torch.float32)
        shapes["tokens"] = ((batch, seq_len), torch.int32)
        shapes["labels"] = ((batch, seq_len), torch.int32)
    else:
        raise ValueError(cfg.input_mode)
    return shapes


def make_batch(gen, cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """A synthetic batch on ``gen``'s device, drawn from ``gen`` in
    ``batch_shapes`` order: integers uniform over the vocabulary, floats
    N(0, 0.02^2). An encoder's labels keep ~8 % of positions (masked
    prediction) and are -1 elsewhere. The draws differ from JAX's."""
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq_len).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                      device=gen.device, dtype=dtype)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=gen.device).mul_(0.02)
    if cfg.is_encoder_only:
        keep = torch.rand(out["labels"].shape, generator=gen,
                          device=gen.device) < 0.08
        out["labels"] = torch.where(keep, out["labels"],
                                    torch.full_like(out["labels"], -1))
    return out
