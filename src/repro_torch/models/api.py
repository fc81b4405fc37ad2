"""Uniform model API of the port (dense family only so far).

  init_params(gen, cfg, device) -> params
  forward(params, cfg, batch, *, use_pallas=False) -> (logits, aux)
  loss_fn(params, cfg, batch, *, use_pallas=False) -> (loss, metrics)
  init_cache(cfg, batch, seq_len, dtype=None, device="cuda") -> cache
  prefill(params, cfg, batch, cache_len, *, use_pallas=False)
      -> (last-position logits (B, V), cache)
  decode_step(params, cfg, cache, tokens, *, use_pallas=False)
      -> (logits (B, V), cache)

``use_pallas`` runs full-sequence attention through the hand-written flash
kernel (``kernels/ops.py::flash_attention``), as the JAX package's flag
runs its Pallas kernel; it has no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}


def get_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} is not ported yet "
            f"(ROADMAP Queue 1, item 9: the remaining model families)"
        )
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
