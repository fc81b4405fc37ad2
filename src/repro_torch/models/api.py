"""Uniform model API of the port (dense family only so far).

  init_params(gen, cfg, device) -> params
  forward(params, cfg, batch) -> (logits, aux)
  loss_fn(params, cfg, batch) -> (loss, metrics)
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


def forward(params, cfg: ModelConfig, batch):
    return get_model(cfg).forward(params, cfg, batch)


def loss_fn(params, cfg: ModelConfig, batch):
    return get_model(cfg).loss_fn(params, cfg, batch)
