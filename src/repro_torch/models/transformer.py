"""Dense decoder transformer (the JAX package's ``models/transformer.py``,
dense family, training path): GQA, RoPE, qk-norm, QKV bias, tied
embeddings.

Block params are stacked over a leading layer axis under ``blocks``, as in
JAX (``blocks/attn/wq`` is (layers, d_model, heads, head_dim)), so the
packed layout and weight carry-over match key for key. The JAX forward
scans the stack under remat; the port loops over ``unbind`` views of it
and keeps the activations (remat changes no numbers, and at the training
shapes this path runs, B=8 and S=64, they take a few GB).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_map


def init(gen, cfg: ModelConfig, device) -> dict:
    """Random f32 params from ``gen`` (JAX init's shapes and scales; the
    draws differ, since torch cannot reproduce jax.random streams)."""
    lead = (cfg.num_layers,)
    return {
        "blocks": {
            "attn": L.init_attention(gen, cfg, device, lead),
            "attn_norm": L.init_rmsnorm(cfg.d_model, device, lead),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device, lead),
            "mlp_norm": L.init_rmsnorm(cfg.d_model, device, lead),
        },
        "embed": L.init_embed(gen, cfg, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }


def _block_fwd(x, bp, cfg: ModelConfig, positions):
    h = x + L.attention_block(
        L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps), bp["attn"], cfg,
        positions,
    )
    hn = L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps)
    return h + L.swiglu(hn, bp["mlp"])


def _layer_views(stack: dict, num_layers: int) -> list[dict]:
    """Per-layer param dicts. ``unbind`` gives every layer's slice of a
    stacked leaf at once, and its backward stacks the layer gradients in
    one pass (indexing layer by layer would allocate a full-size zero
    gradient per layer)."""
    per_leaf = tree_map(lambda x: x.unbind(0), stack)
    return [tree_map(lambda xs: xs[i], per_leaf) for i in range(num_layers)]


def forward(params, cfg: ModelConfig, batch):
    """-> (logits (B, S, V) f32, aux dict)."""
    if cfg.input_mode != "tokens" or cfg.num_experts or cfg.meta_tokens:
        raise NotImplementedError(
            f"{cfg.name}: only the dense token-input transformer is ported "
            f"(ROADMAP Queue 1, item 9)"
        )
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in _layer_views(params["blocks"], cfg.num_layers):
        x = _block_fwd(x, bp, cfg, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


def loss_fn(params, cfg: ModelConfig, batch):
    """Causal-LM (next-token) loss, or masked prediction for encoders."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.is_encoder_only:
        ce = L.cross_entropy(logits, labels)
    else:
        ce = L.cross_entropy(logits[:, :-1], labels[:, 1:])
    total = ce + aux["aux_loss"]
    return total, {"ce": ce, "aux_loss": aux["aux_loss"]}
