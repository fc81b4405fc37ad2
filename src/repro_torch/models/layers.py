"""Neural-net building blocks of the dense training path, as plain
functions over nested dicts of tensors (the JAX package's
``models/layers.py``, same keys, shapes and op order).

* Params are stored in float32 (the packed master plane); the forward
  casts weights to ``cfg.dtype`` (bf16 by default) where the JAX code
  does, keeps norm scales in f32, and returns float32 logits.
* Attention projections are 3-D ``(d_model, heads, head_dim)`` as in JAX.
* Only the full-sequence training path is here: ``chunked_attention``
  (above 8192 tokens), decode and the Pallas flash kernel are not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def normal(shape, std: float, gen, device) -> torch.Tensor:
    """N(0, std^2) f32 draws from ``gen``; shapes only on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=device) * std


def dense_init(gen, shape, in_axis_size: int, device) -> torch.Tensor:
    return normal(shape, 1.0 / math.sqrt(max(1, in_axis_size)), gen, device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def init_attention(gen, cfg: ModelConfig, device, lead=()) -> dict:
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, lead + (d, nq, hd), d, device),
        "wk": dense_init(gen, lead + (d, nkv, hd), d, device),
        "wv": dense_init(gen, lead + (d, nkv, hd), d, device),
        "wo": dense_init(gen, lead + (nq, hd, d), nq * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (nq, hd), device=device)
        p["bk"] = torch.zeros(lead + (nkv, hd), device=device)
        p["bv"] = torch.zeros(lead + (nkv, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = ones(lead + (hd,), device)
        p["k_norm"] = ones(lead + (hd,), device)
    return p


def init_mlp(gen, d_model: int, d_ff: int, device, lead=()) -> dict:
    return {
        "wi": dense_init(gen, lead + (d_model, 2, d_ff), d_model, device),
        "wo": dense_init(gen, lead + (d_ff, d_model), d_ff, device),
    }


def init_rmsnorm(d: int, device, lead=()) -> dict:
    return {"scale": ones(lead + (d,), device)}


def init_embed(gen, cfg: ModelConfig, device) -> dict:
    p = {"embedding": normal((cfg.vocab_size, cfg.d_model), 0.02, gen,
                             device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model, device)
    return p


# ---------------------------------------------------------------------------
# core ops
# ---------------------------------------------------------------------------


def rmsnorm(x, p, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"]
    return out.to(dt)


def _rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, p):
    """x: (..., d); wi (d, 2, f) holds [gate, up]; wo (f, d)."""
    wi = p["wi"].to(x.dtype)
    d, _, f = wi.shape
    h = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
    gate, up = h[..., 0, :], h[..., 1, :]
    return (F.silu(gate) * up) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(x, p, cfg: ModelConfig, positions):
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm(q, {"scale": p["q_norm"]}, cfg.norm_eps)
        k = rmsnorm(k, {"scale": p["k_norm"]}, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_scores_block(q, k, v, scale, mask):
    """Plain attention over one block; f32 softmax."""
    s = torch.einsum("bqhk,bshk->bhqs", q, k).to(torch.float32) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", p, v)


def _expand_kv(k, n_rep: int):
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def full_attention(q, k, v, *, causal, sliding_window=0, q_offset=0,
                   prefix_global=0):
    """Reference attention (materialises the score matrix)."""
    _, sq, nq, hd = q.shape
    sk = k.shape[1]
    n_rep = nq // k.shape[2]
    k, v = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if sliding_window:
        win = qpos[:, None] - kpos[None, :] < sliding_window
        if prefix_global:
            win |= kpos[None, :] < prefix_global
        mask &= win
    return attention_scores_block(q, k, v, 1.0 / math.sqrt(hd),
                                  mask[None, None])


# the JAX package switches to blockwise attention above this length; the
# port's training path has no blockwise attention yet
ATTN_CHUNK_THRESHOLD = 8192


def attention_block(x, p, cfg: ModelConfig, positions):
    """Self-attention over a full sequence (train)."""
    if x.shape[1] > ATTN_CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"sequence {x.shape[1]} > {ATTN_CHUNK_THRESHOLD}: the port has "
            f"no chunked/flash attention yet (ROADMAP Queue 2)"
        )
    q, k, v = _qkv(x, p, cfg, positions)
    out = full_attention(q, k, v, causal=cfg.causal,
                         sliding_window=cfg.sliding_window)
    nq, hd, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].to(x.dtype).reshape(nq * hd, d)


# ---------------------------------------------------------------------------
# embeddings / head / loss
# ---------------------------------------------------------------------------


def embed_tokens(p, cfg: ModelConfig, tokens):
    return p["embedding"].to(getattr(torch, cfg.dtype))[tokens]


def lm_head(p, cfg: ModelConfig, x):
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    return (x @ w.to(x.dtype)).to(torch.float32)


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy. labels: int, -1 entries ignored."""
    valid = labels >= 0
    if mask is not None:
        valid &= mask
    labels_c = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels_c[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)
