"""Dense decoder transformer (the JAX package's ``models/transformer.py``,
dense family): GQA, RoPE, qk-norm, QKV bias, tied embeddings; the training
forward, and the serving path (``prefill``, ``init_cache``, ``decode_step``).

Block params are stacked over a leading layer axis under ``blocks``, as in
JAX (``blocks/attn/wq`` is (layers, d_model, heads, head_dim)), so the
packed layout and weight carry-over match key for key. The JAX forward
scans the stack under remat; the port loops over ``unbind`` views of it
and keeps the activations (remat changes no numbers, and at the training
shapes this path runs, B=8 and S=64, they take a few GB).

The KV cache is ``{"k", "v"}`` of shape (layers, B, S, KV, D) in
``cfg.dtype`` and ``"pos"``, a 0-d int32 tensor on the device, as JAX's.
``decode_step`` writes the new keys and values into ``cache["k"]`` and
``cache["v"]`` IN PLACE, layer by layer (JAX returns new arrays from its
scan), and returns them with ``pos + 1``: a cache is not reused after a
step.
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


def _block_fwd(x, bp, cfg: ModelConfig, positions, use_pallas=False):
    h = x + L.attention_block(
        L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps), bp["attn"], cfg,
        positions, use_pallas,
    )
    return _mlp_residual(h, bp, cfg)


def _mlp_residual(h, bp, cfg: ModelConfig):
    hn = L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps)
    return h + L.swiglu(hn, bp["mlp"])


def _layer_views(stack: dict, num_layers: int) -> list[dict]:
    """Per-layer param dicts. ``unbind`` gives every layer's slice of a
    stacked leaf at once, and its backward stacks the layer gradients in
    one pass (indexing layer by layer would allocate a full-size zero
    gradient per layer)."""
    per_leaf = tree_map(lambda x: x.unbind(0), stack)
    return [tree_map(lambda xs: xs[i], per_leaf) for i in range(num_layers)]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.input_mode != "tokens" or cfg.num_experts or cfg.meta_tokens:
        raise NotImplementedError(
            f"{cfg.name}: only the dense token-input transformer is ported "
            f"(ROADMAP Queue 1, item 9)"
        )


def forward(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """-> (logits (B, S, V) f32, aux dict). ``use_pallas`` runs attention
    through the flash kernel (no gradient)."""
    _check_ported(cfg)
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in _layer_views(params["blocks"], cfg.num_layers):
        x = _block_fwd(x, bp, cfg, positions, use_pallas)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


def loss_fn(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """Causal-LM (next-token) loss, or masked prediction for encoders."""
    logits, aux = forward(params, cfg, batch, use_pallas=use_pallas)
    labels = batch["labels"]
    if cfg.is_encoder_only:
        ce = L.cross_entropy(logits, labels)
    else:
        ce = L.cross_entropy(logits[:, :-1], labels[:, 1:])
    total = ce + aux["aux_loss"]
    return total, {"ce": ce, "aux_loss": aux["aux_loss"]}


# ---------------------------------------------------------------------------
# serving: prefill, KV cache, decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            use_pallas: bool = False):
    """Process a full prompt -> (last-position logits (B, V) f32, cache).

    The cache is laid out as ``decode_step`` expects: full length with
    pos = S for full-attention configs; rolling and window-aligned for
    sliding-window configs (the latest token in the last slot). The head
    is applied to the last position only (JAX forms the (B, S, V) logits
    and keeps their last row; at full width and B=8, S=512 those are 2.5 GB
    of f32).
    """
    _check_ported(cfg)
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    cache = init_cache(cfg, B, cache_len, device=x.device)
    if cfg.sliding_window:  # the last min(S, W) keys, right-aligned
        n = min(S, W)
        dst, src = slice(W - n, W), slice(S - n, S)
    else:
        dst = src = slice(0, S)
    for i, bp in enumerate(_layer_views(params["blocks"], cfg.num_layers)):
        hn = L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
        a_out, k, v = L.attention_block_kv(hn, bp["attn"], cfg, positions,
                                           use_pallas)
        cache["k"][i, :, dst] = k[:, src]
        cache["v"][i, :, dst] = v[:, src]
        x = _mlp_residual(x + a_out, bp, cfg)
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x)[:, 0]
    cache["pos"].fill_(S)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda") -> dict:
    """A zero KV cache on ``device``. Sliding-window configs keep a rolling
    window-sized cache (O(window), not O(seq)), as JAX's."""
    dt = getattr(torch, dtype or cfg.dtype)
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens, *,
                use_pallas: bool = False):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32, the
    cache with its k and v updated in place and pos + 1). ``use_pallas``
    is accepted for API parity; the one-token step has no kernel (as in
    JAX).

    Limit: on a full-attention config (no sliding window) the step writes
    cache row ``pos``, so ``pos`` must stay below the cache's length. JAX
    clamps the index and overwrites the last row; here ``index_copy_``
    raises on the CPU and trips a device-side assert on the card, which
    ends the CUDA context. ``pos`` lives on the device and is not checked
    here (that would sync the host every token): ``launch/serve.py::
    generate`` refuses ``cache_len < prompt + max_new`` before prefill.
    Rolling window caches shift and have no such limit."""
    del use_pallas
    _check_ported(cfg)
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])
    k_all, v_all = cache["k"], cache["v"]
    rolling = bool(cfg.sliding_window) and \
        k_all.shape[2] <= cfg.sliding_window
    attend = _window_attention_decode if rolling else L.attention_decode
    for i, bp in enumerate(_layer_views(params["blocks"], cfg.num_layers)):
        hn = L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
        a_out, _, _ = attend(hn, bp["attn"], cfg, k_all[i], v_all[i], pos)
        x = _mlp_residual(x + a_out, bp, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x)[:, 0]
    return logits, {"k": k_all, "v": v_all, "pos": pos + 1}


def _window_attention_decode(x, p, cfg: ModelConfig, kc, vc, pos):
    """Rolling window-cache decode: shift left and append, IN PLACE. Keys
    are roped at their absolute positions when inserted, so the rolling
    buffer needs no re-rotation."""
    q, k_new, v_new = L._qkv(x, p, cfg, pos.view(1))
    kc.copy_(torch.cat([kc[:, 1:], k_new.to(kc.dtype)], dim=1))
    vc.copy_(torch.cat([vc[:, 1:], v_new.to(vc.dtype)], dim=1))
    W = kc.shape[1]
    win_pos = pos - W + 1 + torch.arange(W, device=x.device)
    out = L.decode_attention(q, kc, vc, win_pos >= 0, cfg)
    return L.out_proj(out, p, x.dtype), kc, vc
