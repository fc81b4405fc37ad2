"""Decoder/encoder transformer (the JAX package's ``models/transformer.py``):
the dense, MoE, audio and VLM families. GQA, RoPE, qk-norm, QKV bias, tied
embeddings, MoE layers (``models/moe.py``), sliding-window attention, the
stub modality frontends (precomputed audio frames, VLM patch embeddings)
and meta-token prefixes; the training forward, and the serving path
(``prefill``, ``init_cache``, ``decode_step``).

Block params are stacked over a leading layer axis under ``blocks``, as in
JAX (``blocks/attn/wq`` is (layers, d_model, heads, head_dim)), so the
packed layout and weight carry-over match key for key. MoE configs with
``first_dense_layers`` keep the leading dense blocks in a separate
``dense_blocks`` stack, and ``blocks`` then holds the MoE blocks (``moe``
in place of ``mlp``). The JAX forward scans each stack under remat; the
port loops over ``unbind`` views of it and keeps the activations (remat
changes no numbers, and at the training shapes this path runs, B=8 and
S=64, they take a few GB).

The KV cache is ``{"k", "v"}`` of shape (layers, B, S, KV, D) in
``cfg.dtype`` and ``"pos"``, a 0-d int32 tensor on the device, as JAX's;
layer ``i`` of it is dense for ``i < first_dense_layers`` and MoE after.
``decode_step`` writes the new keys and values into ``cache["k"]`` and
``cache["v"]`` IN PLACE, layer by layer (JAX returns new arrays from its
scan), and returns them with ``pos + 1``: a cache is not reused after a
step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_layer
from repro_torch.utils.tree import tree_leaves, tree_map


def _init_stack(gen, cfg: ModelConfig, device, n: int, moe: bool) -> dict:
    lead = (n,)
    p = {
        "attn": L.init_attention(gen, cfg, device, lead),
        "attn_norm": L.init_rmsnorm(cfg.d_model, device, lead),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, device, lead),
    }
    if moe:
        p["moe"] = init_moe(gen, cfg, device, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, device, lead)
    return p


def init(gen, cfg: ModelConfig, device) -> dict:
    """Random f32 params from ``gen`` (JAX init's keys, shapes and scales;
    the draws differ, since torch cannot reproduce jax.random streams)."""
    params = {}
    if cfg.num_experts:
        nd = cfg.first_dense_layers
        if nd:
            params["dense_blocks"] = _init_stack(gen, cfg, device, nd, False)
        params["blocks"] = _init_stack(gen, cfg, device,
                                       cfg.num_layers - nd, True)
    else:
        params["blocks"] = _init_stack(gen, cfg, device, cfg.num_layers,
                                       False)
    params["embed"] = L.init_embed(gen, cfg, device)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device)
    return params


def _ffn_residual(h, bp, cfg: ModelConfig, moe: bool, dropless: bool):
    """h + the block's MLP or MoE of rmsnorm(h) -> (out, MoE aux or None)."""
    hn = L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps)
    if moe:
        y, aux = moe_layer(hn, bp["moe"], cfg, dropless)
        return h + y, aux
    return h + L.swiglu(hn, bp["mlp"]), None


def _block_fwd(x, bp, cfg: ModelConfig, positions, moe: bool,
               use_pallas=False, dropless=False):
    h = x + L.attention_block(
        L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps), bp["attn"], cfg,
        positions, use_pallas,
    )
    return _ffn_residual(h, bp, cfg, moe, dropless)


def _layer_views(stack: dict) -> list[dict]:
    """Per-layer param dicts. ``unbind`` gives every layer's slice of a
    stacked leaf at once, and its backward stacks the layer gradients in
    one pass (indexing layer by layer would allocate a full-size zero
    gradient per layer)."""
    per_leaf = tree_map(lambda x: x.unbind(0), stack)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda xs: xs[i], per_leaf) for i in range(n)]


def _layers(params, cfg: ModelConfig) -> list[tuple[dict, bool]]:
    """(block params, is MoE) of every layer in order: the dense stack
    first, then ``blocks``."""
    out = []
    if "dense_blocks" in params:
        out += [(bp, False) for bp in _layer_views(params["dense_blocks"])]
    moe = cfg.num_experts > 0
    return out + [(bp, moe) for bp in _layer_views(params["blocks"])]


def _embed_inputs(params, cfg: ModelConfig, batch):
    """-> (x (B, S, d), prefix mask (B, S) or None): token embeddings,
    precomputed audio frames, or VLM patches (plus their positional bias)
    before the text, behind the meta tokens where the config has them."""
    dt = getattr(torch, cfg.dtype)
    if cfg.input_mode == "tokens":
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        mask = None
    elif cfg.input_mode == "embeddings":  # audio: precomputed frames (stub)
        x = batch["embeddings"].to(dt)
        mask = None
    elif cfg.input_mode == "tokens+patches":  # vlm: patch embeds + text
        patches = (batch["patches"].to(dt)
                   + params["embed"]["patch_pos"].to(dt))
        text = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        x = torch.cat([patches, text], dim=1)
        B, P = patches.shape[:2]
        mask = torch.cat([
            torch.zeros((B, P), dtype=torch.bool, device=x.device),
            torch.ones((B, text.shape[1]), dtype=torch.bool,
                       device=x.device)], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    if cfg.meta_tokens:
        B = x.shape[0]
        meta = params["embed"]["meta"].to(dt).expand(B, cfg.meta_tokens,
                                                     cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        if mask is not None:
            mask = torch.cat([
                torch.zeros((B, cfg.meta_tokens), dtype=torch.bool,
                            device=x.device), mask], dim=1)
    return x, mask


def forward(params, cfg: ModelConfig, batch, *, use_pallas: bool = False,
            train: bool = False):
    """-> (logits (B, S_total, V) f32, aux dict). ``use_pallas`` runs
    attention through the flash kernel (no gradient). ``train=True`` (the
    loss path) keeps MoE capacity dropping; serving and eval callers get
    the dropless dispatch, so batched logits match token-by-token decode
    (see ``moe._capacity``)."""
    x, mask = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), device=x.device)
    for bp, moe in _layers(params, cfg):
        x, aux = _block_fwd(x, bp, cfg, positions, moe, use_pallas,
                            dropless=not train)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x)
    return logits, {"aux_loss": aux_total, "prefix_mask": mask}


def loss_fn(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """Causal-LM (next-token) loss, or masked prediction for encoders, plus
    the MoE aux loss."""
    logits, aux = forward(params, cfg, batch, use_pallas=use_pallas,
                          train=True)
    labels = batch["labels"]
    if cfg.is_encoder_only:
        # masked prediction at the positions whose labels are >= 0
        ce = L.cross_entropy(logits, labels)
    else:
        # the prefix (patches, meta tokens) carries no labels
        pad = logits.shape[1] - labels.shape[1]
        if pad:
            labels = torch.cat([labels.new_full((labels.shape[0], pad), -1),
                                labels], dim=1)
        ce = L.cross_entropy(logits[:, :-1], labels[:, 1:])
    total = ce + aux["aux_loss"]
    return total, {"ce": ce, "aux_loss": aux["aux_loss"]}


# ---------------------------------------------------------------------------
# serving: prefill, KV cache, decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            use_pallas: bool = False):
    """Process a full prompt -> (last-position logits (B, V) f32, cache).

    The prompt is the model's whole input: a VLM's patches sit at
    positions 0..P-1 before its text, so ``cache_len`` must cover the
    patches, the text and the tokens to decode, and decode goes on at
    pos = P + S. The cache is laid out as ``decode_step`` expects: full
    length with pos = S for full-attention configs; rolling and
    window-aligned for sliding-window configs (the latest token in the
    last slot). MoE layers take the dropless dispatch. The head is applied
    to the last position only (JAX forms the (B, S, V) logits and keeps
    their last row; at full width and B=8, S=512 those are 2.5 GB of f32).
    """
    x, _ = _embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    cache = init_cache(cfg, B, cache_len, device=x.device)
    if cfg.sliding_window:  # the last min(S, W) keys, right-aligned
        n = min(S, W)
        dst, src = slice(W - n, W), slice(S - n, S)
    else:
        dst = src = slice(0, S)
    for i, (bp, moe) in enumerate(_layers(params, cfg)):
        hn = L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
        a_out, k, v = L.attention_block_kv(hn, bp["attn"], cfg, positions,
                                           use_pallas)
        cache["k"][i, :, dst] = k[:, src]
        cache["v"][i, :, dst] = v[:, src]
        del hn, k, v
        x, _ = _ffn_residual(x + a_out, bp, cfg, moe, dropless=True)
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
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])
    k_all, v_all = cache["k"], cache["v"]
    rolling = bool(cfg.sliding_window) and \
        k_all.shape[2] <= cfg.sliding_window
    attend = _window_attention_decode if rolling else L.attention_decode
    for i, (bp, moe) in enumerate(_layers(params, cfg)):
        hn = L.rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
        a_out, _, _ = attend(hn, bp["attn"], cfg, k_all[i], v_all[i], pos)
        x, _ = _ffn_residual(x + a_out, bp, cfg, moe, dropless=True)
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
