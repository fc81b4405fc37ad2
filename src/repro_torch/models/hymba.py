"""Hymba (arXiv:2411.13676): every layer runs attention heads and mamba
(selective-SSM) heads in parallel on the same input; the two branch
outputs are normalised, combined with learned per-branch scalars, and
projected (the JAX package's ``models/hymba.py``, same keys, shapes and op
order). ``meta_tokens`` learnable tokens are prepended and stay globally
attendable under the sliding window.

Block params are stacked over a leading layer axis under ``blocks``, as in
JAX; ``beta_attn`` and ``beta_ssm`` are (layers,) leaves. The SSM runs the
JAX package's associative scan (``_associative_scan``: the same odd/even
recursion as ``lax.associative_scan``, log depth, in plain PyTorch), and
the training forward recomputes each block in the backward pass
(``layers.remat``), as JAX's ``jax.checkpoint`` over its scan does.
Attention is the plain ``full_attention`` (``chunked_attention`` above
``ATTN_CHUNK_THRESHOLD`` tokens), as in JAX, whose Hymba never calls its
Pallas kernel: ``use_pallas`` is accepted and ignored.

The cache: a rolling window of keys and values ``k``, ``v`` (layers, B, W,
KV, D) in ``cfg.dtype``, the meta tokens' ``k_meta``, ``v_meta`` (layers, B,
meta, KV, D), the conv inputs ``conv`` (layers, B, ssm_conv - 1, d_in) in
``cfg.dtype``, the SSM state ``ssm`` (layers, B, d_in, ssm_state) f32, and
``pos`` (counting the meta tokens), as JAX's. ``decode_step`` shifts the
window and writes the states IN PLACE and returns the cache with pos + 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer_views
from repro_torch.models.xlstm import _causal_conv
from repro_torch.utils.tree import is_dtensor

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ModelConfig) -> int:
    return max(16, cfg.d_model // 16)


def _init_blocks(gen, cfg: ModelConfig, device) -> dict:
    lead = (cfg.num_layers,)
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    r = _dt_rank(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": L.init_rmsnorm(d, device, lead),
        "attn": L.init_attention(gen, cfg, device, lead),
        # mamba branch
        "w_xz": L.dense_init(gen, lead + (d, 2, d_in), d, device),
        "conv": L.dense_init(gen, lead + (cfg.ssm_conv, d_in), cfg.ssm_conv,
                             device),
        "w_bc": L.dense_init(gen, lead + (d_in, 2 * N), d_in, device),
        "w_dt_down": L.dense_init(gen, lead + (d_in, r), d_in, device),
        "w_dt_up": L.dense_init(gen, lead + (r, d_in), r, device),
        "b_dt": torch.log(torch.expm1(torch.full(lead + (d_in,), 0.01,
                                                 **f32))),  # softplus^-1
        "A_log": torch.log(torch.arange(1, N + 1, **f32)).expand(
            lead + (d_in, N)).contiguous(),
        "D": torch.ones(lead + (d_in,), **f32),
        "w_ssm_out": L.dense_init(gen, lead + (d_in, d), d_in, device),
        # branch fusion
        "attn_out_norm": L.init_rmsnorm(d, device, lead),
        "ssm_out_norm": L.init_rmsnorm(d, device, lead),
        "beta_attn": torch.ones(lead, **f32),
        "beta_ssm": torch.ones(lead, **f32),
        # ffn
        "mlp_norm": L.init_rmsnorm(d, device, lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, device, lead),
    }


def init(gen, cfg: ModelConfig, device) -> dict:
    """Random f32 params from ``gen`` (JAX init's keys, shapes and scales;
    the draws differ; ``b_dt``, ``A_log``, ``D`` and the betas are JAX's
    constants)."""
    return {
        "embed": L.init_embed(gen, cfg, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "blocks": _init_blocks(gen, cfg, device),
    }


# ---------------------------------------------------------------------------
# mamba branch
# ---------------------------------------------------------------------------


def _ssm_inputs(bp, cfg: ModelConfig, xn):
    """xn: (B, S, d) -> the SSM input x_in and the gate z, (B, S, d_in)."""
    xz = L._proj(xn, bp["w_xz"])
    return xz[..., 0, :], xz[..., 1, :]


def _softplus(x):
    """jax.nn.softplus, logaddexp(x, 0). (torch's softplus is log1p(exp x)
    up to 20 and x above; it agrees in f32, rounded another way.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_params(bp, u):
    """u: (B, S, d_in) post-conv. Returns dt, Bt, Ct (f32)."""
    N = bp["A_log"].shape[1]
    dt_ = u.dtype
    bc = (u @ bp["w_bc"].to(dt_)).to(torch.float32)
    Bt, Ct = bc[..., :N], bc[..., N:]
    # einsum bsf,fr,rg->bsg contracts u with w_dt_down first, as JAX's
    dt = ((u @ bp["w_dt_down"].to(dt_)) @ bp["w_dt_up"].to(dt_)).to(
        torch.float32)
    return _softplus(dt + bp["b_dt"]), Bt, Ct


def _associative_scan(a, b, need_a: bool = False):
    """h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0): ``lax.associative_
    scan`` of combine((a1, b1), (a2, b2)) = (a2 a1, a2 b1 + b2), by the
    same odd/even recursion and so in the same rounding order; a2 b1 + b2
    is one fused multiply-add (``addcmul``), as XLA fuses it. Returns (the
    prefix products of a, or None unless ``need_a``; h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, then scan the pairs
    a_odd, b_odd = _associative_scan(
        a[:, 1::2] * a[:, 0:-1:2],
        torch.addcmul(b[:, 1::2], a[:, 1::2], b[:, 0:-1:2]), need_a=True)
    if n % 2 == 0:
        a_odd_, b_odd_ = a_odd[:, :-1], b_odd[:, :-1]
    else:
        a_odd_, b_odd_ = a_odd, b_odd
    a2, b2 = a[:, 2::2], b[:, 2::2]
    b_even = torch.cat([b[:, :1], torch.addcmul(b2, a2, b_odd_)], dim=1)
    h = _interleave(b_even, b_odd)
    if not need_a:
        return None, h
    a_even = torch.cat([a[:, :1], a2 * a_odd_], dim=1)
    return _interleave(a_even, a_odd), h


def _interleave(even, odd):
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def mamba_seq(bp, cfg: ModelConfig, xn, conv_state=None, ssm_state=None):
    """xn: (B, S, d). Returns (y (B, S, d), (conv_state, ssm_state))."""
    S = xn.shape[1]
    x_in, z = _ssm_inputs(bp, cfg, xn)
    if conv_state is not None:  # decode-style continuation
        x_cat = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
        u = F.silu(_causal_conv(x_cat, bp["conv"]))[:, conv_state.shape[1]:]
    else:
        u = F.silu(_causal_conv(x_in, bp["conv"]))
    dt, Bt, Ct = _ssm_params(bp, u)
    A = -torch.exp(bp["A_log"])  # (d_in, N)
    u32 = u.to(torch.float32)
    dA = torch.exp(dt[..., None] * A)  # (B, S, d_in, N)
    dBu = dt[..., None] * Bt[:, :, None, :] * u32[..., None]
    if ssm_state is not None:  # fold the initial state into the first step
        dBu[:, 0] = torch.addcmul(dBu[:, 0], dA[:, 0], ssm_state)
    _, h = _associative_scan(dA, dBu)  # (B, S, d_in, N)
    del dA, dBu
    y = (h @ Ct[..., None])[..., 0] + bp["D"] * u32
    y = (y * F.silu(z.to(torch.float32))).to(xn.dtype)
    out = y @ bp["w_ssm_out"].to(xn.dtype)
    kc = cfg.ssm_conv - 1
    if S >= kc:
        new_conv_state = x_in[:, -kc:]
    else:
        new_conv_state = F.pad(x_in, (0, 0, kc - S, 0))
    return out, (new_conv_state, h[:, -1])


def mamba_step(bp, cfg: ModelConfig, xn, conv_state, ssm_state):
    """One-token decode. xn: (B, 1, d); conv_state (B, k-1, d_in)."""
    x_in, z = _ssm_inputs(bp, cfg, xn)  # (B, 1, d_in)
    x_cat = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    u = F.silu(torch.einsum("bkf,kf->bf", x_cat,
                            bp["conv"].to(x_in.dtype)))[:, None]
    dt, Bt, Ct = _ssm_params(bp, u)
    A = -torch.exp(bp["A_log"])
    u32 = u.to(torch.float32)
    dA = torch.exp(dt[:, 0, :, None] * A)  # (B, d_in, N)
    dBu = dt[:, 0, :, None] * Bt[:, 0, None, :] * u32[:, 0, :, None]
    h = torch.addcmul(dBu, dA, ssm_state)
    y = (h @ Ct[:, 0, :, None])[..., 0] + bp["D"] * u32[:, 0]
    y = (y * F.silu(z[:, 0].to(torch.float32))).to(xn.dtype)
    out = (y @ bp["w_ssm_out"].to(xn.dtype))[:, None]
    new_conv = torch.cat([conv_state[:, 1:], x_in.to(conv_state.dtype)],
                         dim=1)
    return out, (new_conv, h)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _fuse(x, a, s, bp, cfg: ModelConfig):
    """x + (beta_attn rmsnorm(a) + beta_ssm rmsnorm(s)) / 2. JAX sums in f32
    (its betas are f32 arrays, the normed branches x.dtype) and casts after;
    in torch a 0-d f32 tensor times a bf16 one stays bf16, so the branches
    are cast explicitly."""
    f32 = torch.float32
    fused = (bp["beta_attn"] * L.rmsnorm(a, bp["attn_out_norm"],
                                         cfg.norm_eps).to(f32)
             + bp["beta_ssm"] * L.rmsnorm(s, bp["ssm_out_norm"],
                                          cfg.norm_eps).to(f32)) * 0.5
    return x + fused.to(x.dtype)


def _block(x, bp, cfg: ModelConfig, positions):
    """One layer over a full sequence -> (out, k, v, (conv, ssm) states)."""
    xn = L.rmsnorm(x, bp["norm"], cfg.norm_eps)
    # attention branch (sliding window + globally visible meta prefix)
    q, k, v = L._qkv(xn, bp["attn"], cfg, positions)
    attn = (L.chunked_attention if x.shape[1] > L.ATTN_CHUNK_THRESHOLD
            else L.full_attention)
    a = attn(q, k, v, causal=True, sliding_window=cfg.sliding_window,
             prefix_global=cfg.meta_tokens)
    a = L.out_proj(a, bp["attn"], x.dtype)
    s, states = mamba_seq(bp, cfg, xn)
    h = _fuse(x, a, s, bp, cfg)
    y = L.swiglu(L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps), bp["mlp"])
    return h + y, k, v, states


def _block_fwd(x, bp, cfg: ModelConfig, positions):
    return _block(x, bp, cfg, positions)[0]


def _embed(params, cfg: ModelConfig, tokens):
    """Token embeddings behind the meta tokens."""
    x = L.embed_tokens(params["embed"], cfg, tokens)
    if cfg.meta_tokens:
        meta = params["embed"]["meta"].to(getattr(torch, cfg.dtype))
        x = torch.cat([meta.expand(tokens.shape[0], -1, -1), x], dim=1)
    return x


def forward(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """-> (logits (B, meta + S, V) f32, aux). On a mesh (DTensor tokens,
    the dry run) the model runs on this rank's batch slice
    (``layers.BatchPieces``)."""
    del use_pallas
    if is_dtensor(batch["tokens"]):
        return L.forward_on_batch_pieces(forward, params, cfg, batch)
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in _layer_views(params["blocks"], "blocks"):
        x = L.remat(_block_fwd, x, bp, cfg, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (L.lm_head(params["embed"], cfg, x),
            {"aux_loss": torch.zeros((), device=x.device)})


def loss_fn(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """Next-token loss; the meta tokens carry no labels."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.meta_tokens:
        labels = torch.cat([labels.new_full((labels.shape[0],
                                             cfg.meta_tokens), -1), labels],
                           dim=1)
    ce = L.cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce, {"ce": ce, "aux_loss": aux["aux_loss"]}


# ---------------------------------------------------------------------------
# serving: prefill, cache, decode
# ---------------------------------------------------------------------------


def _zero_cache(cfg: ModelConfig, batch: int, W: int, dtype, device) -> dict:
    dt = getattr(torch, dtype or cfg.dtype)
    Lyr = cfg.num_layers
    d_in = cfg.ssm_expand * cfg.d_model
    kv = (Lyr, batch, W, cfg.num_kv_heads, cfg.head_dim)
    meta_kv = (Lyr, batch, cfg.meta_tokens, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "k_meta": torch.zeros(meta_kv, dtype=dt, device=device),
        "v_meta": torch.zeros(meta_kv, dtype=dt, device=device),
        "conv": torch.zeros((Lyr, batch, cfg.ssm_conv - 1, d_in), dtype=dt,
                            device=device),
        "ssm": torch.zeros((Lyr, batch, d_in, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *,
            use_pallas: bool = False):
    """Prompt pass -> (last-position logits (B, V) f32, cache): the window
    KV (the last W = min(window or cache_len, cache_len) positions, meta
    tokens included, left-padded when shorter), the meta tokens' KV and
    the SSM states; pos counts the meta tokens."""
    del use_pallas
    x = _embed(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    W = min(cfg.sliding_window or cache_len, max(cache_len, 1))
    cache = _zero_cache(cfg, B, W, None, x.device)
    n = min(S, W)
    dst, src = slice(W - n, W), slice(S - n, S)
    meta = cfg.meta_tokens
    for i, bp in enumerate(_layer_views(params["blocks"], "blocks")):
        x, k, v, (conv_s, ssm_s) = _block(x, bp, cfg, positions)
        cache["k"][i, :, dst] = k[:, src]
        cache["v"][i, :, dst] = v[:, src]
        cache["k_meta"][i] = k[:, :meta]
        cache["v_meta"][i] = v[:, :meta]
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
        del k, v, conv_s, ssm_s
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    cache["pos"].fill_(S)
    return L.lm_head(params["embed"], cfg, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda") -> dict:
    """A zero cache: rolling-window KV + meta-token KV + O(1) mamba state
    per layer; O(window + meta) in size, not O(seq_len)."""
    W = min(cfg.sliding_window or seq_len, seq_len)
    return _zero_cache(cfg, batch, W, dtype, device)


def decode_step(params, cfg: ModelConfig, cache, tokens, *,
                use_pallas: bool = False):
    """tokens: (B,) -> (logits (B, V) f32, the cache updated in place with
    pos + 1). The window shifts left one slot a step; window slots whose
    position is below ``meta_tokens`` are masked (the meta tokens attend
    from ``k_meta``, ``v_meta``, which the prefill fills). On a mesh
    (DTensor tokens, the dry run) the step runs on this rank's batch slice
    (``layers.BatchPieces``)."""
    del use_pallas
    if is_dtensor(tokens):
        return L.decode_on_batch_pieces(decode_step, params, cfg, cache,
                                        tokens)
    pos = cache["pos"]  # absolute position of the new token
    W = cache["k"].shape[2]
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])
    win_pos = pos - W + 1 + torch.arange(W, device=x.device)
    valid = torch.cat([torch.ones(cfg.meta_tokens, dtype=torch.bool,
                                  device=x.device),
                       win_pos >= cfg.meta_tokens])
    for i, bp in enumerate(_layer_views(params["blocks"], "blocks")):
        kc, vc = cache["k"][i], cache["v"][i]
        xn = L.rmsnorm(x, bp["norm"], cfg.norm_eps)
        q, k_new, v_new = L._qkv(xn, bp["attn"], cfg, pos.view(1))
        kc.copy_(torch.cat([kc[:, 1:], k_new.to(kc.dtype)], dim=1))
        vc.copy_(torch.cat([vc[:, 1:], v_new.to(vc.dtype)], dim=1))
        kk = torch.cat([cache["k_meta"][i], kc], dim=1)
        vv = torch.cat([cache["v_meta"][i], vc], dim=1)
        a = L.out_proj(L.decode_attention(q, kk, vv, valid, cfg), bp["attn"],
                       x.dtype)
        m_out, (conv_s, ssm_s) = mamba_step(bp, cfg, xn, cache["conv"][i],
                                            cache["ssm"][i])
        cache["conv"][i].copy_(conv_s)
        cache["ssm"][i].copy_(ssm_s)
        h = _fuse(x, a, m_out, bp, cfg)
        x = h + L.swiglu(L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps),
                         bp["mlp"])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (L.lm_head(params["embed"], cfg, x)[:, 0],
            dict(cache, pos=pos + 1))
