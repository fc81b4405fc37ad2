"""xLSTM (arXiv:2405.04517): mLSTM (matrix-memory) and sLSTM
(scalar-memory) blocks with exponential gating, alternating in a
``slstm_every`` pattern (the JAX package's ``models/xlstm.py``, same keys,
shapes and op order).

Params: ``mlstm/*`` leaves carry two leading stack axes (G, M) and
``slstm/*`` one (G,): G = num_layers / slstm_every super-blocks of M =
slstm_every - 1 mLSTM blocks and one sLSTM block, as in JAX, so the packed
layout and weight carry-over match key for key.

Training runs the recurrences step by step over time (a Python loop where
JAX scans), or the chunkwise-parallel mLSTM when ``MLSTM_CHUNK`` divides the
sequence. The training forward recomputes each super-block in the backward
pass (``layers.remat``), as JAX's ``jax.checkpoint`` over its scan does.

The cache IS the recurrent state, O(1) in the context length:
``{"m": (C, n, m, conv), "s": (c, n, h, m), "pos"}`` with C (G, M, B, nh,
hd, hd), n (G, M, B, nh, hd), m (G, M, B, nh) and the f32 conv buffer
(G, M, B, ssm_conv - 1, d_in) of the mLSTM blocks, and c, n, h, m
(G, B, nh, hd) of the sLSTM blocks, all f32. ``decode_step`` writes the new
state into the cache's tensors IN PLACE and returns them with pos + 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer_views

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mlstm_block(gen, cfg: ModelConfig, device, lead) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = cfg.num_heads
    hd = d_in // nh
    return {
        "norm": L.init_rmsnorm(d, device, lead),
        "w_up": L.dense_init(gen, lead + (d, 2, d_in), d, device),
        "conv": L.dense_init(gen, lead + (cfg.ssm_conv, d_in), cfg.ssm_conv,
                             device),
        "wq": L.dense_init(gen, lead + (d_in, nh, hd), d_in, device),
        "wk": L.dense_init(gen, lead + (d_in, nh, hd), d_in, device),
        "wv": L.dense_init(gen, lead + (d_in, nh, hd), d_in, device),
        "w_i": L.dense_init(gen, lead + (d_in, nh), d_in, device),
        "b_i": torch.zeros(lead + (nh,), device=device),
        "w_f": L.dense_init(gen, lead + (d_in, nh), d_in, device),
        "b_f": torch.full(lead + (nh,), 3.0, device=device),  # forget bias
        "out_norm": L.init_rmsnorm(d_in, device, lead),
        "w_down": L.dense_init(gen, lead + (d_in, d), d_in, device),
    }


def slstm_up_width(d: int) -> int:
    """The sLSTM block's projection width: 4/3 of d rounded up to 128."""
    return -(-(d * 4 // 3) // 128) * 128


def _init_slstm_block(gen, cfg: ModelConfig, device, lead) -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    ff = slstm_up_width(d)
    p = {"norm": L.init_rmsnorm(d, device, lead),
         "out_norm": L.init_rmsnorm(d, device, lead)}
    for g in ("i", "f", "z", "o"):
        p[f"w_{g}"] = L.dense_init(gen, lead + (d, nh, hd), d, device)
        p[f"r_{g}"] = L.dense_init(gen, lead + (nh, hd, hd), hd, device)
        p[f"b_{g}"] = torch.full(lead + (nh, hd), 3.0 if g == "f" else 0.0,
                                 device=device)
    p["w_up"] = L.dense_init(gen, lead + (d, 2, ff), d, device)
    p["w_down"] = L.dense_init(gen, lead + (ff, d), ff, device)
    return p


def init(gen, cfg: ModelConfig, device) -> dict:
    """Random f32 params from ``gen`` (JAX init's keys, shapes and scales;
    the draws differ)."""
    assert cfg.slstm_every >= 2 and cfg.num_layers % cfg.slstm_every == 0
    G = cfg.num_layers // cfg.slstm_every  # super-blocks
    M = cfg.slstm_every - 1  # mLSTM blocks per super-block
    return {
        "embed": L.init_embed(gen, cfg, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "mlstm": _init_mlstm_block(gen, cfg, device, (G, M)),
        "slstm": _init_slstm_block(gen, cfg, device, (G,)),
    }


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _causal_conv(x, w):
    """x: (B, S, d_in); w: (k, d_in) depthwise causal conv, summed tap by
    tap in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return out


# Chunk length for the chunkwise-parallel mLSTM training form; 0 keeps the
# step-recurrent form (JAX's default, and its switch)
MLSTM_CHUNK = 0


def set_mlstm_chunk(n: int) -> None:
    global MLSTM_CHUNK
    MLSTM_CHUNK = n


def _key_scale(hd: int, dtype, device):
    """sqrt(hd) in f32, cast to the compute dtype before the keys are
    divided by it (in bf16, 22.627 becomes 22.625), as a 0-d tensor on the
    device (a fill, no host sync)."""
    root = float(torch.sqrt(torch.tensor(float(hd))))
    return torch.full((), root, dtype=dtype, device=device)


def _mlstm_inputs(bp, cfg: ModelConfig, x, state):
    """Shared projections for both mLSTM integrators."""
    d_in = cfg.ssm_expand * x.shape[-1]
    hd = d_in // cfg.num_heads
    dt = x.dtype
    C0, n0, m0, conv_buf = state

    xn = L.rmsnorm(x, bp["norm"], cfg.norm_eps)
    up = L._proj(xn, bp["w_up"])
    xu, z = up[..., 0, :], up[..., 1, :]
    # the causal conv's receptive field is carried across calls (decode
    # needs the last ssm_conv-1 inputs; zeros at t=0 match the zero pad)
    kc = cfg.ssm_conv - 1
    conv_in = torch.cat([conv_buf.to(xu.dtype), xu], dim=1)
    xc = F.silu(_causal_conv(conv_in, bp["conv"]))[:, kc:]
    new_conv_buf = conv_in[:, -kc:].to(torch.float32)
    q = L._proj(xc, bp["wq"])
    k = L._proj(xc, bp["wk"]) / _key_scale(hd, dt, x.device)
    v = L._proj(xu, bp["wv"])
    i_pre = (xc @ bp["w_i"].to(dt)).to(torch.float32) + bp["b_i"]
    f_pre = (xc @ bp["w_f"].to(dt)).to(torch.float32) + bp["b_f"]
    return q, k, v, i_pre, f_pre, z, new_conv_buf, (C0, n0, m0)


def _mlstm_out(bp, cfg: ModelConfig, x, h, z):
    h = L.rmsnorm(h, bp["out_norm"], cfg.norm_eps) * F.silu(z)
    return x + h @ bp["w_down"].to(x.dtype)


def mlstm_chunked(bp, cfg: ModelConfig, x, state=None, chunk: int = 64):
    """Chunkwise-parallel mLSTM (math identical to the recurrence).

    Within a chunk of length T, with b_t = cumsum(f_pre) and stabiliser
    m_t = max(b_t + m0, max_{s<=t}(b_t - b_s + i_s)):
        h_t = [ sum_{s<=t} e^{b_t-b_s+i_s-m_t} (q_t.k_s) v_s
                + e^{b_t+m0-m_t} C0 q_t ] / max(|q_t . n_t|, 1)
    and the chunk-final (C, n, m) feeds the next chunk.
    """
    B, S, d = x.shape
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    q, k, v, i_pre, f_pre, z, new_conv_buf, (C, n, m) = _mlstm_inputs(
        bp, cfg, x, state)
    nh = cfg.num_heads
    d_in = cfg.ssm_expand * d
    assert S % chunk == 0, (S, chunk)
    NC, T = S // chunk, chunk

    def resh(a):  # (B, S, nh, hd) -> (NC, B, nh, T, hd) f32
        return (a.to(torch.float32).reshape(B, NC, T, nh, -1)
                .permute(1, 0, 3, 2, 4))

    def gates(g):  # (B, S, nh) -> (NC, B, nh, T)
        return g.reshape(B, NC, T, nh).permute(1, 0, 3, 2)

    qs, ks, vs, iis, ffs = resh(q), resh(k), resh(v), gates(i_pre), \
        gates(f_pre)
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    hs = []
    for c in range(NC):
        qc, kc_, vc, ic, fc = qs[c], ks[c], vs[c], iis[c], ffs[c]
        b = torch.cumsum(fc, dim=-1)  # (B, nh, T)
        # running stabiliser: m_t = max(b_t + m0, b_t + cummax(i_s - b_s))
        running = torch.cummax(ic - b, dim=-1).values
        m_t = torch.maximum(b + m[..., None], b + running)
        inter = torch.exp(b + m[..., None] - m_t)
        # decay matrix D_ts = exp(b_t - b_s + i_s - m_t), s <= t
        logD = (b[..., :, None] - b[..., None, :] + ic[..., None, :]
                - m_t[..., :, None])
        D = torch.where(tril, torch.exp(logD), torch.zeros((), device=x.device))
        scores = (qc @ kc_.transpose(-1, -2)) * D
        num = scores @ vc
        num = num + inter[..., None] * (qc @ C.transpose(-1, -2))
        n_t = D @ kc_ + inter[..., None] * n[..., None, :]
        den = torch.clamp(torch.abs((qc * n_t).sum(-1)), min=1.0)
        hs.append(num / den[..., None])  # (B, nh, T, hd)
        # chunk-final state (t = T-1 weights, same stabiliser convention)
        m_end = m_t[..., -1]
        w_s = torch.exp(b[..., -1:] - b + ic - m_end[..., None])
        decay = torch.exp(b[..., -1] + m - m_end)
        C = decay[..., None, None] * C \
            + (vc * w_s[..., None]).transpose(-1, -2) @ kc_
        n = decay[..., None] * n + (w_s[..., None, :] @ kc_)[..., 0, :]
        m = m_end
    h = (torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, d_in)
         .to(x.dtype))
    return _mlstm_out(bp, cfg, x, h, z), (C, n, m, new_conv_buf)


def mlstm_seq(bp, cfg: ModelConfig, x, state=None):
    """x: (B, S, d). Returns (out (B, S, d), final state)."""
    B, S, d = x.shape
    if MLSTM_CHUNK and S % MLSTM_CHUNK == 0 and S > 1:
        return mlstm_chunked(bp, cfg, x, state, chunk=MLSTM_CHUNK)
    d_in = cfg.ssm_expand * d
    dt = x.dtype
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    q, k, v, i_pre, f_pre, z, new_conv_buf, (C, n, m) = _mlstm_inputs(
        bp, cfg, x, state)
    f32 = torch.float32
    hs = []
    for t in range(S):
        it, ft = i_pre[:, t], f_pre[:, t]  # (B, nh)
        qt, kt, vt = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)[..., None]
        f_g = torch.exp(ft + m - m_new)[..., None]
        C = f_g[..., None] * C + i_g[..., None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_g * n + i_g * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.clamp(torch.abs((n * qt).sum(-1))[..., None], min=1.0)
        hs.append((num / den).to(dt))
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, d_in)
    return _mlstm_out(bp, cfg, x, h, z), (C, n, m, new_conv_buf)


def mlstm_init_state(cfg: ModelConfig, B: int, device="cuda"):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    hd = d_in // nh
    return (
        torch.zeros((B, nh, hd, hd), device=device),
        torch.zeros((B, nh, hd), device=device),
        torch.full((B, nh), -1e30, device=device),
        torch.zeros((B, cfg.ssm_conv - 1, d_in), device=device),  # conv
    )


def slstm_seq(bp, cfg: ModelConfig, x, state=None):
    B, S, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    dt = x.dtype
    xn = L.rmsnorm(x, bp["norm"], cfg.norm_eps)
    pre = [L._proj(xn, bp[f"w_{g}"]).to(torch.float32) + bp[f"b_{g}"]
           for g in ("i", "f", "z", "o")]
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    c, n, h, m = state
    # the four recurrent products in one (nh, hd, 4 hd) matmul a step
    r = torch.cat([bp[f"r_{g}"] for g in ("i", "f", "z", "o")], dim=-1)
    hs = []
    for t in range(S):
        rec = (h.transpose(0, 1) @ r).transpose(0, 1).split(hd, dim=-1)
        ip, fp, zp, op = (p[:, t] + rg for p, rg in zip(pre, rec))
        m_new = torch.maximum(fp + m, ip)
        i_g = torch.exp(ip - m_new)
        f_g = torch.exp(fp + m - m_new)
        c = f_g * c + i_g * torch.tanh(zp)
        n = f_g * n + i_g
        h = torch.sigmoid(op) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).reshape(B, S, d).to(dt)
    hseq = L.rmsnorm(hseq, bp["out_norm"], cfg.norm_eps)
    x = x + hseq
    up = L._proj(hseq, bp["w_up"])
    # jax.nn.gelu's default is the tanh approximation
    y = F.gelu(up[..., 0, :], approximate="tanh") * up[..., 1, :]
    return x + y @ bp["w_down"].to(dt), (c, n, h, m)


def slstm_init_state(cfg: ModelConfig, B: int, device="cuda"):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    z = torch.zeros((B, nh, hd), device=device)
    return (z, z, z, torch.full((B, nh, hd), -1e30, device=device))


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _group(mps, sp, cfg: ModelConfig, x, ms, ss):
    """One super-block: M mLSTM blocks, then the sLSTM block."""
    new_ms = []
    for bp, st in zip(mps, ms):
        x, st = mlstm_seq(bp, cfg, x, st)
        new_ms.append(st)
    x, ss = slstm_seq(sp, cfg, x, ss)
    return x, new_ms, ss


def _group_out(mps, sp, cfg: ModelConfig, x):
    return _group(mps, sp, cfg, x, [None] * len(mps), None)[0]


def _scan_groups(params, cfg: ModelConfig, x, states=None):
    """Runs the super-blocks in order. Without ``states`` each block starts
    from the zero state and the output alone is kept, each super-block
    recomputed in the backward pass (``layers.remat``); with ``states`` (the
    cache's (m, s) tuples) returns (x, [per super-block: ([per mLSTM block:
    state], sLSTM state)])."""
    mviews = [_layer_views(g) for g in _layer_views(params["mlstm"])]
    sviews = _layer_views(params["slstm"])
    if states is None:
        for mps, sp in zip(mviews, sviews):
            x = L.remat(_group_out, mps, sp, cfg, x)
        return x, None
    m_state, s_state = states
    out = []
    for g, (mps, sp) in enumerate(zip(mviews, sviews)):
        ms = [tuple(a[g, j] for a in m_state) for j in range(len(mps))]
        x, ms, ss = _group(mps, sp, cfg, x, ms,
                           tuple(a[g] for a in s_state))
        out.append((ms, ss))
    return x, out


def forward(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    """-> (logits (B, S, V) f32, aux). ``use_pallas`` is accepted and
    ignored, as in JAX (the family has no kernel)."""
    del use_pallas
    x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
    x, _ = _scan_groups(params, cfg, x)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (L.lm_head(params["embed"], cfg, x),
            {"aux_loss": torch.zeros((), device=x.device)})


def loss_fn(params, cfg: ModelConfig, batch, *, use_pallas: bool = False):
    logits, aux = forward(params, cfg, batch)
    ce = L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return ce, {"ce": ce, "aux_loss": aux["aux_loss"]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda") -> dict:
    """The zero recurrent state: O(1) in seq_len (``dtype`` is unused: the
    state is f32, as JAX's)."""
    G = cfg.num_layers // cfg.slstm_every
    M = cfg.slstm_every - 1
    # a copy each: decode writes them in place, and slstm_init_state's c,
    # n and h are one tensor
    m_state = tuple(a.expand((G, M) + a.shape).clone()
                    for a in mlstm_init_state(cfg, batch, device))
    s_state = tuple(a.expand((G,) + a.shape).clone()
                    for a in slstm_init_state(cfg, batch, device))
    return {"m": m_state, "s": s_state,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _head_last(params, cfg: ModelConfig, x):
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.lm_head(params["embed"], cfg, x)[:, 0]


def prefill(params, cfg: ModelConfig, batch, cache_len: int = 0, *,
            use_pallas: bool = False):
    """Process a prompt -> (last-position logits (B, V) f32, cache): the
    recurrent states are the cache, whatever ``cache_len``."""
    del use_pallas
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], cfg, tokens)
    cache = init_cache(cfg, tokens.shape[0], cache_len, device=x.device)
    x, out = _scan_groups(params, cfg, x, (cache["m"], cache["s"]))
    _store(cache, out)
    cache["pos"].fill_(tokens.shape[1])
    return _head_last(params, cfg, x), cache


def _store(cache, out) -> None:
    """Writes the per-block states of ``_scan_groups`` into the cache."""
    for g, (ms, ss) in enumerate(out):
        for j, st in enumerate(ms):
            for dst, src in zip(cache["m"], st):
                dst[g, j].copy_(src)
        for dst, src in zip(cache["s"], ss):
            dst[g].copy_(src)


def decode_step(params, cfg: ModelConfig, cache, tokens, *,
                use_pallas: bool = False):
    """One token: tokens (B,) -> (logits (B, V) f32, the cache with its
    states updated in place and pos + 1). S = 1 takes the recurrent
    mLSTM (the chunked form needs S > 1)."""
    del use_pallas
    x = L.embed_tokens(params["embed"], cfg, tokens[:, None])
    x, out = _scan_groups(params, cfg, x, (cache["m"], cache["s"]))
    _store(cache, out)
    return _head_last(params, cfg, x), dict(cache, pos=cache["pos"] + 1)
