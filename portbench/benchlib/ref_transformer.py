"""The plain reference of the dense and MoE decoder: its training loss in
float32, TF32 off, with no kernel, cache or batching of the program.

A frozen copy of the mathematics of ``src/repro_torch/models/
{layers,moe,transformer}.py`` at commit a2698f40 (the training forward:
pre-norm blocks, GQA with RoPE and optional qk-norm, SwiGLU, the
capacity-bounded top-k MoE with shared experts and its load-balance loss,
tied or separate head, next-token cross-entropy), written out in plain
ops on the parameter tree of ``inputs.param_layout``. Where the program
casts weights and activations to bfloat16, this keeps float32 throughout.
Each block is recomputed in the backward pass (``torch.utils.checkpoint``),
so the full-width model fits beside the meta state.

Imports only torch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, D) rotated at positions 0..S-1 (halves, not pairs)."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, p, cfg):
    B, S, d = x.shape
    nq, nkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = (x @ p["wq"].reshape(d, nq * hd)).view(B, S, nq, hd)
    k = (x @ p["wk"].reshape(d, nkv * hd)).view(B, S, nkv, hd)
    v = (x @ p["wv"].reshape(d, nkv * hd)).view(B, S, nkv, hd)
    if cfg.get("qkv_bias"):
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.get("qk_norm"):
        q = rmsnorm(q, p["q_norm"], cfg["norm_eps"])
        k = rmsnorm(k, p["k_norm"], cfg["norm_eps"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    return o.reshape(B, S, nq * hd) @ p["wo"].reshape(nq * hd, d)


def swiglu(x, wi, wo):
    return (F.silu(x @ wi[:, 0, :]) * (x @ wi[:, 1, :])) @ wo


def capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg["moe_top_k"] * cfg["capacity_factor"]
            / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(x, p, cfg):
    """Top-k routing over all experts with a per-expert capacity: a
    token's j-th choice keeps its slot when fewer than C earlier slots (in
    token-major, choice-minor order) chose the same expert. Returns
    (output, load-balance loss)."""
    B, S, d = x.shape
    E, k = cfg["num_experts"], cfg["moe_top_k"]
    T = B * S
    xt = x.reshape(T, d)
    probs = (xt @ p["router"]).softmax(-1)
    idx = probs.sort(dim=-1, descending=True, stable=True).indices[:, :k]
    gates = probs.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    expert = idx.reshape(-1)
    onehot = F.one_hot(expert, E)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = pos < capacity(T, cfg)
    load = onehot.sum(0).float() / (T * k)
    aux = E * (probs.mean(0) * load).sum() * cfg["moe_aux_coef"]
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    gate = gates.reshape(-1)
    # the kept slots grouped by expert, with one read of the counts
    kept = keep.nonzero()[:, 0]
    kept = kept[expert[kept].argsort(stable=True)]
    counts = torch.bincount(expert[kept], minlength=E).tolist()
    out = torch.zeros_like(xt)
    for e, sel in enumerate(kept.split(counts)):
        if sel.numel():
            t = token[sel]
            y = swiglu(xt[t], p["w_in"][e], p["w_out"][e]) * gate[sel, None]
            out = out.index_add(0, t, y)
    if cfg.get("num_shared_experts"):
        out = out + swiglu(xt, p["shared"]["wi"], p["shared"]["wo"])
    return out.view(B, S, d), aux


def block(x, bp, cfg, is_moe):
    eps = cfg["norm_eps"]
    h = x + attention(rmsnorm(x, bp["attn_norm"]["scale"], eps), bp["attn"],
                      cfg)
    hn = rmsnorm(h, bp["mlp_norm"]["scale"], eps)
    if is_moe:
        y, aux = moe(hn, bp["moe"], cfg)
        return h + y, aux
    return h + swiglu(hn, bp["mlp"]["wi"], bp["mlp"]["wo"]), \
        torch.zeros((), device=x.device)


def layer_params(stack: dict) -> list[dict]:
    """The per-layer dicts of a stack of layers (views)."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    per = split(stack)
    n = len(next(iter(leaves(per))))
    return [pick(per, i) for i in range(n)]


def leaves(node):
    """The tensors of a nested dict, in its order."""
    if isinstance(node, dict):
        for v in node.values():
            yield from leaves(v)
    else:
        yield node


def loss(params, cfg, tokens, labels):
    """Mean next-token cross-entropy of (B, S) ``tokens`` plus the MoE
    load-balance losses."""
    x = params["embed"]["embedding"][tokens]
    layers = []
    if "dense_blocks" in params:
        layers += [(bp, False) for bp in layer_params(params["dense_blocks"])]
    is_moe = bool(cfg.get("num_experts"))
    layers += [(bp, is_moe) for bp in layer_params(params["blocks"])]
    aux_total = torch.zeros((), device=x.device)
    for bp, m in layers:
        x, aux = checkpoint(block, x, bp, cfg, m, use_reentrant=False)
        aux_total = aux_total + aux
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    head = (params["embed"]["embedding"].T if cfg.get("tie_embeddings")
            else params["embed"]["head"])
    logits = x[:, :-1] @ head
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels[:, 1:].reshape(-1))
    return ce + aux_total
