"""Neural-net building blocks of the transformer, as plain functions
over nested dicts of tensors (the JAX package's ``models/layers.py``, same
keys, shapes and op order).

* Params are stored in float32 (the packed master plane); the forward
  casts weights to ``cfg.dtype`` (bf16 by default) where the JAX code
  does, keeps norm scales in f32, and returns float32 logits.
* Attention projections are 3-D ``(d_model, heads, head_dim)`` as in JAX.
* Attention over a full sequence takes the flash kernel when the caller
  sets ``use_pallas`` (``kernels/ops.py::flash_attention``), blockwise
  ``chunked_attention`` above ``ATTN_CHUNK_THRESHOLD`` tokens, and the
  plain ``full_attention`` otherwise; ``attention_decode`` is the
  one-token step against a KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import is_dtensor

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def normal(shape, std: float, gen, device) -> torch.Tensor:
    """N(0, std^2) f32 draws from ``gen``, scaled in place (one copy of the
    leaf: DeepSeekMoE's stacked ``w_in`` is 39.86 GB); shapes only on the
    meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=device).mul_(std)


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
    if cfg.meta_tokens:
        p["meta"] = normal((cfg.meta_tokens, cfg.d_model), 0.02, gen, device)
    if cfg.input_mode == "tokens+patches":
        # the projector stub is identity-shaped; a learnable patch
        # positional bias
        p["patch_pos"] = torch.zeros((cfg.num_patches, cfg.d_model),
                                     device=device)
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
    if is_dtensor(wi):
        # a DTensor with f split (the dry run): two column-parallel
        # products; merging (2, f) would gather the weight
        gate, up = x @ wi[:, 0, :], x @ wi[:, 1, :]
    else:
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
    """Each of the (B, S, KV, D) heads repeated ``n_rep`` times in place
    (``repeat_interleave`` on dim 2). A DTensor (the dry run) is expanded
    piece by piece: a split of any dim, the heads' included, stays the
    same split of the result (head h of the result is KV head h // n_rep),
    where DTensor's own view rules lose or refuse it."""
    if n_rep == 1:
        return k
    if is_dtensor(k):
        from torch.distributed.tensor import DTensor

        B, S, KV, D = k.shape
        out = _expand_kv(k.to_local(), n_rep)
        return DTensor.from_local(out, k.device_mesh, k.placements,
                                  run_check=False,
                                  shape=(B, S, KV * n_rep, D),
                                  stride=(S * KV * n_rep * D,
                                          KV * n_rep * D, D, 1))
    return torch.repeat_interleave(k, n_rep, dim=2)


def full_attention(q, k, v, *, causal, sliding_window=0, q_offset=0,
                   prefix_global=0):
    """Reference attention (materialises the score matrix)."""
    if is_dtensor(q):
        out = _on_local_pieces(
            full_attention, q, k, v, causal=causal,
            sliding_window=sliding_window, q_offset=q_offset,
            prefix_global=prefix_global)
        if out is not None:
            return out
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


def chunked_attention(q, k, v, *, causal, sliding_window=0, q_chunk=512,
                      kv_chunk=1024, prefix_global=0):
    """Blockwise online-softmax attention in plain ops (JAX's XLA path for
    long sequences): the score matrix is formed one (q_chunk, kv_chunk)
    block at a time. Chunks are the largest divisors of S up to the given
    sizes, as in JAX; the running max starts at -inf and p is cast to q's
    dtype before the PV product, as there."""
    if is_dtensor(q):
        out = _on_local_pieces(
            chunked_attention, q, k, v, causal=causal,
            sliding_window=sliding_window, q_chunk=q_chunk,
            kv_chunk=kv_chunk, prefix_global=prefix_global)
        if out is not None:
            return out
    B, S, nq, hd = q.shape
    n_rep = nq // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q_chunk = math.gcd(min(q_chunk, S), S)
    kv_chunk = math.gcd(min(kv_chunk, S), S)
    outs = []
    for q0 in range(0, S, q_chunk):
        q_i = q[:, q0:q0 + q_chunk]
        acc = torch.zeros((B, q_chunk, nq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, nq, q_chunk), -math.inf, device=q.device)
        l = torch.zeros((B, nq, q_chunk), device=q.device)
        qpos = q0 + torch.arange(q_chunk, device=q.device)
        for k0 in range(0, S, kv_chunk):
            k_j = _expand_kv(k[:, k0:k0 + kv_chunk], n_rep)
            v_j = _expand_kv(v[:, k0:k0 + kv_chunk], n_rep)
            s = torch.einsum("bqhk,bshk->bhqs", q_i, k_j).to(torch.float32)
            s = s * scale
            kpos = k0 + torch.arange(kv_chunk, device=q.device)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if sliding_window:
                win = qpos[:, None] - kpos[None, :] < sliding_window
                if prefix_global:
                    win |= kpos[None, :] < prefix_global
                mask &= win
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhqs,bshk->bqhk", p.to(q.dtype), v_j)
            acc = acc * alpha.transpose(1, 2)[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def _on_local_pieces(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for (B, S, H, D) DTensors (the dry run of a
    mesh) split alike along the batch and head dims only: attention is
    independent per sequence and head, so each rank runs ``fn`` on its
    pieces with plain ops and the result keeps q's placements. At 32k
    tokens the blockwise loop is ~2,048 blocks a layer, each op of which
    DTensor would dispatch, and torch 2.11's DTensor refuses the score
    product's views of split heads. None where the pieces do not line up
    (then DTensor runs ``fn``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl, mesh = tuple(q.placements), q.device_mesh
    if not all(is_dtensor(t) and tuple(t.placements) == pl
               and t.device_mesh == mesh for t in (k, v)):
        return None
    # a rank's query heads must be the ones its key heads serve: the heads
    # split evenly, or not at all
    if not all(isinstance(p, Replicate) or isinstance(p, Shard) and (
            p.dim == 0 or p.dim == 2 and q.shape[2] % mesh.size(i) == 0
            and k.shape[2] % mesh.size(i) == 0) for i, p in enumerate(pl)):
        return None
    # the result's layout as declared below (the plain path's out_proj
    # copies a permuted result as well)
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw).contiguous()
    B, S, H, D = q.shape
    return DTensor.from_local(out, q.device_mesh, pl, run_check=False,
                              shape=(B, S, H, D),
                              stride=(S * H * D, H * D, D, 1))


# Sequences above this length take the blockwise ``chunked_attention``, as
# in the JAX package (which also reads an environment override, kept there
# to reproduce a TPU measurement; the port keeps the constant)
ATTN_CHUNK_THRESHOLD = 8192


def out_proj(out, p, dtype):
    nq, hd, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].to(dtype).reshape(nq * hd, d)


def attention_block_kv(x, p, cfg: ModelConfig, positions, use_pallas=False):
    """Self-attention over a full sequence; also returns (k, v) for the
    prefill's cache. ``use_pallas`` takes the flash kernel (no gradient)."""
    q, k, v = _qkv(x, p, cfg, positions)
    if use_pallas:
        out = kops.flash_attention(q, k, v, causal=cfg.causal,
                                   sliding_window=cfg.sliding_window)
    elif x.shape[1] > ATTN_CHUNK_THRESHOLD:
        out = chunked_attention(q, k, v, causal=cfg.causal,
                                sliding_window=cfg.sliding_window)
    else:
        out = full_attention(q, k, v, causal=cfg.causal,
                             sliding_window=cfg.sliding_window)
    return out_proj(out, p, x.dtype), k, v


def attention_block(x, p, cfg: ModelConfig, positions, use_pallas=False):
    """Self-attention over a full sequence (train / prefill)."""
    return attention_block_kv(x, p, cfg, positions, use_pallas)[0]


def decode_attention(q, kc, vc, valid, cfg: ModelConfig):
    """One query position against a cache (B, S, KV, D) under the (S,)
    mask ``valid``: f32 softmax, p cast to q's dtype (JAX's op order)."""
    if is_dtensor(kc):
        return _decode_attention_placed(q, kc, vc, valid, cfg)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    kk = _expand_kv(kc.to(q.dtype), n_rep)
    vv = _expand_kv(vc.to(q.dtype), n_rep)
    s = torch.einsum("bqhk,bshk->bhqs", q, kk).to(torch.float32)
    s = s / math.sqrt(cfg.head_dim)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, -1e30))
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", prob, vv)


def _decode_attention_placed(q, kc, vc, valid, cfg: ModelConfig):
    """``decode_attention`` on one rank of a mesh (the dry run), the cache
    a DTensor split along its batch and sequence dims: the query is laid
    out like the cache's batch split with every head whole, each rank
    scores its slice of the sequence, and the softmax is completed across
    the sequence split by three all-reduces (the max, the sum, the
    weighted values in f32), as a partitioned softmax is."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = kc.device_mesh
    pl = tuple(kc.placements)
    if any(not (isinstance(p, Replicate) or isinstance(p, Shard)
                and p.dim in (0, 1)) for p in pl):
        raise NotImplementedError(f"a cache placed {pl}: split it along "
                                  "its batch and sequence dims only")
    seq_groups = [mesh.get_group(i) for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == 1]
    like = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    ql = q.redistribute(mesh, like).to_local()
    shape, offset = compute_local_shape_and_global_offset(kc.shape, mesh, pl)
    lo, n = offset[1], shape[1]
    if is_dtensor(valid):
        valid = valid.full_tensor()
    valid = valid[lo:lo + n]

    def all_reduce(x, op):
        for g in seq_groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
        return x

    n_rep = cfg.num_heads // cfg.num_kv_heads
    kk = _expand_kv(kc.to_local().to(ql.dtype), n_rep)
    vv = _expand_kv(vc.to_local().to(ql.dtype), n_rep)
    s = torch.einsum("bqhk,bshk->bhqs", ql, kk).to(torch.float32)
    s = s / math.sqrt(cfg.head_dim)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, -1e30))
    m = all_reduce(s.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(s - m)
    total = all_reduce(e.sum(dim=-1, keepdim=True), "sum")
    prob = (e / total).to(ql.dtype)
    out = all_reduce(torch.einsum("bhqs,bshk->bqhk", prob, vv).to(
        torch.float32), "sum").to(ql.dtype)
    B, Q, H, D = q.shape
    return DTensor.from_local(out, mesh, like, run_check=False,
                              shape=(B, Q, H, D),
                              stride=(Q * H * D, H * D, D, 1))


def _map_dtensors(tree, fn):
    """``fn`` on every DTensor of a dict / list / tuple tree, the tree
    rebuilt around it; other leaves kept."""
    if is_dtensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_dtensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_dtensors(v, fn) for v in tree)
    return tree


class BatchPieces:
    """One rank's serving program of a family that splits nothing over
    'model' (Hymba, xLSTM; the dry run of a mesh): every DTensor argument
    is laid out with the tokens' batch split kept and every other dim
    whole (the weights and states gathered over 'model'), the model runs
    on this rank's batch slice in plain ops, and its results are placed
    back. Their recurrences, SSM scans and 25 attention heads then go
    through no DTensor view rule, which differ between torch versions."""

    def __init__(self, tokens):
        self.mesh = tokens.device_mesh
        self.batch = tokens.shape[0]
        self.dims = {i for i, p in enumerate(tokens.placements)
                     if p.is_shard(0)}

    def layout(self, t):
        from torch.distributed.tensor import Replicate

        return [p if i in self.dims else Replicate()
                for i, p in enumerate(t.placements)]

    def local(self, tree):
        return _map_dtensors(tree, lambda t: t.redistribute(
            self.mesh, self.layout(t)).to_local())

    def placed(self, out):
        """A (B, ...) result of this rank's slice as a DTensor split along
        the batch as the tokens are."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        shape = (self.batch,) + tuple(out.shape[1:])
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(
            out, self.mesh, [Shard(0) if i in self.dims else Replicate()
                             for i in range(self.mesh.ndim)],
            run_check=False, shape=shape, stride=tuple(stride))

    def write_back(self, placed, local) -> None:
        """Each DTensor of ``placed`` takes its piece of the same leaf of
        ``local`` (this rank's batch slice, other dims whole), in place."""
        from torch.distributed.tensor import DTensor

        if is_dtensor(placed):
            whole = DTensor.from_local(local, self.mesh, self.layout(placed),
                                       run_check=False, shape=placed.shape,
                                       stride=placed.stride())
            placed.to_local().copy_(whole.redistribute(
                self.mesh, placed.placements).to_local())
        elif isinstance(placed, dict):
            for k in placed:
                self.write_back(placed[k], local[k])
        elif isinstance(placed, (list, tuple)):
            for p, q in zip(placed, local):
                self.write_back(p, q)


def forward_on_batch_pieces(forward, params, cfg: ModelConfig, batch):
    """``forward(params, cfg, batch)`` of a ``BatchPieces`` family on a
    mesh: (logits placed along the batch, aux)."""
    pieces = BatchPieces(batch["tokens"])
    logits, aux = forward(pieces.local(params), cfg, pieces.local(batch))
    return pieces.placed(logits), aux


def decode_on_batch_pieces(decode_step, params, cfg: ModelConfig, cache,
                           tokens):
    """``decode_step`` of a ``BatchPieces`` family on a mesh: the placed
    cache updated in place, piece by piece (logits placed along the batch,
    the cache with pos + 1)."""
    pieces = BatchPieces(tokens)
    local_cache = pieces.local(cache)
    logits, _ = decode_step(pieces.local(params), cfg, local_cache,
                            pieces.local(tokens))
    pieces.write_back({k: v for k, v in cache.items() if k != "pos"},
                      {k: v for k, v in local_cache.items() if k != "pos"})
    return pieces.placed(logits), dict(cache, pos=cache["pos"] + 1)


def index_copy_(cache, dim: int, idx, src):
    """``cache.index_copy_(dim, idx, src)``. A DTensor cache (the dry run
    of a mesh) whose ``dim`` is split over a mesh axis is written rank by
    rank: the rank holding row ``idx`` writes it and the others rewrite
    their clamped row as it was (a masked write, no host read), ``src``
    first laid out like the cache with ``dim`` whole. DTensor has no
    general rule for an indexed in-place write along a split dim."""
    if not is_dtensor(cache):
        return cache.index_copy_(dim, idx, src)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = cache.device_mesh
    whole = [Replicate() if isinstance(q, Shard) and q.dim == dim else q
             for q in cache.placements]
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if is_dtensor(idx):
        idx = idx.full_tensor()
    src = src.redistribute(mesh, whole).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    lo, n = offset[dim], shape[dim]
    local = cache.to_local()
    j = (idx - lo).clamp(0, n - 1)
    mine = ((idx >= lo) & (idx < lo + n)).view(
        [-1 if d == dim else 1 for d in range(local.dim())])
    local.index_copy_(dim, j, torch.where(mine, src,
                                          local.index_select(dim, j)))
    return cache


def attention_decode(x, p, cfg: ModelConfig, k_cache, v_cache, pos):
    """One-token decode against a full-length KV cache, updated IN PLACE.

    x: (B, 1, d); k_cache, v_cache: (B, S, KV, D); pos: 0-d int tensor on
    the device (the new token's index; read on the device, no host sync).
    Returns (out (B, 1, d), k_cache, v_cache).
    """
    q, k_new, v_new = _qkv(x, p, cfg, pos.view(1))
    idx = pos.view(1).long()
    index_copy_(k_cache, 1, idx, k_new.to(k_cache.dtype))
    index_copy_(v_cache, 1, idx, v_new.to(v_cache.dtype))
    kpos = torch.arange(k_cache.shape[1], device=x.device)
    valid = kpos <= pos
    if cfg.sliding_window:
        valid &= kpos > pos - cfg.sliding_window
    out = decode_attention(q, k_cache, v_cache, valid, cfg)
    return out_proj(out, p, x.dtype), k_cache, v_cache


# the products a ``dots`` checkpoint keeps: matmuls with no batch dims
# (JAX's ``dots_with_no_batch_dims_saveable``); attention's batched
# products (``aten.bmm``) are recomputed with everything else
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def _requires_grad(x) -> bool:
    """Does a tensor of ``x`` (a tensor, or a dict, list or tuple of
    them) require a gradient?"""
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return False
    return any(_requires_grad(v) for v in x)


def remat(fn, *args, policy: str = "full"):
    """``fn(*args)``; while autograd records, its activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, non-reentrant), as JAX's
    ``jax.checkpoint`` does under ``policy``: ``full``
    (``nothing_saveable``: everything recomputed), ``dots``
    (``dots_with_no_batch_dims_saveable``: the outputs of ``aten.mm`` and
    ``aten.addmm`` kept, a selective checkpoint) or ``everything`` (all
    kept: ``fn(*args)`` itself). The numbers are the same under each.
    With no input that requires a gradient (serving), ``fn`` just runs."""
    if (policy == "everything" or not torch.is_grad_enabled()
            or not _requires_grad(args)):
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_contexts)
    return checkpoint(fn, *args, use_reentrant=False)


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
