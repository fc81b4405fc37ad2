"""Mixture-of-Experts layer: fine-grained routed experts and shared experts
(the JAX package's ``models/moe.py``), for DeepSeekMoE (2 shared + 64
routed, top-6) and Kimi-K2 (1 shared + 384 routed, top-8).

Dispatch is the capacity-bounded gather of the reference: each (token,
j) slot gets a position in its expert's capacity buffer from a cumsum over
the routing one-hot, in flattened slot order, so the later slots of an
expert past its capacity are the dropped ones. The expert products are
batched matmuls over the (E, C, d) dispatch table, as JAX's einsums are
(no Pallas kernel reaches them); ``dropless=True`` (the serving paths)
sizes C for the worst case, C = T. The combine gathers each token's slots
back and sums them in the order the reference's scatter-add adds them,
with no atomics, so a run on the card repeats bit for bit.

The reference's expert-parallel placements (``EXPERT_AXIS``,
``SHARD_MAP_MESH``, the ``shard_map`` path) are GSPMD annotations, no-ops
on one device; they wait for the placement of the dry-run half
(ROADMAP Queue 1, item 10: the experts' dim over a DeviceMesh axis).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, swiglu


def init_moe(gen, cfg: ModelConfig, device, lead=()) -> dict:
    """Router (d, E), per-expert [gate, up] ``w_in`` (E, d, 2, d_expert)
    and ``w_out`` (E, d_expert, d), and the shared experts as one MLP of
    width ``num_shared_experts * d_expert``; ``lead`` stacks layers."""
    d, E, de = cfg.d_model, cfg.num_experts, cfg.d_expert
    p = {
        "router": dense_init(gen, lead + (d, E), d, device),
        "w_in": dense_init(gen, lead + (E, d, 2, de), d, device),
        "w_out": dense_init(gen, lead + (E, de, d), de, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * de, device,
                               lead)
    return p


def _capacity(num_tokens: int, cfg: ModelConfig,
              dropless: bool = False) -> int:
    """Per-expert capacity, rounded up to a multiple of 8 with a floor of
    8. Dropless: ``num_tokens`` (top-k experts are distinct per token, so
    one expert gets at most one slot a token)."""
    if dropless:
        c = num_tokens
    else:
        c = int(num_tokens * cfg.moe_top_k * cfg.capacity_factor
                / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _route(xt, p, cfg: ModelConfig, dropless: bool = False):
    """Router and capacity assignment of the (T, d) tokens ``xt``.

    Returns (gates (T, k) f32, slot_expert (T*k,), pos_clamped (T*k,),
    keep (T*k,) bool, aux, C). The logits are formed in ``xt``'s dtype and
    then cast to f32, as in JAX; the top-k is a stable descending sort, so
    tied probabilities pick the lower expert first, as ``lax.top_k``.
    """
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k]
    return _assign(probs, idx, cfg, dropless)


def _assign(probs, idx, cfg: ModelConfig, dropless: bool = False):
    """The rest of ``_route`` for the router probabilities ``probs`` (T, E)
    and the chosen experts ``idx`` (T, k): their normalised gates, the
    aux loss, and each slot's position in its expert's capacity."""
    T = probs.shape[0]
    E, k = cfg.num_experts, cfg.moe_top_k
    gates = probs.gather(1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    slot_expert = idx.reshape(-1)  # (T*k,)
    me = probs.mean(0)
    ce = torch.bincount(slot_expert, minlength=E).to(torch.float32) / (T * k)
    aux = E * torch.sum(me * ce) * cfg.moe_aux_coef

    # slot s = (t, j) -> its position in expert slot_expert[s]'s buffer:
    # the running count of the expert's slots in flattened slot order. The
    # one-hot is (E, T*k), so the count is a scan along its inner dim (the
    # reference's (T*k, E) cumsum, transposed: along the outer dim the
    # card's scan takes 4.5 ms a layer at T*k = 24,576)
    C = _capacity(T, cfg, dropless)
    experts = torch.arange(E, device=idx.device)
    counts = torch.cumsum(slot_expert[None, :] == experts[:, None], dim=1)
    pos_in_e = counts.gather(0, slot_expert[None, :])[0] - 1
    keep = pos_in_e < C
    pos_clamped = torch.clamp(pos_in_e, max=C - 1)
    return gates, slot_expert, pos_clamped, keep, aux, C


def moe_layer(x, p, cfg: ModelConfig, dropless: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux loss 0-d f32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    dt = x.dtype

    gates, slot_expert, pos_clamped, keep, aux, C = _route(xt, p, cfg,
                                                           dropless)
    # the (E, C) dispatch table of token ids, sentinel T = empty. Dropped
    # (over-capacity) slots write to one extra cell past the table, which
    # is cut off: they must not overwrite the slot that fills the capacity
    token_of_slot = torch.arange(T, device=x.device).repeat_interleave(k)
    flat = torch.where(keep, slot_expert * C + pos_clamped,
                       torch.full_like(slot_expert, E * C))
    dispatch = torch.full((E * C + 1,), T, dtype=torch.long,
                          device=x.device).scatter_(0, flat, token_of_slot)
    dispatch = dispatch[:E * C].view(E, C)
    # the gates laid out like the table, out of place so that autograd
    # carries their gradient to the router
    gate_tab = torch.zeros(E * C + 1, dtype=torch.float32,
                           device=x.device).scatter(0, flat,
                                                    gates.reshape(-1))
    gate_tab = gate_tab[:E * C].view(E, C)

    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    x_e = xt_pad[dispatch]  # (E, C, d)
    # each (E, C, ...) table is dropped as soon as the next is formed: a
    # dropless prefill's are 1-1.5 GB each (serving keeps no graph)
    w_in = p["w_in"].to(dt)
    de = w_in.shape[-1]
    h = torch.bmm(x_e, w_in.reshape(E, d, 2 * de)).view(E, C, 2, de)
    del x_e, w_in
    h = F.silu(h[..., 0, :]) * h[..., 1, :]
    y_e = torch.bmm(h, p["w_out"].to(dt))  # (E, C, d)
    del h
    y_w = y_e * gate_tab[..., None].to(dt)
    del y_e
    # combine: each token sums its kept slots' rows of the table, in
    # expert order, as the reference's scatter-add visits them (dropped
    # slots, E*C, sort last and add zero). A gather, not a scatter-add:
    # the card adds in a fixed order (index_add's atomics would make one
    # prefill differ from the next, and near-tied router choices after it)
    slots = flat.view(T, k).sort(dim=-1).values
    rows = y_w.reshape(E * C, d)[slots.clamp(max=E * C - 1)]
    out = torch.where((slots < E * C)[..., None], rows, 0).sum(dim=1)
    if cfg.num_shared_experts:
        out = out + swiglu(xt, p["shared"])
    return out.reshape(B, S, d), aux
