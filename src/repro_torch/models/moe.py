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

The expert-parallel placements (``EXPERT_AXIS``, ``SHARD_MAP_MESH``,
``set_expert_axis``), on a DeviceMesh where the weights and activations
are DTensors (the dry run of a mesh, ``launch/dryrun_lib.py``); both are
no-ops unless ``set_expert_axis`` was called, as in JAX:

* ``_constrain_experts`` redistributes the (E, C, d) tables to the expert
  dim split over the expert axis (JAX's ``with_sharding_constraint``),
  so the expert matmuls stay local;
* ``_experts_shard_map`` (serving only, as JAX's ``shard_map``, when a
  mesh is set too): each rank runs its E / n experts on the replicated
  token block, and one all-reduce of the f32 (T, d) partial combines
  them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, swiglu
from repro_torch.utils.tree import is_dtensor

# the mesh axis the expert dim is split over (None: no placement), and the
# DeviceMesh of the manual expert-parallel path (None: the DTensor path)
EXPERT_AXIS = None
SHARD_MAP_MESH = None


def set_expert_axis(axis, mesh=None):
    global EXPERT_AXIS, SHARD_MAP_MESH
    EXPERT_AXIS = axis
    SHARD_MAP_MESH = mesh


@contextlib.contextmanager
def expert_axis(axis, mesh=None):
    """``set_expert_axis`` for the ``with`` block, then back."""
    saved = (EXPERT_AXIS, SHARD_MAP_MESH)
    set_expert_axis(axis, mesh)
    try:
        yield
    finally:
        set_expert_axis(*saved)


def _expert_dim(mesh) -> int:
    return list(mesh.mesh_dim_names).index(EXPERT_AXIS)


def _constrain_experts(x):
    """Split the expert dim (0) of an (E, C, ...) DTensor over the expert
    axis, every other mesh dim replicated (JAX's ``P(EXPERT_AXIS, None,
    ...)``). Left to itself DTensor may keep the table replicated and
    gather the expert weights instead. No-op unless ``set_expert_axis``
    was called, or on a plain tensor (one device)."""
    if EXPERT_AXIS is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    pl = [Replicate()] * mesh.ndim
    pl[_expert_dim(mesh)] = Shard(0)
    return x.redistribute(mesh, pl)


def _replicated(x):
    """A DTensor's whole value on every rank (this rank's plain tensor)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def _expert_piece(w, shard: int, n: int):
    """Experts [shard E/n, (shard + 1) E/n) of an (E, ...) weight: this
    rank's piece of a DTensor split over the expert axis (redistributed
    there first), or a slice of a plain tensor."""
    if is_dtensor(w):
        from torch.distributed.tensor import Replicate, Shard

        mesh = w.device_mesh
        pl = [Replicate()] * mesh.ndim
        pl[_expert_dim(mesh)] = Shard(0)
        return w.redistribute(mesh, pl).to_local()
    e = w.shape[0] // n
    return w[shard * e:(shard + 1) * e]


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

    # slot s = (t, j) -> its position in expert slot_expert[s]'s buffer:
    # the running count of the expert's slots in flattened slot order. The
    # one-hot is (E, T*k), so the count is a scan along its inner dim (the
    # reference's (T*k, E) cumsum, transposed: along the outer dim the
    # card's scan takes 4.5 ms a layer at T*k = 24,576)
    slot_expert = idx.reshape(-1)  # (T*k,)
    C = _capacity(T, cfg, dropless)
    experts = torch.arange(E, device=idx.device)
    counts = torch.cumsum(slot_expert[None, :] == experts[:, None], dim=1)

    # load-balance auxiliary loss (Switch-style); the scan's last column
    # is each expert's slot count (the reference's bincount, whose output
    # length depends on the data, which DTensor cannot propagate)
    me = probs.mean(0)
    ce = counts[:, -1].to(torch.float32) / (T * k)
    aux = E * torch.sum(me * ce) * cfg.moe_aux_coef

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
    if SHARD_MAP_MESH is not None and EXPERT_AXIS is not None:
        out = _experts_shard_map(xt, p, cfg, gates, slot_expert,
                                 pos_clamped, keep, C)
        if cfg.num_shared_experts:
            out = out + swiglu(xt, p["shared"])
        return out.reshape(B, S, d), aux

    # the (E, C) dispatch table of token ids, sentinel T = empty. Dropped
    # (over-capacity) slots write to one extra cell past the table, which
    # is cut off: they must not overwrite the slot that fills the capacity
    token_of_slot = torch.arange(T, device=x.device).repeat_interleave(k)
    flat = torch.where(keep, slot_expert * C + pos_clamped,
                       torch.full_like(slot_expert, E * C))
    dispatch = torch.full((E * C + 1,), T, dtype=torch.long,
                          device=x.device).scatter(0, flat, token_of_slot)
    dispatch = dispatch[:E * C].view(E, C)
    # the gates laid out like the table, out of place so that autograd
    # carries their gradient to the router
    gate_tab = torch.zeros(E * C + 1, dtype=torch.float32,
                           device=x.device).scatter(0, flat,
                                                    gates.reshape(-1))
    gate_tab = gate_tab[:E * C].view(E, C)

    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    x_e = _constrain_experts(xt_pad[dispatch])  # (E, C, d)
    # each (E, C, ...) table is dropped as soon as the next is formed: a
    # dropless prefill's are 1-1.5 GB each (serving keeps no graph)
    w_in = p["w_in"].to(dt)
    de = w_in.shape[-1]
    h = torch.bmm(x_e, w_in.reshape(E, d, 2 * de)).view(E, C, 2, de)
    del x_e, w_in
    h = F.silu(h[..., 0, :]) * h[..., 1, :]
    y_e = _constrain_experts(torch.bmm(h, p["w_out"].to(dt)))  # (E, C, d)
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
    return _batch_view(out, xt, B, S), aux


def _batch_view(out, xt, B: int, S: int):
    """The (T, d) combine ``out`` viewed as (B, S, d). On a mesh the
    combine's gathers can leave ``out`` split along T over more axes than
    the tokens are (('data', 'model') at one sequence a 'data' rank of a
    prefill), and DTensor cannot view such a split back to (B, S, d): it
    is gathered over the axes that split T and not the tokens ``xt`` first
    (one all-gather; any other placement is kept)."""
    if is_dtensor(out):
        from torch.distributed.tensor import Replicate

        extra = [i for i, (p, q) in enumerate(zip(out.placements,
                                                  xt.placements))
                 if p.is_shard(0) and not q.is_shard(0)]
        if extra:
            out = out.redistribute(out.device_mesh, [
                Replicate() if i in extra else p
                for i, p in enumerate(out.placements)])
    return out.reshape(B, S, out.shape[-1])


def local_experts(xt, gates, slot_expert, pos_clamped, keep, C, w_in, w_out,
                  lo: int, k: int):
    """The partial (T, d) f32 output of experts [lo, lo + E_loc) (the
    weights' pieces ``w_in`` (E_loc, d, 2, de), ``w_out`` (E_loc, de, d)):
    their slots' rows of the token block, combined per token in slot order
    as the dense route combines them. The sum over the shards' partials is
    the dense route's output."""
    T, d = xt.shape
    dt = xt.dtype
    E_loc = w_in.shape[0]
    mine = keep & (slot_expert >= lo) & (slot_expert < lo + E_loc)
    flat = torch.where(mine, (slot_expert - lo) * C + pos_clamped,
                       torch.full_like(slot_expert, E_loc * C))
    token_of_slot = torch.arange(T, device=xt.device).repeat_interleave(k)
    dispatch = torch.full((E_loc * C + 1,), T, dtype=torch.long,
                          device=xt.device).scatter(0, flat, token_of_slot)
    dispatch = dispatch[:E_loc * C].view(E_loc, C)
    gate_tab = torch.zeros(E_loc * C + 1, dtype=torch.float32,
                           device=xt.device).scatter(0, flat,
                                                     gates.reshape(-1))
    gate_tab = gate_tab[:E_loc * C].view(E_loc, C)
    x_e = torch.cat([xt, xt.new_zeros((1, d))], dim=0)[dispatch]
    w_in = w_in.to(dt)
    de = w_in.shape[-1]
    h = torch.bmm(x_e, w_in.reshape(E_loc, d, 2 * de)).view(E_loc, C, 2, de)
    h = F.silu(h[..., 0, :]) * h[..., 1, :]
    y_w = torch.bmm(h, w_out.to(dt)) * gate_tab[..., None].to(dt)
    slots = flat.view(T, k).sort(dim=-1).values
    rows = y_w.reshape(E_loc * C, d)[slots.clamp(max=E_loc * C - 1)]
    part = torch.where((slots < E_loc * C)[..., None], rows, 0).sum(dim=1)
    return part.to(torch.float32)


def _experts_shard_map(xt, p, cfg: ModelConfig, gates, slot_expert,
                       pos_clamped, keep, C):
    """Manual expert parallelism (serving): each rank of the expert axis
    owns E / n experts, runs them on the replicated token block and adds
    its partial (T, d) into one f32 all-reduce over the axis (psum in f32,
    as JAX's). Returns the (T, d) output in ``xt``'s dtype."""
    import torch.distributed._functional_collectives as funcol

    mesh = SHARD_MAP_MESH
    n = mesh.size(_expert_dim(mesh))
    shard = mesh.get_local_rank(EXPERT_AXIS)
    dt = xt.dtype
    xt, gates, slot_expert, pos_clamped, keep = (
        _replicated(t) for t in (xt, gates, slot_expert, pos_clamped, keep))
    w_in = _expert_piece(p["w_in"], shard, n)
    w_out = _expert_piece(p["w_out"], shard, n)
    part = local_experts(xt, gates, slot_expert, pos_clamped, keep, C,
                         w_in, w_out, shard * w_in.shape[0], cfg.moe_top_k)
    if n > 1:
        part = funcol.wait_tensor(funcol.all_reduce(
            part, "sum", mesh.get_group(EXPERT_AXIS)))
    return part.to(dt)
