"""Abstract inputs on the meta device and placement specs for the dry run
and the launchers (the JAX package's ``launch/specs.py``).

``abstract_params``/``abstract_state`` and the ``*_input_specs`` build
``meta`` tensors: shapes and dtypes, no memory (JAX's
``ShapeDtypeStruct``), the stub modality inputs included (audio frame
embeddings, VLM patch embeddings). The ``*_shardings`` functions return
placement specs (``sharding.rules.Spec``, one entry a dim) in the trees
of their tensors; ``sharding.rules.named`` turns them into DTensor
placements on a DeviceMesh, and ``place`` places meta or real tensors
with them. Every spec here equals JAX's for the same mesh axis sizes.

JAX's ``meta_step_jit_kwargs`` (donation, and one sharding for the state
in and out) has no counterpart: the port's ``meta_step`` consumes its
state in place already, and its placement is the one it came in with.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, MAvgConfig, ModelConfig
from repro_torch.core.meta import MetaState, init_state
from repro_torch.launch import mesh as meshlib
from repro_torch.models import api as model_api
from repro_torch.sharding.rules import (
    Spec,
    add_learner_axis,
    make_param_specs,
    mesh_shape,
    placements,
    spec_shards,
)

DRYRUN_K_STEPS = 2  # local steps per meta step in the dry run's program
SERVE_FSDP_THRESHOLD = 20e9  # params above this get FSDP-split weights
SERVE_FSDP_ENABLED = True  # flip for a performance comparison


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: JAX's ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# abstract params / state
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig):
    return model_api.init_params(None, cfg, device="meta")


def abstract_state(cfg: ModelConfig, mcfg: MAvgConfig) -> MetaState:
    return init_state(abstract_params(cfg), mcfg)


# ---------------------------------------------------------------------------
# train inputs: (L, K, B_local, ...) per learner per local step
# ---------------------------------------------------------------------------


def train_input_specs(cfg: ModelConfig, shape: InputShape, num_learners: int,
                      k_steps: int = DRYRUN_K_STEPS) -> dict:
    assert shape.global_batch % num_learners == 0, (
        f"{shape.name}: global_batch {shape.global_batch} not divisible by "
        f"P={num_learners}"
    )
    b_loc = shape.global_batch // num_learners
    lead = (num_learners, k_steps, b_loc)
    return {name: sds(lead + tuple(shp[1:]), dtype)
            for name, (shp, dtype) in model_api.batch_shapes(
                cfg, 1, shape.seq_len).items()}


def train_input_shardings(cfg: ModelConfig, mesh, learner_axes) -> dict:
    return {name: Spec(learner_axes)
            for name in model_api.batch_shapes(cfg, 1, 8)}


def _batch_axes(mesh, batch: int):
    """Largest prefix of (pod, data) axes that divides the batch."""
    shape = mesh_shape(mesh)
    chosen = []
    size = 1
    for a in (a for a in ("pod", "data") if a in shape):
        if batch % (size * shape[a]) == 0:
            chosen.append(a)
            size *= shape[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


# ---------------------------------------------------------------------------
# state shardings (train)
# ---------------------------------------------------------------------------


def _map_tree(fn, tree):
    """``fn`` on every tensor of a dict / tuple / list tree; None stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _topo_specs(topo, learner_spec, gossip: bool):
    """Specs of ``MetaState.topo``: every buffer replicated (the
    hierarchical (G, ...) stacks, EF residual stacks, (L,) clocks), but
    the gossip per-learner stacks and the async server's anchor plane,
    which split like the learners."""
    if topo is None:
        return None
    out = _map_tree(lambda _: Spec(), topo)
    if gossip:
        out["params"] = learner_spec
        out["momentum"] = learner_spec
    if "anchor" in out:
        out["anchor"] = learner_spec
    return out


def state_shardings(cfg: ModelConfig, mcfg: MAvgConfig, mesh, *,
                    hierarchical: bool = False,
                    tp_mode: str = "megatron") -> MetaState:
    """The specs of a MetaState, field for field. tp_mode:
    'megatron': tensor parallelism inside a learner over 'model' (heads /
        d_ff split; activations all-reduced a layer);
    'fsdp': weights split over 'model' on their largest dim (ZeRO-3);
    'dp': one learner a device, weights whole (only the meta average
        communicates).
    """
    laxes = meshlib.learner_axes(mesh, hierarchical=hierarchical)
    fsdp = meshlib.fsdp_axes(mesh, hierarchical=hierarchical)
    params = abstract_params(cfg)
    if getattr(mcfg, "packed", False):
        return _packed_state_shardings(cfg, mcfg, mesh, params, laxes,
                                       tp_mode)
    if tp_mode == "dp":
        laxes = meshlib.axis_names(mesh)
        gp_specs = make_param_specs(params, mesh, model_axis=None)
    elif tp_mode == "fsdp":
        gp_specs = make_param_specs(params, mesh, model_axis=None,
                                    fsdp_axis="model")
    else:
        gp_specs = make_param_specs(params, mesh, model_axis="model",
                                    fsdp_axis=fsdp)
    learner_specs = add_learner_axis(
        gp_specs, laxes if len(laxes) > 1 else laxes[0])
    from repro_torch.comm import uses_error_feedback

    topo = abstract_state(cfg, mcfg).topo
    return MetaState(
        global_params=gp_specs,
        momentum=gp_specs,
        learners=learner_specs,
        local_momentum=(learner_specs if mcfg.algorithm == "mavg_mlocal"
                        else None),
        step=Spec(),
        comm_residual=learner_specs if uses_error_feedback(mcfg) else None,
        topo=_topo_specs(topo, learner_specs,
                         mcfg.topology.kind == "gossip"),
    )


def _packed_state_shardings(cfg: ModelConfig, mcfg: MAvgConfig, mesh,
                            params, laxes, tp_mode: str) -> MetaState:
    """Specs for the packed flat meta-plane (``repro_torch.pack``): the
    (rows, 128) row dim goes over 'model' when each piece keeps a multiple
    of 8 rows; the learner dim of the (L, rows, 128) stacks over the
    learner axes. The returned MetaState carries the live state's
    PackSpec."""
    from repro_torch.comm import uses_error_feedback
    from repro_torch.pack import make_pack_spec

    spec = make_pack_spec(params, dtype=mcfg.meta_dtype)
    shape = mesh_shape(mesh)
    if tp_mode == "dp":
        laxes = meshlib.axis_names(mesh)
    lax_spec = laxes if len(laxes) > 1 else laxes[0]
    row_ax = None
    if (tp_mode != "dp" and "model" in shape
            and spec.rows % (shape["model"] * 8) == 0):
        row_ax = "model"
    plane = Spec(row_ax, None)
    stacked = Spec(lax_spec, row_ax, None)
    topo = init_state(params, mcfg).topo
    return MetaState(
        global_params=plane,
        momentum=plane,
        learners=stacked,
        local_momentum=stacked if mcfg.algorithm == "mavg_mlocal" else None,
        step=Spec(),
        comm_residual=stacked if uses_error_feedback(mcfg) else None,
        topo=_topo_specs(topo, stacked, mcfg.topology.kind == "gossip"),
        spec=spec,
    )


# ---------------------------------------------------------------------------
# serve (prefill) inputs
# ---------------------------------------------------------------------------


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    return {name: sds(shp, dtype)
            for name, (shp, dtype) in model_api.batch_shapes(
                cfg, shape.global_batch, shape.seq_len).items()
            if name != "labels"}


def prefill_input_shardings(cfg: ModelConfig, mesh,
                            shape: InputShape) -> dict:
    baxes = _batch_axes(mesh, shape.global_batch)
    return {name: Spec(baxes, *([None] * (len(shp) - 1)))
            for name, (shp, _dt) in model_api.batch_shapes(
                cfg, shape.global_batch, shape.seq_len).items()
            if name != "labels"}


def serve_param_shardings(cfg: ModelConfig, mesh):
    fsdp = None
    if SERVE_FSDP_ENABLED and cfg.param_count() > SERVE_FSDP_THRESHOLD:
        fsdp = ("pod", "data") if "pod" in mesh_shape(mesh) else "data"
    return make_param_specs(abstract_params(cfg), mesh, model_axis="model",
                            fsdp_axis=fsdp)


# ---------------------------------------------------------------------------
# decode inputs (one token + cache)
# ---------------------------------------------------------------------------


def decode_input_specs(cfg: ModelConfig, shape: InputShape):
    cache = model_api.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
    return cache, sds((shape.global_batch,), torch.int32)


def cache_shardings(cfg: ModelConfig, mesh, shape: InputShape):
    """Family-specific KV-cache / recurrent-state placement."""
    baxes = _batch_axes(mesh, shape.global_batch)
    msize = mesh_shape(mesh)["model"]
    ns = Spec

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        seq_ax = "model" if shape.seq_len % msize == 0 else None
        return {
            "k": ns(None, baxes, seq_ax, None, None),
            "v": ns(None, baxes, seq_ax, None, None),
            "pos": ns(),
        }
    if cfg.family == "hybrid":
        W = min(cfg.sliding_window or shape.seq_len, shape.seq_len)
        win_ax = "model" if W % msize == 0 else None
        din_ax = ("model" if (cfg.ssm_expand * cfg.d_model) % msize == 0
                  else None)
        return {
            "k": ns(None, baxes, win_ax, None, None),
            "v": ns(None, baxes, win_ax, None, None),
            "k_meta": ns(None, baxes, None, None, None),
            "v_meta": ns(None, baxes, None, None, None),
            "conv": ns(None, baxes, None, din_ax),
            "ssm": ns(None, baxes, din_ax, None),
            "pos": ns(),
        }
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        hd_m = d_in // cfg.num_heads  # mLSTM head dim
        hd_s = cfg.d_model // cfg.num_heads  # sLSTM head dim
        m_ax = "model" if hd_m % msize == 0 else None
        s_ax = "model" if hd_s % msize == 0 else None
        din_ax = "model" if d_in % msize == 0 else None
        return {
            "m": (
                ns(None, None, baxes, None, None, m_ax),  # C (G,M,B,nh,hd,hd)
                ns(None, None, baxes, None, m_ax),  # n (G,M,B,nh,hd)
                ns(None, None, baxes, None),  # m (G,M,B,nh)
                ns(None, None, baxes, None, din_ax),  # conv (G,M,B,k-1,d_in)
            ),
            "s": tuple(ns(None, baxes, None, s_ax) for _ in range(4)),
            "pos": ns(),
        }
    raise ValueError(cfg.family)


def decode_token_sharding(mesh, shape: InputShape):
    return Spec(_batch_axes(mesh, shape.global_batch))


# ---------------------------------------------------------------------------
# placing tensors, and their per-device bytes
# ---------------------------------------------------------------------------


def _pairs(tensors, specs):
    """(tensor, spec) pairs of two trees of one structure (a MetaState, a
    dict, a tuple); a None spec or tensor is skipped."""
    if specs is None or tensors is None:
        return []
    if isinstance(specs, Spec):
        return [(tensors, specs)] if isinstance(tensors, torch.Tensor) else []
    if isinstance(specs, MetaState):
        return [p for f in ("global_params", "momentum", "learners",
                            "local_momentum", "comm_residual", "topo")
                for p in _pairs(getattr(tensors, f), getattr(specs, f))]
    if isinstance(specs, dict):
        return [p for k in specs for p in _pairs(tensors[k], specs[k])]
    return [p for t, s in zip(tensors, specs) for p in _pairs(t, s)]


def sharded_arg_bytes(tensors, specs, mesh) -> float:
    """Per-device bytes of ``tensors`` placed by ``specs`` (JAX's
    ``dryrun_lib._sharded_arg_bytes``: size x itemsize over the number of
    pieces, for every tensor)."""
    return float(sum(t.numel() * t.element_size() / spec_shards(s, mesh)
                     for t, s in _pairs(tensors, specs)))


def place(x, spec, mesh):
    """``x`` (a meta or real tensor holding the whole value) as a DTensor
    on ``mesh`` placed by ``spec``: this rank's piece is cut out of it into
    a storage of its own (a meta piece allocates nothing), so placing moves
    no data between ranks. Where the piece is the whole of ``x`` (a mesh of
    size 1, a replicated spec) the DTensor's local tensor is ``x`` itself."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    pl = placements(spec, mesh)
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    if tuple(shape) == tuple(x.shape):
        local = x
    elif x.device.type == "meta":
        local = torch.empty(shape, dtype=x.dtype, device="meta")
    else:
        local = x[tuple(slice(o, o + n)
                        for o, n in zip(offset, shape))].clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def place_tree(tensors, specs, mesh):
    """Every tensor of ``tensors`` placed by the matching spec (a MetaState,
    dict or tuple tree); an int (``MetaState.step``) or None stays."""
    if specs is None or tensors is None:
        return tensors
    if isinstance(specs, Spec):
        return (place(tensors, specs, mesh)
                if isinstance(tensors, torch.Tensor) else tensors)
    if isinstance(specs, MetaState):
        import dataclasses

        return dataclasses.replace(tensors, **{
            f: place_tree(getattr(tensors, f), getattr(specs, f), mesh)
            for f in ("global_params", "momentum", "learners",
                      "local_momentum", "comm_residual", "topo")})
    if isinstance(specs, dict):
        return {k: place_tree(tensors[k], specs[k], mesh) for k in tensors}
    return type(tensors)(place_tree(t, s, mesh)
                         for t, s in zip(tensors, specs))
