"""The dry run: one rank's program of every (arch x input shape x mesh)
combination on the production H100 mesh, costed on the meta device, for
the roofline analysis (the JAX package's ``launch/dryrun_lib.py``).

JAX lowers and compiles the SPMD program against 256 or 512 host devices
and reads the compiled module's analyses. The port has no compiler: the
DeviceMesh stands on a fake process group of ``mesh.size`` ranks in this
process (``launch/mesh.py::start_fake_group``), the inputs are meta
tensors placed as DTensors by ``launch/specs.py``, and
``roofline.cost.jit_cost`` runs rank 0's program once under DTensor's
``implicit_replication`` (the RoPE tables, masks and positions the models
make inside are plain tensors), counting its local ops and its
collectives. Nothing is allocated or computed.

* **train**: the placed meta step of one rank (``sharding/placed.py``):
  its learners' K local steps on their whole planes, then the meta
  average over the learner axes as one all-reduce and the fused
  momentum-broadcast kernel on the local rows. Under ``tp_mode="fsdp"``
  a learner's local batch is split over 'model' where it divides (as
  JAX's), and each local step averages the gradient over 'model'.
* **prefill / decode**: the model's forward and ``decode_step`` with the
  weights placed by ``serve_param_shardings`` (Megatron tensor
  parallelism over 'model', FSDP over 'data' above 20e9 parameters), the
  batch by ``_batch_axes`` and the cache by ``cache_shardings``. DTensor
  redistributes where an op needs it (``all-gather``, ``reduce-scatter``,
  ``all-reduce``). Its redistributions are not GSPMD's: the collective
  counts differ from JAX's by design, and no attempt is made to imitate
  GSPMD.

**Layer-scaled costing** (the default): JAX counts a scanned stack's
body once and multiplies it by the scan's trip count. The port runs every
layer eagerly, which at 32k tokens (DTensor runs ~2,048 attention blocks
a layer) or over xLSTM's 4,096-step recurrences takes minutes a layer.
So ``scaled_cost`` counts the row's program with one layer of each
distinct stack (the first dense layers, the dense or MoE ``blocks``,
Hymba's blocks, xLSTM's super-blocks; ``models/transformer.py::
LAYER_LIMIT``, the other layers idle), then with two layers of one stack
at a time, and adds each stack's second-layer difference once per layer
beyond the first: the embedding, the head, the state, the meta step and
its collectives are counted once, at full size. xLSTM's recurrences over
time (JAX's scans, the port's Python loops) are scaled the same way from
their first one and two steps (``models/xlstm.py::STEP_LIMIT``). Every
layer of a stack, and every step after the first, costs the same, so
this equals the eager count (``layer_scaled=False``;
``tests/test_torch_dryrun.py`` holds the two equal at 3 layers) in
flops, bytes, collectives and kernel calls. The temporaries are a peak,
not a sum: scaled the same way where autograd keeps each layer's
activations, the anchors' largest where nothing is kept (serving); exact
for the dense and MoE rows, within 11 % for Hymba's and xLSTM's, whose
peaks move between the anchors and the whole program.

A row has JAX's keys: ``memory`` (the per-device ``argument_size_in_bytes``,
``output_size_in_bytes`` and ``temp_size_in_bytes`` of ``jit_cost``),
``cost`` (``flops``, ``bytes accessed``), ``collectives`` (``total``,
``by_type``, and ``by_axes``), ``n_collective_sites`` (collective calls:
the program runs eagerly, each call is a site), ``hlo_cost``,
``roofline`` (``compute_terms`` at ``H100_SXM``, collectives over 'model'
at the NVLink rate and over the other axes at the node's network rate),
``param_count`` and ``active_param_count``. ``generated_code_size_in_bytes``,
``hlo_lines`` and ``compile_s`` have no counterpart and are left out;
``lower_s`` is the counted run's seconds. Every number in a row is
modeled at the data sheet's rates (``"modeled"`` says so); none is a
measurement of a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from dataclasses import replace

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    MAvgConfig,
    ModelConfig,
    get_config,
)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as S
from repro_torch.models import api as model_api
from repro_torch.roofline.cost import jit_cost
from repro_torch.roofline.terms import H100_SXM, compute_terms
from repro_torch.sharding.rules import Spec

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
    "dryrun"))

MODELED = ("modeled on the meta device at the H100 SXM data sheet's rates; "
           "not a measurement")


# ---------------------------------------------------------------------------
# applicability
# ---------------------------------------------------------------------------


def applicability(cfg: ModelConfig, shape: InputShape):
    """Returns (runs: bool, reason: str, serve_cfg: ModelConfig)."""
    if shape.is_decode and cfg.is_encoder_only:
        return False, "encoder-only architecture has no autoregressive decode", cfg
    if shape.name == "long_500k":
        if cfg.subquadratic:
            return True, "", cfg
        if cfg.name == "qwen3-1.7b":
            return True, "sliding-window-8192 serve variant", replace(
                cfg, sliding_window=8192)
        return False, "full O(S^2) attention at 524k context; no sub-quadratic variant defined by the model card", cfg
    return True, "", cfg


# ---------------------------------------------------------------------------
# the mesh on a fake process group
# ---------------------------------------------------------------------------


def fake_mesh(shape, axis_names):
    """A DeviceMesh of ``shape`` on a fake process group of its size: the
    group is started here (a fake group of another size is replaced; a
    real group is never touched)."""
    import math

    import torch.distributed as dist

    size = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != size:
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group exists; the dry run "
                               "needs a fake one of the mesh's size")
        dist.destroy_process_group()
    meshlib.start_fake_group(size)
    return meshlib.make_mesh(shape, axis_names)


def production_mesh(mesh_name: str):
    return fake_mesh(*meshlib.production_shape(mesh_name == "multi"))


# ---------------------------------------------------------------------------
# the programs of a row: (fn, args, kwargs of jit_cost)
# ---------------------------------------------------------------------------


def build_train(cfg: ModelConfig, mesh, shape: InputShape, *,
                hierarchical: bool = False, algorithm: str = "mavg",
                k_steps: int = S.DRYRUN_K_STEPS, tp_mode: str = "megatron",
                compute_dtype: str = "float32"):
    from repro_torch.sharding.placed import Placement, placed_meta_step

    L = (meshlib.mesh_size(mesh) if tp_mode == "dp"
         else meshlib.num_learners(mesh, hierarchical=hierarchical))
    mcfg = MAvgConfig(algorithm=algorithm, num_learners=L, k_steps=k_steps,
                      learner_lr=0.01, momentum=0.7,
                      compute_dtype=compute_dtype)
    laxes = (meshlib.axis_names(mesh) if tp_mode == "dp"
             else meshlib.learner_axes(mesh, hierarchical=hierarchical))
    state = S.place_tree(
        S.abstract_state(cfg, mcfg),
        S.state_shardings(cfg, mcfg, mesh, hierarchical=hierarchical,
                          tp_mode=tp_mode), mesh)
    lax_spec = laxes if len(laxes) > 1 else laxes[0]
    b_loc = shape.global_batch // L
    if tp_mode == "fsdp" and b_loc % meshlib.mesh_shape(mesh)["model"] == 0:
        # a learner's local batch split over 'model' (JAX's
        # dryrun_lib.py:93-97), its gradient averaged over 'model'
        batch_spec, batch_axis = Spec(lax_spec, None, "model"), "model"
    else:
        batch_spec, batch_axis = Spec(lax_spec), None
    batches = {name: S.place(x, batch_spec, mesh)
               for name, x in S.train_input_specs(cfg, shape, L,
                                                  k_steps).items()}
    placement = Placement(mesh, laxes, batch_axis)

    def loss_fn(params, batch):
        return model_api.loss_fn(params, cfg, batch)

    def train_step(state, batches):
        return placed_meta_step(state, batches, loss_fn=loss_fn, cfg=mcfg,
                                placement=placement)

    return train_step, (state, batches), dict(
        in_place=(0,), groups=placement.labels), mcfg


def _labels(mesh):
    from repro_torch.sharding.placed import GroupLabels

    return GroupLabels(mesh)


def build_prefill(cfg: ModelConfig, mesh, shape: InputShape):
    def prefill(params, batch):
        logits, _ = model_api.forward(params, cfg, batch)
        return logits

    params = S.place_tree(S.abstract_params(cfg),
                          S.serve_param_shardings(cfg, mesh), mesh)
    batch = S.place_tree(S.prefill_input_specs(cfg, shape),
                         S.prefill_input_shardings(cfg, mesh, shape), mesh)
    return prefill, (params, batch), dict(groups=_labels(mesh))


def build_decode(cfg: ModelConfig, mesh, shape: InputShape):
    def serve_step(params, cache, tokens):
        return model_api.decode_step(params, cfg, cache, tokens)

    params = S.place_tree(S.abstract_params(cfg),
                          S.serve_param_shardings(cfg, mesh), mesh)
    cache, tokens = S.decode_input_specs(cfg, shape)
    cache = S.place_tree(cache, S.cache_shardings(cfg, mesh, shape), mesh)
    tokens = S.place(tokens, S.decode_token_sharding(mesh, shape), mesh)
    return serve_step, (params, cache, tokens), dict(groups=_labels(mesh))


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------


def cost_program(fn, args, kwargs):
    """``jit_cost`` of one rank's program under implicit replication."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*a):
        with implicit_replication():
            return fn(*a)

    return jit_cost(run, *args, **kwargs)


def stack_depths(cfg: ModelConfig) -> dict:
    """The model's stacks of identical layers, by the names
    ``models/transformer.py::LAYER_LIMIT`` takes, and their depths."""
    if cfg.family == "ssm":
        return {"groups": cfg.num_layers // cfg.slstm_every}
    nd = cfg.first_dense_layers if cfg.num_experts else 0
    depths = {"blocks": cfg.num_layers - nd}
    if nd:
        depths["dense_blocks"] = nd
    return depths


@contextlib.contextmanager
def layer_limit(limits: dict):
    """Run only the first ``limits[name]`` layers of each named stack."""
    from repro_torch.models import transformer

    saved = dict(transformer.LAYER_LIMIT)
    transformer.LAYER_LIMIT.update(limits)
    try:
        yield
    finally:
        transformer.LAYER_LIMIT.clear()
        transformer.LAYER_LIMIT.update(saved)


_COST_NUMBERS = ("hbm_bytes", "flops", "arg_bytes", "out_bytes",
                 "alias_bytes", "temp_bytes", "collective_bytes",
                 "collective_calls")
_COST_TABLES = ("kernel_calls", "collectives_by_type",
                "collectives_by_axes")


def _affine(base, terms):
    """``base`` + sum of m x (c - base) over the (m, c) of ``terms``,
    field by field (the tables key by key)."""
    out = {f: getattr(base, f) + sum(m * (getattr(c, f) - getattr(base, f))
                                     for m, c in terms)
           for f in _COST_NUMBERS}
    for f in _COST_TABLES:
        keys = set(getattr(base, f)).union(*(getattr(c, f) for _, c in terms))
        b = getattr(base, f)
        table = {k: b.get(k, 0) + sum(m * (getattr(c, f).get(k, 0)
                                          - b.get(k, 0)) for m, c in terms)
                 for k in sorted(keys)}
        out[f] = {k: v for k, v in table.items() if v}
    return dataclasses.replace(base, **out)


@contextlib.contextmanager
def step_limit(n):
    """Run only the first ``n`` time steps of xLSTM's recurrences."""
    from repro_torch.models import xlstm

    saved = xlstm.STEP_LIMIT
    xlstm.STEP_LIMIT = n
    try:
        yield
    finally:
        xlstm.STEP_LIMIT = saved


def scaled_cost(fn, args, kwargs, cfg: ModelConfig, seq_len: int = 1,
                grad: bool = True):
    """The layer-scaled cost of a row's program (see the module
    docstring): one layer of every stack, plus for each deeper stack its
    depth - 1 times the cost of its second layer. xLSTM's recurrences
    (``seq_len`` steps in each block, ``MLSTM_CHUNK`` off) scale the same
    way over time: with G super-blocks and S steps, from the runs of
    (1 or 2 super-blocks) x (1 or 2 steps), c(G, S) = c11 + (G-1) dG +
    (S-1) dS + (G-1)(S-1) dGS, dGS = c22 - c21 - c12 + c11."""
    from repro_torch.models import xlstm

    depths = stack_depths(cfg)
    one = {name: 1 for name in depths}

    def run(limits, steps=None):
        with layer_limit(limits), step_limit(steps):
            return cost_program(fn, args, kwargs)

    timed = (cfg.family == "ssm" and seq_len > 2
             and not (xlstm.MLSTM_CHUNK and seq_len % xlstm.MLSTM_CHUNK
                      == 0))
    steps = 1 if timed else None
    base = run(one, steps)
    terms = []
    for name, depth in depths.items():
        if depth > 1:
            terms.append((depth - 1, run({**one, name: 2}, steps)))
    if timed:
        (name, G), = depths.items()
        c12 = run(one, 2)
        terms.append((seq_len - 1, c12))
        if G > 1:
            c21, c22 = terms[0][1], run({name: 2}, 2)
            m = (G - 1) * (seq_len - 1)
            terms += [(m, c22), (-m, c21), (-m, c12)]
    cost = _affine(base, terms)
    if not grad:
        # the peak of a forward without autograd sits in one layer (or
        # step): the anchors' largest, not a sum over the layers
        cost = dataclasses.replace(cost, temp_bytes=max(
            c.temp_bytes for c in [base] + [c for _, c in terms]))
    return cost


def run_one(arch: str, shape_name: str, mesh_name: str, *,
            hierarchical: bool = False, algorithm: str = "mavg",
            save_hlo: bool = False, tp_mode: str = "megatron",
            compute_dtype: str = "float32", variant: str = "",
            k_steps: int = S.DRYRUN_K_STEPS,
            expert_shard_map: bool = False,
            layer_scaled: bool = True) -> dict:
    """One row. ``layer_scaled=False`` counts every layer eagerly instead
    of scaling one layer of each stack by its depth (the same numbers,
    much slower at 32k tokens)."""
    if save_hlo:
        raise NotImplementedError(
            "--save-hlo has no counterpart: the port runs eagerly, and there "
            "is no compiled module to save")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    runs, reason, cfg_eff = applicability(cfg, shape)
    mode = "hier" if hierarchical else "faithful"
    if variant:
        mode = f"{mode}+{variant}"
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": mode, "algorithm": algorithm, "tp_mode": tp_mode,
        "compute_dtype": compute_dtype,
        "skipped": not runs, "reason": reason,
    }
    if not runs:
        return result

    mesh = production_mesh(mesh_name)
    chips = meshlib.mesh_size(mesh)
    from repro_torch.models import moe

    ctx = contextlib.nullcontext()
    if expert_shard_map and shape.kind != "train":
        # each rank computes only its experts (serving only, as JAX's)
        ctx = moe.expert_axis("model", mesh)
    t0 = time.time()
    mcfg = None
    with ctx:
        if shape.kind == "train":
            fn, args, kw, mcfg = build_train(
                cfg_eff, mesh, shape, hierarchical=hierarchical,
                algorithm=algorithm, tp_mode=tp_mode,
                compute_dtype=compute_dtype, k_steps=k_steps)
            k_steps = mcfg.k_steps
        elif shape.kind == "prefill":
            fn, args, kw = build_prefill(cfg_eff, mesh, shape)
            k_steps = 1
        else:
            fn, args, kw = build_decode(cfg_eff, mesh, shape)
            k_steps = 1
        cost = (scaled_cost(fn, args, kw, cfg_eff,
                            1 if shape.is_decode else shape.seq_len,
                            grad=shape.kind == "train")
                if layer_scaled else cost_program(fn, args, kw))
    result["modeled"] = MODELED
    result["layer_scaled"] = layer_scaled
    result["memory"] = {
        "argument_size_in_bytes": float(cost.arg_bytes),
        "output_size_in_bytes": float(cost.out_bytes),
        "temp_size_in_bytes": float(cost.temp_bytes),
        "alias_size_in_bytes": float(cost.alias_bytes),
    }
    result["cost"] = {"flops": cost.flops, "bytes accessed": cost.hbm_bytes}
    result["collectives"] = {
        "total": cost.collective_bytes,
        "by_type": cost.collectives_by_type,
        "by_axes": cost.collectives_by_axes,
    }
    result["n_collective_sites"] = cost.collective_calls
    result["kernel_calls"] = cost.kernel_calls
    result["lower_s"] = round(time.time() - t0, 2)
    result["hlo_cost"] = {"flops": cost.flops, "bytes": cost.hbm_bytes}
    terms = compute_terms(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_bytes, cfg=cfg_eff,
        k_steps=k_steps, comm=mcfg.comm if mcfg is not None else None,
        num_learners=mcfg.num_learners if mcfg is not None else 1,
        rates=H100_SXM, collectives_by_axes=cost.collectives_by_axes)
    result["roofline"] = terms.to_dict()
    result["param_count"] = cfg_eff.param_count()
    result["active_param_count"] = cfg_eff.active_param_count()
    return result


def result_path(arch, shape_name, mesh_name, mode="faithful",
                algorithm="mavg"):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if algorithm == "mavg" else f"__{algorithm}"
    return os.path.join(
        RESULTS_DIR, f"{arch}__{shape_name}__{mesh_name}__{mode}{suffix}.json")


def save_result(res: dict, algorithm="mavg"):
    path = result_path(res["arch"], res["shape"], res["mesh"], res["mode"],
                       res.get("algorithm", algorithm))
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path
