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
  momentum-broadcast kernel on the local rows.
* **prefill / decode**: the model's forward and ``decode_step`` with the
  weights placed by ``serve_param_shardings`` (Megatron tensor
  parallelism over 'model', FSDP over 'data' above 20e9 parameters), the
  batch by ``_batch_axes`` and the cache by ``cache_shardings``. DTensor
  redistributes where an op needs it (``all-gather``, ``reduce-scatter``,
  ``all-reduce``). Its redistributions are not GSPMD's: the collective
  counts differ from JAX's by design, and no attempt is made to imitate
  GSPMD.

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

    if tp_mode == "fsdp":
        raise NotImplementedError(
            "tp_mode 'fsdp' splits a learner's batch over 'model', which "
            "needs a gradient all-reduce over 'model' inside the local phase; "
            "the placed step runs 'megatron' and 'dp'")
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
    batches = {name: S.place(x, Spec(lax_spec), mesh)
               for name, x in S.train_input_specs(cfg, shape, L,
                                                  k_steps).items()}
    placement = Placement(mesh, laxes)

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


def run_one(arch: str, shape_name: str, mesh_name: str, *,
            hierarchical: bool = False, algorithm: str = "mavg",
            save_hlo: bool = False, tp_mode: str = "megatron",
            compute_dtype: str = "float32", variant: str = "",
            k_steps: int = S.DRYRUN_K_STEPS,
            expert_shard_map: bool = False) -> dict:
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
        cost = cost_program(fn, args, kw)
    result["modeled"] = MODELED
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
