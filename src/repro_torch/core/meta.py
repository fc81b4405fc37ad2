"""The paper's contribution: M-AVG (Algorithm 1) and its averaging
baselines, over any loss function (the JAX package's ``core/meta.py``).

Algorithms
----------
mavg         K local SGD steps per learner, then
             a = mean_j w_j; d = a - w~; v = mu v + d; w~ += v; reset.
kavg         mavg with mu = 0 (Zhou & Cong 2017, the paper's baseline).
sync         mavg with K = 1 (synchronous MSGD).
mavg_mlocal  learner-level momentum inside the K-step loop, block
             momentum on top.

How the port differs from JAX in execution, not in math:

* JAX vmaps the L learners; the port loops over them in turn, so one
  gradient plane is alive at a time.
* Under ``cfg.packed`` (the default) each learner's parameters are views
  of its slice of the (L, rows, 128) learner plane. Autograd accumulates
  each local step's gradient into one (rows, 128) gradient plane whose
  padding stays zero, and one launch of the SGD-apply kernel updates the
  learner's plane in place.
* The meta mix updates w~, v and the learner plane in place (one launch
  of the fused momentum-broadcast kernel). ``meta_step`` therefore
  consumes its input state, as the JAX step consumes a donated one: work
  off the returned state only.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.planes import f32
from repro_torch.pack import PackSpec, make_pack_spec
from repro_torch.utils.tree import (
    tree_broadcast_learners,
    tree_cast,
    tree_map,
    tree_norm,
)

LossFn = Callable[..., tuple[torch.Tensor, dict]]  # (params, batch) -> (loss, aux)


@dataclass
class MetaState:
    """Full state of the distributed trainer.

    global_params:  w~ (meta dtype, f32)
    momentum:       v, the block-momentum buffer
    learners:       learner copies, leading axis L (compute dtype)
    local_momentum: learner-level momentum (mavg_mlocal) or None
    step:           meta iteration n
    comm_residual:  error-feedback residual of the reducer (None: dense)
    topo:           topology buffers (None: flat)
    spec:           the PackSpec of the packed flat meta-plane, or None on
                    the per-leaf path. When set, every field above is one
                    (rows, 128) plane, or (L, rows, 128) along the learner
                    axis, instead of a parameter tree.
    """

    global_params: Any
    momentum: Any
    learners: Any
    local_momentum: Any
    step: int
    comm_residual: Any = None
    topo: Any = None
    spec: Optional[PackSpec] = None


def init_state(params, cfg: MAvgConfig, reducer=None,
               topology=None) -> MetaState:
    """Meta state (w~, v) in cfg.meta_dtype; learner copies in
    cfg.compute_dtype. The state owns copies of every buffer: the caller's
    params are never aliased, so the in-place meta step cannot touch them.
    """
    meta_dt = getattr(torch, cfg.meta_dtype)
    spec = None
    if cfg.packed:
        spec = make_pack_spec(params, dtype=cfg.meta_dtype)
        gp = spec.pack(params)  # a new plane
    else:
        gp = tree_map(lambda x: x.to(meta_dt, copy=True), params)
    learners = tree_broadcast_learners(
        tree_cast(gp, getattr(torch, cfg.compute_dtype)), cfg.num_learners
    )
    if topology is None:
        from repro_torch.topology import make_topology

        topology = make_topology(cfg, reducer)
    comm_residual, topo = topology.init_buffers(gp, cfg)
    return MetaState(
        global_params=gp,
        momentum=tree_map(torch.zeros_like, gp),
        learners=learners,
        local_momentum=(
            tree_map(torch.zeros_like, learners)
            if cfg.algorithm == "mavg_mlocal" else None
        ),
        step=0,
        comm_residual=comm_residual,
        topo=topo,
        spec=spec,
    )


# ---------------------------------------------------------------------------
# local phase: K SGD/MSGD steps per learner, no cross-learner communication
# ---------------------------------------------------------------------------


def _grad_into(loss_fn: LossFn, w, batch, g):
    """Loss at params ``w`` (a tree of views), with its gradient
    accumulated into the zeroed buffers ``g`` (a tree of the same shapes).

    Each leaf is a detached alias of the learner's storage with ``.grad``
    preset to its gradient buffer: autograd then adds the leaf gradient
    into that buffer in place, and no second full-model gradient is ever
    allocated.
    """

    def leaf(wi, gi):
        p = wi.detach().requires_grad_(True)
        p.grad = gi
        return p

    tree_map(lambda gi: gi.zero_(), g)
    params = tree_map(leaf, w, g)
    loss, _aux = loss_fn(params, batch)
    loss.backward()
    return loss.detach(), tree_norm(g)


@torch.no_grad()
def _sgd_update(w, mom, g, cfg: MAvgConfig, lr: float):
    """Update math in f32, stored back in the learner dtype, in place.
    ``w``/``mom``/``g`` are planes (packed) or trees of leaves."""
    if cfg.local_momentum > 0.0:
        mu_l = f32(cfg.local_momentum)
        tree_map(
            lambda m, gi: m.copy_(
                (mu_l * m.to(torch.float32) - lr * gi.to(torch.float32))
                .to(m.dtype)
            ),
            mom, g,
        )
        tree_map(lambda wi, m: wi.add_(m.to(wi.dtype)), w, mom)
    else:
        tree_map(lambda wi, gi: kops.sgd_apply(wi, gi, lr, out=wi), w, g)


def _local_phase(loss_fn: LossFn, learners, local_mom, batches,
                 cfg: MAvgConfig, lr: float, spec: Optional[PackSpec] = None):
    """batches: dict of (L, K, B_local, ...) tensors.

    Updates ``learners`` (and ``local_mom``) in place and returns
    (learners, local_mom, mean loss, mean grad-norm, per-learner mean
    loss (L,)).
    """
    L, K = cfg.num_learners, cfg.k_steps
    if spec is not None:
        # one gradient plane for the whole phase; its padding stays zero
        grad_plane = torch.zeros_like(learners[0])
        grads = spec.unpack(grad_plane)

        def learner(j):
            # (model-tree views, update target, momentum, gradient)
            return (spec.unpack(learners[j]), learners[j],
                    None if local_mom is None else local_mom[j], grad_plane)
    else:
        grads = tree_map(lambda x: torch.zeros_like(x[0]), learners)

        def learner(j):
            w = tree_map(lambda x: x[j], learners)
            m = (None if local_mom is None
                 else tree_map(lambda x: x[j], local_mom))
            return w, w, m, grads

    losses, gnorms = [], []
    for j in range(L):
        w_tree, w_upd, mom, g_upd = learner(j)
        if mom is None and cfg.local_momentum > 0.0:
            mom = tree_map(torch.zeros_like, w_upd)  # not carried over
        for k in range(K):
            batch = {key: val[j, k] for key, val in batches.items()}
            loss, gnorm = _grad_into(loss_fn, w_tree, batch, grads)
            _sgd_update(w_upd, mom, g_upd, cfg, lr)
            losses.append(loss)
            gnorms.append(gnorm)
    loss_l = torch.stack(losses).view(L, K).mean(dim=1)
    gnorm = torch.stack(gnorms).view(L, K).mean(dim=1).mean()
    return learners, local_mom, loss_l.mean(), gnorm, loss_l


# ---------------------------------------------------------------------------
# meta updates
# ---------------------------------------------------------------------------


def meta_step(state: MetaState, batches, *, loss_fn: LossFn,
              cfg: MAvgConfig, lr=None, reducer=None,
              topology=None) -> tuple[MetaState, dict]:
    """One meta-iteration n -> n+1 of Algorithm 1 (or a baseline).

    batches: dict of (L, K, B_local, ...) tensors on the state's device.
    ``lr`` overrides ``cfg.learner_lr`` (a schedule's value). The input
    state is updated in place and returned; do not reuse it.
    """
    lr = f32(cfg.learner_lr if lr is None else lr)
    if topology is None:
        from repro_torch.topology import make_topology

        topology = make_topology(cfg, reducer)
    # profiler ranges named as the JAX step's named scopes
    with torch.profiler.record_function("obs.local_phase"):
        learners, local_mom, loss, gnorm, loss_l = _local_phase(
            loss_fn, state.learners, state.local_momentum, batches, cfg, lr,
            spec=state.spec,
        )
    metrics = {
        "loss": loss,
        "grad_norm": gnorm,
        "loss_spread": loss_l.max() - loss_l.min(),
    }
    with torch.no_grad(), torch.profiler.record_function("obs.meta_mix"):
        gp, v, learners, comm_res, topo, topo_metrics = topology.mix(
            learners, state.global_params, state.momentum,
            state.comm_residual, state.topo, step=state.step,
        )
    metrics.update(topo_metrics)
    if state.spec is not None:
        # the reducer counted the packed plane's padding as payload;
        # report the real parameter bytes, as the JAX step does
        f = sum(state.spec.sizes) / state.spec.total
        for k in list(metrics):
            if k.startswith("comm_bytes"):
                metrics[k] = metrics[k] * f
    state = MetaState(
        global_params=gp, momentum=v, learners=learners,
        local_momentum=local_mom, step=state.step + 1,
        comm_residual=comm_res, topo=topo, spec=state.spec,
    )
    return state, metrics


def make_meta_step(loss_fn: LossFn, cfg: MAvgConfig, reducer=None,
                   topology=None):
    """``step(state, batches, lr=None) -> (state, metrics)`` with the
    topology (and its reducer, and the effective mu) resolved once."""
    if topology is None:
        from repro_torch.topology import make_topology

        topology = make_topology(cfg, reducer)
    return partial(meta_step, loss_fn=loss_fn, cfg=cfg, topology=topology)
