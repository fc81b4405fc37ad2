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
  gradient plane is alive at a time. Where the topology masks trailing
  local steps (per-group K_g, elastic membership), JAX computes and
  discards them inside its static scan; the port skips them, which gives
  the same learners, and averages loss and grad-norm over the active
  steps as JAX does.
* Under ``cfg.packed`` (the default) each learner's parameters are views
  of its slice of the (L, rows, 128) learner plane. Autograd accumulates
  each local step's gradient into one (rows, 128) gradient plane whose
  padding stays zero, and one launch of the SGD-apply kernel updates the
  learner's plane in place.
* The meta mix updates w~, v and the learner plane in place (one launch
  of the fused momentum-broadcast kernel). ``meta_step`` therefore
  consumes its input state, as the JAX step consumes a donated one: work
  off the returned state only.
* The payload corruptor (``chaos``) and the finite guard
  (``cfg.finite_guard``) also work in place, one learner plane at a time:
  the corruptor scales and bit-flips the dirty learners' planes, and the
  guard checks each learner for NaN/Inf in windows and resets only the
  learners that carry one.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.planes import f32, windows
from repro_torch.pack import PackSpec, make_pack_spec
from repro_torch.utils.tree import (
    tree_broadcast_learners,
    tree_cast,
    tree_leaves,
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
    if cfg.robust is not None and cfg.robust.clip_mult > 0.0:
        # the norm clip's trailing-median ring rides in MetaState.topo on
        # every topology, only when clipping is on
        from repro_torch.robust import robust_ring_buffers

        topo = {**(topo or {}), **robust_ring_buffers(cfg.robust)}
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
                 cfg: MAvgConfig, lr: float, spec: Optional[PackSpec] = None,
                 steps=None):
    """batches: dict of (L, K, B_local, ...) tensors. ``steps``: None, or
    the L active local-step counts: learner j runs only its first
    ``steps[j]`` of the K steps (an absent learner runs none).

    Updates ``learners`` (and ``local_mom``) in place and returns
    (learners, local_mom, mean loss, mean grad-norm, per-learner mean
    loss (L,), active learners (L,) bool or None). Under ``steps`` the
    means are over the active steps, and an inactive learner's mean loss
    is 0.
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

    counts = [K] * L if steps is None else [int(s) for s in steps]
    losses, gnorms = [], []
    for j in range(L):
        w_tree, w_upd, mom, g_upd = learner(j)
        if mom is None and cfg.local_momentum > 0.0:
            mom = tree_map(torch.zeros_like, w_upd)  # not carried over
        for k in range(counts[j]):
            batch = {key: val[j, k] for key, val in batches.items()}
            loss, gnorm = _grad_into(loss_fn, w_tree, batch, grads)
            _sgd_update(w_upd, mom, g_upd, cfg, lr)
            losses.append(loss)
            gnorms.append(gnorm)
    if spec is not None:
        # JAX repacks every learner after its local steps, which writes
        # zero padding; the port trains the plane in place. The padding
        # is nonzero only where a corrupted payload reached it through the
        # mean (repro_torch.chaos), and is cleared here as JAX clears it.
        with torch.no_grad():
            spec.zero_padding_(learners)
    if steps is None:
        loss_l = torch.stack(losses).view(L, K).mean(dim=1)
        gnorm = torch.stack(gnorms).view(L, K).mean(dim=1).mean()
        return learners, local_mom, loss_l.mean(), gnorm, loss_l, None
    # sums over the active steps over their count (JAX
    # core/meta.py:268-273); an inactive learner reports loss 0, and a
    # tick on which no learner runs (the async server's warmup) reports 0
    if not losses:
        zero = torch.zeros((), device=tree_leaves(learners)[0].device)
        return (learners, local_mom, zero, zero.clone(),
                torch.zeros((L,), device=zero.device),
                torch.zeros((L,), dtype=torch.bool))
    losses, gnorms = torch.stack(losses), torch.stack(gnorms)
    active = max(sum(counts), 1)
    per = torch.split(losses, counts)
    loss_l = torch.stack([x.sum() / max(n, 1) for x, n in zip(per, counts)])
    return (learners, local_mom, losses.sum() / active,
            gnorms.sum() / active, loss_l,
            torch.tensor([n > 0 for n in counts]))


def _loss_spread(loss_l, active):
    """max - min of the per-learner mean losses over the active learners
    (0 when none is active)."""
    if active is None:
        return loss_l.max() - loss_l.min()
    if not bool(active.any()):  # the mask lies on the host
        return torch.zeros((), dtype=loss_l.dtype, device=loss_l.device)
    on = active.to(loss_l.device)
    return (torch.where(on, loss_l, float("-inf")).max()
            - torch.where(on, loss_l, float("inf")).min())


# ---------------------------------------------------------------------------
# the in-step finite guard (DESIGN.md §13)
# ---------------------------------------------------------------------------

def _learner_finite_mask(tree) -> list[bool] | None:
    """Per learner j, True where every float element of its planes is
    finite; None when the tree has no float leaves. One plane and one
    window at a time, and one read back to the host for all learners."""
    leaves = [x for x in tree_leaves(tree) if x.is_floating_point()]
    if not leaves:
        return None
    L = leaves[0].shape[0]
    flags = []
    for j in range(L):
        ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
        for x in leaves:
            xj = x[j].reshape(-1)
            for sl in windows(xj.numel()):
                ok &= torch.isfinite(xj[sl]).all()
        flags.append(ok)
    return torch.stack(flags).tolist()


def _finite_guard(learners, local_mom, gp, metrics, L):
    """The in-step skip-and-decay barrier: a learner whose post-local-phase
    planes (or local momentum) carry NaN/Inf is reset to the global params
    in the learner dtype, so it adds zero displacement to the mix, and its
    local momentum is zeroed. Only those learners are written: on a clean
    step nothing is (JAX's ``where`` over an all-true mask, bitwise)."""
    ok = _learner_finite_mask(learners)
    if local_mom is not None:
        mok = _learner_finite_mask(local_mom)
        if mok is not None:
            ok = mok if ok is None else [a and b for a, b in zip(ok, mok)]
    if ok is None:
        return learners, local_mom, metrics
    for j in (j for j, good in enumerate(ok) if not good):
        tree_map(lambda w, g: w[j].copy_(g), learners, gp)
        if local_mom is not None:
            tree_map(lambda m: m[j].zero_(), local_mom)
    metrics["nonfinite_learners"] = torch.tensor(float(L - sum(ok)),
                                                 dtype=torch.float32)
    return learners, local_mom, metrics


# ---------------------------------------------------------------------------
# meta updates
# ---------------------------------------------------------------------------


def meta_step(state: MetaState, batches, *, loss_fn: LossFn,
              cfg: MAvgConfig, lr=None, reducer=None, topology=None,
              chaos=None) -> tuple[MetaState, dict]:
    """One meta-iteration n -> n+1 of Algorithm 1 (or a baseline).

    batches: dict of (L, K, B_local, ...) tensors on the state's device.
    ``lr`` overrides ``cfg.learner_lr`` (a schedule's value). ``chaos``: an
    optional payload corruptor (``chaos.PayloadCorruptor``) applied to the
    post-local-phase learner planes, where the reducer picks the payload
    up; ``cfg.finite_guard`` then screens the (possibly corrupted) planes
    before the mix. The input state is updated in place and returned; do
    not reuse it.
    """
    lr = f32(cfg.learner_lr if lr is None else lr)
    if topology is None:
        from repro_torch.topology import make_topology

        topology = make_topology(cfg, reducer)
    # the topology may mask trailing local steps per learner (per-group
    # K_g, elastic membership)
    steps = topology.local_steps(state.topo, state.step)
    # profiler ranges named as the JAX step's named scopes
    with torch.profiler.record_function("obs.local_phase"):
        learners, local_mom, loss, gnorm, loss_l, active = _local_phase(
            loss_fn, state.learners, state.local_momentum, batches, cfg, lr,
            spec=state.spec, steps=steps,
        )
    metrics = {
        "loss": loss,
        "grad_norm": gnorm,
        "loss_spread": _loss_spread(loss_l, active),
    }
    with torch.no_grad():
        if chaos is not None:
            with torch.profiler.record_function("chaos.payload"):
                learners = chaos(learners, state.step)
        if cfg.finite_guard:
            with torch.profiler.record_function("chaos.finite_guard"):
                learners, local_mom, metrics = _finite_guard(
                    learners, local_mom, state.global_params, metrics,
                    cfg.num_learners)
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
                   topology=None, chaos=None):
    """``step(state, batches, lr=None) -> (state, metrics)`` with the
    topology (and its reducer, and the effective mu) and the payload
    corruptor ``chaos`` (or None) resolved once."""
    if topology is None:
        from repro_torch.topology import make_topology

        topology = make_topology(cfg, reducer)
    return partial(meta_step, loss_fn=loss_fn, cfg=cfg, topology=topology,
                   chaos=chaos)
