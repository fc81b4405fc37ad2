"""The Topology protocol: who averages with whom, how often.

    mix(learners, gp, v, comm_residual, topo, step=n)
        -> (gp', v', learners', comm_residual', topo', metrics)

``topo`` is the topology's own buffers in ``MetaState.topo`` (None for
flat). This module holds the protocol and the flat all-reduce: the
reducer's average over all L learners (the dense mean, or a compressed
one with its error-feedback residual, ``repro_torch.comm``), then the
block-momentum update and the reset of every learner to the new meta
params. On the packed plane that update is ONE launch of the fused
momentum-broadcast kernel, in place: w~ and v are overwritten, and the
learner plane (already consumed by the reducer) receives the reset. With
robust aggregation on (``repro_torch.robust``) the learners are scored
and norm-clipped against w~ first, and the reducer's mean becomes the
robust estimator. The hierarchical and gossip topologies and the async
server live beside it (``hierarchical.py``, ``gossip.py``, ``elastic.py``,
``async_server.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.kernels import ops as kops
# the packed-plane predicate lives with the kernels it routes to; the
# topologies import it from here, as in the JAX package
from repro_torch.kernels.planes import is_packed_plane
from repro_torch.utils.tree import (
    sq_sum,
    tree_cast,
    tree_leaves,
    tree_map,
    tree_norm,
)


def effective_momentum(cfg: MAvgConfig) -> float:
    """mu actually applied by the meta update: kavg is mavg with mu = 0."""
    return 0.0 if cfg.algorithm == "kavg" else cfg.momentum


def learner_dtype(learners) -> torch.dtype:
    return tree_leaves(learners)[0].dtype


def block_momentum_update(gp, v, avg, *, mu, eta=1.0, nesterov=False):
    """v <- mu v + eta d ; w~ <- w~ + v (+ Nesterov lookahead), leaf by
    leaf through the block-momentum kernel (its plain version on CPU).
    Packed planes and stacks of them, as the (G, rows, 128) group and
    (L, rows, 128) gossip planes, are updated in place."""
    return kops.block_momentum_tree(gp, v, avg, mu=mu, eta=eta,
                                    nesterov=nesterov)


def fused_momentum_broadcast_update(gp, v, avg, learners, *, mu, eta,
                                    nesterov=False):
    """The packed plane's whole meta update in one kernel launch, in
    place: ``gp`` <- w~', ``v`` <- v', and every plane of ``learners``
    <- w~' in the learners' dtype. Returns (gp, v, learners)."""
    return kops.fused_momentum_broadcast(
        gp, v, avg, mu=mu, eta=eta, num_learners=learners.shape[0],
        ldtype=learners.dtype, nesterov=nesterov, w_out=gp, v_out=v,
        learners_out=learners,
    )


def stack_dist(a, b) -> torch.Tensor:
    """||a - b|| over two (lead, ...) trees, one entry of the leading axis
    at a time, so the (f32) temporary is one plane and never a stack."""
    sq = [sq_sum(x[j] - y[j])
          for x, y in zip(tree_leaves(a), tree_leaves(b))
          for j in range(x.shape[0])]
    return torch.sqrt(torch.stack(sq).sum()).to(torch.float32)


def consensus_dist(learners, avg) -> torch.Tensor:
    """||w_j - a|| over all learners: how far the K local steps drove
    them apart."""
    return stack_dist(learners, tree_map(
        lambda w, a: a.unsqueeze(0).expand(w.shape), learners, avg))


def displacement_norm(avg, gp) -> torch.Tensor:
    return torch.sqrt(torch.stack([
        sq_sum(a - g) for a, g in zip(tree_leaves(avg), tree_leaves(gp))
    ]).sum()).to(torch.float32)


def robust_aggregate(robust):
    """The reducers' ``aggregate`` hook of a RobustAggregator (or None):
    set only when its estimator replaces the mean."""
    if robust is None or not robust.aggregates:
        return None
    return robust.aggregate


class Topology:
    """Base: one meta-level mixing step over the learner stack."""

    name = "topology"

    def init_buffers(self, gp, cfg: MAvgConfig) -> tuple[Any, Any]:
        """(comm_residual, topo) buffers for MetaState (None = unused)."""
        return None, None

    def work_completed(self, step) -> int:
        """Cumulative K-step blocks completed through meta step ``step``."""
        return (int(step) + 1) * self.cfg.num_learners

    def local_steps(self, topo, step):
        """Per-learner active local-step counts (L ints) for this meta
        step, or None when every learner runs the full cfg.k_steps.
        Per-group K_g (hierarchical ``group_k``) and elastic membership
        (absent learners run zero steps) hook in here."""
        return None

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        raise NotImplementedError


class FlatAllReduce(Topology):
    """One global average + block momentum + learner reset."""

    name = "flat"

    def __init__(self, cfg: MAvgConfig, reducer=None, dither=None):
        from repro_torch.comm import make_reducer
        from repro_torch.robust import make_robust

        self.cfg = cfg
        self.mu = effective_momentum(cfg)
        self.robust = make_robust(cfg)
        self.reducer = (
            make_reducer(cfg, dither=dither,
                         aggregate=robust_aggregate(self.robust))
            if reducer is None else reducer)

    def init_buffers(self, gp, cfg: MAvgConfig):
        return self.reducer.init_residual(gp, cfg.num_learners), None

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        cfg = self.cfg
        metrics = {}
        if self.robust is not None:
            # score and clip the displacements BEFORE the reducer: the
            # wire compressor and the EF residual only see the clipped ones
            learners, topo, rmetrics = self.robust.clip_learners(
                learners, gp, topo)
            metrics.update(rmetrics)
        avg, comm_residual, comm_metrics = self.reducer.reduce(
            learners, gp, comm_residual, step=step
        )
        gp, v, learners = self._update(learners, gp, v, avg, metrics)
        metrics.update(comm_metrics)
        return gp, v, learners, comm_residual, topo, metrics

    # the telemetry norms of the local planes; one rank of a mesh sums
    # them over the ranks (``sharding/placed.py``)
    def _consensus(self, learners, avg):
        return consensus_dist(learners, avg)

    def _displacement(self, avg, gp):
        return displacement_norm(avg, gp)

    def _v_norm(self, v):
        return tree_norm(v)

    def _update(self, learners, gp, v, avg, metrics):
        """The block-momentum update by the average ``avg`` and the learner
        reset, in place, with the telemetry norms written into
        ``metrics``; returns (gp, v, learners)."""
        cfg = self.cfg
        avg = tree_cast(avg, getattr(torch, cfg.meta_dtype))
        # both telemetry norms read the pre-update planes, so they are
        # taken before the in-place update below overwrites them
        metrics["consensus_dist"] = self._consensus(learners, avg)
        metrics["displacement_norm"] = self._displacement(avg, gp)
        if is_packed_plane(gp):
            gp, v, learners = fused_momentum_broadcast_update(
                gp, v, avg, learners, mu=self.mu, eta=cfg.meta_lr,
                nesterov=cfg.nesterov,
            )
        else:
            gp, v = block_momentum_update(
                gp, v, avg, mu=self.mu, eta=cfg.meta_lr,
                nesterov=cfg.nesterov,
            )
            ldt = learner_dtype(learners)
            # learner reset in place: every learner's copy <- w~'
            tree_map(lambda w, g: w.copy_(g.to(ldt).expand_as(w)),
                     learners, gp)
        metrics["v_norm"] = self._v_norm(v)
        return gp, v, learners
