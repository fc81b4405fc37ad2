"""The Topology protocol: who averages with whom, how often.

    mix(learners, gp, v, comm_residual, topo, step=n)
        -> (gp', v', learners', comm_residual', topo', metrics)

Only the flat all-reduce is ported: the reducer's average over all L
learners (the dense mean, or a compressed one with its error-feedback
residual, ``repro_torch.comm``), then the block-momentum update and the
reset of every learner to the new meta params. On the packed plane that
update is ONE launch of the fused momentum-broadcast kernel, in place:
w~ and v are overwritten, and the learner plane (already consumed by the
reducer) receives the reset.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.planes import is_packed_plane
from repro_torch.utils.tree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_norm,
)


def effective_momentum(cfg: MAvgConfig) -> float:
    """mu actually applied by the meta update: kavg is mavg with mu = 0."""
    return 0.0 if cfg.algorithm == "kavg" else cfg.momentum


def block_momentum_update(gp, v, avg, *, mu, eta=1.0, nesterov=False):
    """v <- mu v + eta d ; w~ <- w~ + v (+ Nesterov lookahead), leaf by
    leaf through the block-momentum kernel (its plain version on CPU)."""
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


def consensus_dist(learners, avg) -> torch.Tensor:
    """||w_j - a|| over all learners: how far the K local steps drove
    them apart. One learner at a time, so the f32 temporary is one plane."""
    sq = [
        torch.linalg.vector_norm(w[j].to(torch.float32) - a) ** 2
        for w, a in zip(tree_leaves(learners), tree_leaves(avg))
        for j in range(w.shape[0])
    ]
    return torch.sqrt(torch.stack(sq).sum())


def displacement_norm(avg, gp) -> torch.Tensor:
    return torch.sqrt(torch.stack([
        torch.linalg.vector_norm(a - g) ** 2
        for a, g in zip(tree_leaves(avg), tree_leaves(gp))
    ]).sum())


class Topology:
    """Base: one meta-level mixing step over the learner stack."""

    name = "topology"

    def init_buffers(self, gp, cfg: MAvgConfig) -> tuple[Any, Any]:
        """(comm_residual, topo) buffers for MetaState (None = unused)."""
        return None, None

    def work_completed(self, step) -> int:
        """Cumulative K-step blocks completed through meta step ``step``."""
        return (int(step) + 1) * self.cfg.num_learners

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        raise NotImplementedError


class FlatAllReduce(Topology):
    """One global average + block momentum + learner reset."""

    name = "flat"

    def __init__(self, cfg: MAvgConfig, reducer=None):
        from repro_torch.comm import make_reducer

        self.cfg = cfg
        self.mu = effective_momentum(cfg)
        self.reducer = make_reducer(cfg) if reducer is None else reducer

    def init_buffers(self, gp, cfg: MAvgConfig):
        return self.reducer.init_residual(gp, cfg.num_learners), None

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        cfg = self.cfg
        avg, comm_residual, comm_metrics = self.reducer.reduce(
            learners, gp, comm_residual, step=step
        )
        avg = tree_cast(avg, getattr(torch, cfg.meta_dtype))
        # both telemetry norms read the pre-update planes, so they are
        # taken before the in-place update below overwrites them
        metrics = {
            "consensus_dist": consensus_dist(learners, avg),
            "displacement_norm": displacement_norm(avg, gp),
        }
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
            ldt = tree_leaves(learners)[0].dtype
            # learner reset in place: every learner's copy <- w~'
            tree_map(lambda w, g: w.copy_(g.to(ldt).expand_as(w)),
                     learners, gp)
        metrics["v_norm"] = tree_norm(v)
        metrics.update(comm_metrics)
        return gp, v, learners, comm_residual, topo, metrics
