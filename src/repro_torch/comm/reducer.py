"""The Reducer protocol: how the meta average crosses the wire.

    reduce(learners, gp, residual, step=n) -> (avg, residual', metrics)

``learners`` is the stacked (L, ...) learner tree (or the packed
(L, rows, 128) plane), ``gp`` the meta params w~. Only the dense scheme is
ported: the exact mean over L. It is a plain ``torch.mean(dim=0)`` — a
reduction the JAX package leaves to XLA, not a Pallas kernel — taken in
the learner dtype and cast to the meta dtype, as JAX does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_cast, tree_leaves, tree_mean_axis0


def dense_bytes(learners) -> float:
    """Wire payload of the uncompressed meta average: every learner ships
    its full displacement at the learner dtype width."""
    return float(sum(x.numel() * x.element_size()
                     for x in tree_leaves(learners)))


class Reducer:
    """Base: reduce the learner stack to one averaged parameter tree."""

    name = "reducer"

    def init_residual(self, gp, num_learners: int):
        """Error-feedback state for MetaState.comm_residual (None = off)."""
        return None

    def reduce(self, learners, gp, residual, *, step) -> tuple[Any, Any, dict]:
        raise NotImplementedError


class DenseReducer(Reducer):
    """a = mean_j w_j, full precision."""

    name = "dense"

    def __init__(self, meta_dtype: str = "float32"):
        self.meta_dtype = meta_dtype

    def reduce(self, learners, gp, residual, *, step):
        avg = tree_cast(tree_mean_axis0(learners),
                        getattr(torch, self.meta_dtype))
        b = dense_bytes(learners)
        metrics = {
            "comm_bytes": b,
            "comm_bytes_dense": b,
            "comm_compression": 1.0,
        }
        return avg, residual, metrics


def make_reducer(cfg) -> Reducer:
    """Build the reducer described by ``cfg.comm`` (an MAvgConfig)."""
    if cfg.comm.scheme != "dense":
        raise NotImplementedError(
            f"comm scheme {cfg.comm.scheme!r} is not ported yet (ROADMAP "
            f"Queue 1, item 5: repro.comm)"
        )
    return DenseReducer(meta_dtype=cfg.meta_dtype)
