"""The Reducer protocol: how the meta average crosses the wire.

    reduce(learners, gp, residual, step=n) -> (avg, residual', metrics)

``learners`` is the stacked (L, ...) learner tree (or the packed
(L, rows, 128) plane), ``gp`` the meta params w~. The dense scheme is the
exact mean over L: a plain ``torch.mean(dim=0)``, a reduction the JAX
package leaves to XLA, taken in the learner dtype and cast to the meta
dtype, as JAX does. Compressed reducers work on the displacements
delta_j = w_j - w~ and return avg = w~ + mean_j C(delta_j). ``residual``
is the per-learner error-feedback memory e_j carried in
``MetaState.comm_residual`` (None when EF is off); the EF invariant is

    delta_j + e_j = C(delta_j + e_j) + e'_j      (exactly, per leaf)

Every reducer reports ``comm_bytes`` (modeled wire payload this step),
``comm_bytes_dense`` (what the dense scheme would ship) and
``comm_compression``; compressed ones also ``comm_error_norm``. The bytes
are analytic, as in the JAX package: one card ships nothing, but the
numerics of compression are real.

``aggregate`` is the robust aggregation hook (``repro_torch.robust``): a
callable that replaces the learner-stack mean (the trimmed mean or median
of the ``robust_reduce`` kernel). None, the default and the only value
when ``MAvgConfig.robust`` is off, keeps the exact mean. The packed int8
path of ``QuantReducer`` ignores it, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import (
    tree_add,
    tree_cast,
    tree_leaves,
    tree_map,
    tree_mean_axis0,
    tree_norm,
    tree_sub,
)


def dense_bytes(learners) -> float:
    """Wire payload of the uncompressed meta average: every learner ships
    its full displacement at the learner dtype width."""
    return float(sum(x.numel() * x.element_size()
                     for x in tree_leaves(learners)))


class Reducer:
    """Base: reduce the learner stack to one averaged parameter tree."""

    name = "reducer"
    aggregate = None  # the robust aggregation hook (see the module doc)

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
        mean = (tree_mean_axis0(learners) if self.aggregate is None
                else self.aggregate(learners))
        avg = tree_cast(mean, getattr(torch, self.meta_dtype))
        b = dense_bytes(learners)
        metrics = {
            "comm_bytes": b,
            "comm_bytes_dense": b,
            "comm_compression": 1.0,
        }
        return avg, residual, metrics


class CompressedReducer(Reducer):
    """Shared displacement/EF plumbing; subclasses supply ``_compress``."""

    def _compress(self, delta, step) -> tuple[Any, float]:
        """delta: (L, ...) f32 tree -> (decompressed C(delta), wire bytes)."""
        raise NotImplementedError

    def _compress_residual(self, delta, step) -> tuple[Any, Any, float]:
        """``_compress`` plus the compression error err = delta - C(delta):
        (c, err, wire bytes)."""
        c, wire = self._compress(delta, step)
        return c, tree_sub(delta, c), wire

    def reduce(self, learners, gp, residual, *, step):
        delta = tree_map(
            lambda w, g: w.to(torch.float32) - g.to(torch.float32)[None],
            learners, gp,
        )
        if residual is not None:
            delta = tree_add(delta, residual)
        c, wire = self._compress(delta, step)
        err = tree_sub(delta, c)  # quantization error: EF residual + metric
        if self.aggregate is not None:
            avg = tree_add(tree_cast(gp, torch.float32), self.aggregate(c))
        else:
            avg = tree_map(
                lambda g, ci: g.to(torch.float32) + torch.mean(ci, dim=0),
                gp, c)
        db = dense_bytes(learners)
        metrics = {
            "comm_bytes": wire,
            "comm_bytes_dense": db,
            "comm_compression": db / wire,
            "comm_error_norm": tree_norm(err),
        }
        return avg, (err if residual is not None else None), metrics


class ErrorFeedback(Reducer):
    """Wrapper carrying the compression residual e_j across meta steps.

    Supplies a non-None ``init_residual`` so ``MetaState.comm_residual``
    has a stable structure from step 0; the residual algebra itself lives
    in CompressedReducer.reduce, keyed on residual presence.
    """

    def __init__(self, inner: CompressedReducer):
        self.inner = inner

    @property
    def name(self):
        return f"ef+{self.inner.name}"

    def init_residual(self, gp, num_learners: int):
        return tree_map(
            lambda x: torch.zeros((num_learners,) + tuple(x.shape),
                                  dtype=torch.float32, device=x.device),
            gp,
        )

    def reduce(self, learners, gp, residual, *, step):
        if residual is None:
            raise ValueError(
                "ErrorFeedback.reduce got residual=None: the MetaState was "
                "built without this reducer's residual buffer. Pass the same "
                "reducer to init_state(params, cfg, reducer=...) that you "
                "inject into meta_step/make_meta_step."
            )
        return self.inner.reduce(learners, gp, residual, step=step)


def make_reducer(cfg, dither=None, aggregate=None) -> Reducer:
    """Build the reducer described by ``cfg.comm`` (an MAvgConfig).
    ``dither`` replaces the quantizers' default dither source (see
    ``comm.quant.QuantReducer``); ``aggregate`` installs the robust
    aggregation hook."""
    return make_reducer_for(cfg.comm, meta_dtype=cfg.meta_dtype,
                            dither=dither, aggregate=aggregate)


def make_reducer_for(c, meta_dtype: str = "float32", dither=None,
                     aggregate=None) -> Reducer:
    """Build a reducer from a bare ``CommConfig``, with the robust
    ``aggregate`` hook on the underlying reducer when given."""
    from repro_torch.comm.quant import QuantReducer
    from repro_torch.comm.topk import TopKReducer

    if c.scheme == "dense":
        r = DenseReducer(meta_dtype=meta_dtype)
        r.aggregate = aggregate
        return r
    # CommConfig.use_pallas plays no part: the tensor's device routes
    if c.scheme in ("int8", "fp8"):
        r = QuantReducer(dtype=c.scheme, chunk_rows=c.chunk_rows,
                         seed=c.seed, dither=dither)
    elif c.scheme == "topk":
        r = TopKReducer(k_frac=c.k_frac)
    elif c.scheme == "int8_topk":
        r = TopKReducer(k_frac=c.k_frac, quant_dtype="int8",
                        chunk_rows=c.chunk_rows, seed=c.seed, dither=dither)
    else:
        raise ValueError(f"unknown comm scheme {c.scheme!r}")
    r.aggregate = aggregate
    if c.error_feedback:
        return ErrorFeedback(r)
    return r


def uses_error_feedback(cfg) -> bool:
    """Does ``cfg`` (an MAvgConfig) carry an EF residual in
    ``MetaState.comm_residual``? Only the flat topology keeps its residual
    there; hierarchical and gossip carry theirs in ``MetaState.topo``
    (``inner_residual``/``outer_residual``, ``residual``)."""
    from repro_torch.configs.base import AVERAGING_ALGOS

    return (cfg.algorithm in AVERAGING_ALGOS
            and cfg.topology.kind == "flat"
            and cfg.comm.scheme != "dense" and cfg.comm.error_feedback)


def reducer_residual(params_or_gp, cfg):
    """comm_residual for init_state: None unless EF + a compressed scheme."""
    return make_reducer(cfg).init_residual(params_or_gp, cfg.num_learners)
