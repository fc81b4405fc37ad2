"""Decentralized gossip: sparse doubly-stochastic mixing, no global state
(the JAX package's ``topology/gossip.py``).

Every learner keeps its own meta params x_j and mixes with its graph
neighbors each meta step. Per meta step, after the K local steps produce
w_j from x_j:

    delta_j = w_j - x_j            (+ EF residual)
    m_j     = sum_k W_jk (x_k + C(delta_k))     -- the gossip exchange
    v_j     = mu v_j + eta (m_j - x_j)          [then v <- W v if tracking]
    x_j    += v_j ; learner j resets to x_j

Robust aggregation (``repro_torch.robust``): gossip has no L-way mean to
replace, so its influence bound is the per-learner clip of delta (in
place, before compression: the neighbors and the EF residual only see
the clipped payload) plus the anomaly scores; the estimator is unused.

State (``MetaState.topo``): ``params`` x (L, ...) and ``momentum`` v
(L, ...) in the meta dtype, ``residual`` (the EF residual, or None) and,
under elastic membership, the (period, L) ``membership`` schedule on the
host. ``MetaState.global_params`` is the mean of x.

The mixing matrices are numpy, as in JAX, and stay on the host: the step
is a Python int, so W_t, its elastic mask and its spectral gap are
computed on the CPU and W travels to the kernel by value.

In place. At full width the state is already 2 + 4L planes; JAX's
functional ``mix`` would add several (L, rows, 128) stacks. The port
reuses dead buffers instead: delta is formed in the learner stack (reset
at the end of the step), with error feedback the residual receives
delta + e and then the new residual, the quantizer writes C(delta) over
its dither, x + C(delta) is formed there and mixed in place, x and v are
updated in place, and absent learners' rows are saved before and written
back after. Each value ends where JAX's ``mix`` puts it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import (
    CompressedReducer,
    DenseReducer,
    ErrorFeedback,
    dense_bytes,
    make_reducer_for,
)
from repro_torch.configs.base import MAvgConfig
from repro_torch.kernels import ops as kops
from repro_torch.topology.base import (
    Topology,
    block_momentum_update,
    consensus_dist,
    effective_momentum,
    learner_dtype,
    stack_dist,
)
from repro_torch.topology.elastic import (
    absent_index,
    freeze_rows,
    mask_mixing_matrix,
    membership_at,
    membership_schedule,
    present_edge_count,
    restore_rows,
)
from repro_torch.utils.tree import tree_map, tree_norm

# ---------------------------------------------------------------------------
# mixing matrices (all symmetric -> doubly stochastic; one_peer_exponential
# is time-varying with period ceil(log2 L)); numpy, as in the JAX package
# ---------------------------------------------------------------------------


def mixing_period(graph: str, L: int) -> int:
    """Number of distinct step-indexed matrices before the graph repeats
    (1 for the static graphs)."""
    if graph != "one_peer_exponential" or L <= 2:
        return 1
    return max(1, int(np.ceil(np.log2(L))))


def _neighbor_offsets(graph: str, L: int, step: int = 0) -> set[int]:
    if L <= 1:
        return set()
    if graph == "complete":
        return set(range(1, L))
    if graph == "ring":
        return {1 % L, (L - 1) % L} - {0}
    if graph == "exponential":
        offs = set()
        p = 1
        while p < L:
            offs.add(p)
            offs.add((L - p) % L)
            p *= 2
        return offs - {0}
    if graph == "one_peer_exponential":
        # step t keeps only the +/- 2^(t mod period) offsets of the
        # exponential graph
        o = 1 << (step % mixing_period(graph, L))
        return {o % L, (L - o) % L} - {0}
    raise ValueError(f"unknown gossip graph {graph!r}")


def mixing_matrix(graph: str, L: int, step: int = 0) -> np.ndarray:
    """(L, L) symmetric doubly-stochastic W with uniform edge weights
    1/(deg+1) over self + graph neighbors, at meta step ``step``.
    ``one_peer_exponential`` with L a power of two is the XOR perfect
    matching j <-> j ^ 2^(step mod period), weight 1/2."""
    if graph == "one_peer_exponential" and L > 1 and (L & (L - 1)) == 0:
        o = 1 << (step % mixing_period(graph, L))
        W = np.zeros((L, L), np.float32)
        for j in range(L):
            W[j, j] += 0.5
            W[j, j ^ o] += 0.5
        return W
    offs = _neighbor_offsets(graph, L, step)
    w = 1.0 / (len(offs) + 1)
    W = np.zeros((L, L), np.float32)
    for j in range(L):
        W[j, j] = w
        for o in offs:
            W[j, (j + o) % L] += w
    return W


def mixing_matrix_stack(graph: str, L: int) -> np.ndarray:
    """(period, L, L) stack of the step-indexed matrices."""
    return np.stack(
        [mixing_matrix(graph, L, t) for t in range(mixing_period(graph, L))]
    )


def graph_degree(graph: str, L: int, step: int = 0) -> int:
    """Out-degree (neighbors excluding self) at ``step``."""
    return int((mixing_matrix(graph, L, step)[0] > 0).sum()) - 1


def avg_graph_degree(graph: str, L: int) -> float:
    """Mean out-degree over one period (the degree-over-time wire model)."""
    T = mixing_period(graph, L)
    return sum(graph_degree(graph, L, t) for t in range(T)) / T


def spectral_gap(W, mask=None) -> float:
    """1 - |lambda_2| of a symmetric doubly-stochastic W, on the host in
    f32 (``torch.linalg.eigvalsh``). ``mask``: the (L,) present mask of an
    elastic-masked W; absent learners' identity rows are deflated to
    eigenvalue 0, leaving the gap of the present-subset mixing block."""
    W = torch.as_tensor(W, dtype=torch.float32)
    if W.shape[0] < 2:
        return 1.0
    if mask is not None:
        W = W - torch.diag(1.0 - torch.as_tensor(mask, dtype=torch.float32))
    lam = torch.sort(torch.abs(torch.linalg.eigvalsh(W))).values
    return float(1.0 - lam[-2])


# ---------------------------------------------------------------------------
# per-learner compression (the reducer's compress stage without the mean)
# ---------------------------------------------------------------------------


def compress_stack(reducer, delta, residual, *, step, learners):
    """C(delta_j) per learner + EF residual algebra, without averaging.
    Returns (c, residual', wire_bytes).

    ``delta`` is consumed. Under error feedback the residual buffer
    receives delta + e (e + delta, bitwise the same sum), which the packed
    quantizer then overwrites with the new residual; the packed quantizer
    writes c over its dither.
    """
    if isinstance(reducer, ErrorFeedback):
        if residual is None:
            raise ValueError(
                "ErrorFeedback gossip reducer got residual=None — build the "
                "MetaState with the same topology (init_state allocates the "
                "residual in MetaState.topo)."
            )
        delta = tree_map(lambda e, d: e.add_(d), residual, delta)
        return reducer.inner._compress_residual(delta, step)
    if isinstance(reducer, CompressedReducer):
        c, wire = reducer._compress(delta, step)
        return c, residual, wire
    assert isinstance(reducer, DenseReducer), reducer
    return delta, residual, dense_bytes(learners)


class Gossip(Topology):
    name = "gossip"

    def __init__(self, cfg: MAvgConfig, reducer=None, dither=None):
        t = cfg.topology
        self.cfg = cfg
        self.mu = effective_momentum(cfg)
        self.momentum_tracking = t.momentum_tracking
        self.elastic = t.elastic
        from repro_torch.robust import make_robust

        self.robust = make_robust(cfg)
        self.reducer = (
            reducer if reducer is not None
            else make_reducer_for(t.inner_comm or cfg.comm, cfg.meta_dtype,
                                  dither=dither)
        )
        self.period = mixing_period(t.graph, cfg.num_learners)
        self.W_stack = mixing_matrix_stack(t.graph, cfg.num_learners)
        # per-step-matrix gaps of the static schedule; elastic masks take
        # the gap of the step's masked matrix
        self.gap_stack = [spectral_gap(W) for W in self.W_stack]

    # ------------------------------------------------------------------
    def init_buffers(self, gp, cfg: MAvgConfig):
        L = cfg.num_learners
        meta_dt = getattr(torch, cfg.meta_dtype)
        params = tree_map(
            lambda x: x.to(meta_dt).unsqueeze(0)
            .expand((L,) + tuple(x.shape)).clone(), gp)
        topo = {
            "params": params,
            "momentum": tree_map(torch.zeros_like, params),
            "residual": self.reducer.init_residual(gp, L),
        }
        if self.elastic is not None:
            topo["membership"] = torch.from_numpy(
                membership_schedule(L, self.elastic))
        return None, topo

    # ------------------------------------------------------------------
    def local_steps(self, topo, step):
        if self.elastic is None:
            return None
        m = membership_at(topo["membership"], step)
        return [int(self.cfg.k_steps * float(x)) for x in m]

    # ------------------------------------------------------------------
    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        cfg = self.cfg
        L = cfg.num_learners
        meta_dt = getattr(torch, cfg.meta_dtype)
        ldt = learner_dtype(learners)
        xp, vL, res = topo["params"], topo["momentum"], topo["residual"]

        W = kops.mixing_matrix_at(self.W_stack, step)
        mask = idx = None
        # the time-varying static schedule goes through the stepped
        # kernel entry; a masked matrix is the step's own
        mix_w, mix_step = ((self.W_stack, step) if self.period > 1
                           else (W, None))
        if self.elastic is not None:
            mask = membership_at(topo["membership"], step)
            W = mask_mixing_matrix(W, mask)
            mix_w, mix_step = W, None
            idx = absent_index(mask)
        # absent learners keep params, momentum and residual as they were
        frozen = {k: freeze_rows(topo[k], idx)
                  for k in ("params", "momentum", "residual")}

        # delta_j = w_j - x_j, in the learner stack when it is f32 (it is
        # overwritten by the reset below)
        delta = tree_map(
            lambda w, x: (w.sub_(x.to(torch.float32))
                          if w.dtype == torch.float32
                          else w.to(torch.float32) - x.to(torch.float32)),
            learners, xp)
        rmetrics = {}
        if self.robust is not None:
            delta, topo, rmetrics = self.robust.clip_stack(delta, topo)
        c, res, wire = compress_stack(self.reducer, delta, res, step=step,
                                      learners=learners)
        # x + C(delta) in C's buffer (the sum commutes bitwise), mixed in
        # place
        x_hat = tree_map(lambda ci, x: ci.add_(x.to(torch.float32)), c, xp)
        mixed = kops.neighbor_mix_tree(x_hat, mix_w, step=mix_step,
                                       in_place=True)
        mixed = tree_map(lambda m: m.to(meta_dt), mixed)
        disp = stack_dist(mixed, xp)

        xp, vL = block_momentum_update(xp, vL, mixed, mu=self.mu,
                                       eta=cfg.meta_lr,
                                       nesterov=cfg.nesterov)
        if self.momentum_tracking:
            # mix the momentum buffers with the same W so the momentum
            # consensus follows the param one
            vL = kops.neighbor_mix_tree(vL, mix_w, step=mix_step,
                                        in_place=True)
        xp = restore_rows(xp, idx, frozen["params"])
        vL = restore_rows(vL, idx, frozen["momentum"])
        res = restore_rows(res, idx, frozen["residual"])

        learners = tree_map(lambda w, x: w.copy_(x.to(ldt)), learners, xp)
        gp_new = tree_map(lambda g, x: torch.mean(x, dim=0, out=g), gp, xp)

        db = dense_bytes(learners)
        topo = dict(topo, params=xp, momentum=vL, residual=res)
        edges = present_edge_count(W, torch.ones(L) if mask is None
                                   else mask)
        comm_bytes = (wire / L) * edges
        comm_dense = (db / L) * edges
        gap = (spectral_gap(W, mask) if mask is not None
               else self.gap_stack[step % self.period])
        metrics = {
            "v_norm": tree_norm(vL),
            "displacement_norm": disp,
            "consensus_dist": consensus_dist(xp, gp_new),
            "mixing_spectral_gap": gap,
            "comm_bytes": comm_bytes,
            "comm_bytes_dense": comm_dense,
            "comm_compression": (comm_dense / max(comm_bytes, 1.0)
                                 if comm_bytes > 0 else 1.0),
        }
        metrics.update(rmetrics)
        if mask is not None:
            metrics["present_count"] = float(mask.sum())
        return gp_new, v, learners, comm_residual, topo, metrics
