"""Two-level M-AVG: learners partitioned into G groups (the JAX package's
``topology/hierarchical.py``).

Each meta step averages within each group (the inner level, block
momentum mu_in = MAvgConfig.momentum on the group params); every H meta
steps the group params are averaged across groups (the outer level, block
momentum mu_out = TopologyConfig.outer_momentum on the global params, unit
step). Each level has its own Reducer, so the cross-group displacement can
ship compressed while intra-group stays dense.

State (``MetaState.topo``):
    group_params    w~_g (G, ...) meta dtype
    group_momentum  v_g  (G, ...)
    inner_residual  per-group error-feedback stacks (G, S, ...) or None
    outer_residual  cross-group EF residual (G, ...) or None
    membership      (period, L) elastic schedule on the host, when on

Heterogeneous K (``group_k``): group g runs only its first K_g local
steps (``local_steps``); uniform group_k is scalar K bit for bit.

Robust aggregation (``repro_torch.robust``): each learner is scored and
norm-clipped against its own group's params before the inner level, and
the robust estimator replaces the mean in the static inner reducers (at
group width S) and in the outer one (at G, where the trim clamps to
(G - 1) // 2). The masked elastic inner level averages the present
learners with the plain mean, as JAX's does.

Where the port differs from JAX in execution, not in math: the groups are
a Python loop where JAX vmaps them (every group asks the dither for the
same (leaf, step) uniforms, as JAX's vmap hands every group one key), the
outer level is a Python branch on the host step where JAX uses
``lax.cond``, and the group and learner planes are updated in place. On
the packed plane the outer update is one launch of the fused
momentum-broadcast kernel with the G group planes as its "learners" in
the meta dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import DenseReducer, dense_bytes, make_reducer_for
from repro_torch.configs.base import MAvgConfig
from repro_torch.topology.base import (
    Topology,
    block_momentum_update,
    consensus_dist,
    effective_momentum,
    fused_momentum_broadcast_update,
    is_packed_plane,
    robust_aggregate,
    stack_dist,
)
from repro_torch.topology.elastic import (
    absent_index,
    freeze_rows,
    membership_at,
    membership_schedule,
    restore_rows,
)
from repro_torch.topology.gossip import compress_stack
from repro_torch.utils.tree import tree_cast, tree_map, tree_norm


def _part(tree, i):
    """Entry ``i`` along the leading axis of every leaf (None passes)."""
    return None if tree is None else tree_map(lambda x: x[i], tree)


def _put(tree, i, value):
    """Write ``value`` into entry ``i`` of every leaf, unless it already
    lies there (a reducer that wrote in place)."""
    def put(dst, src):
        if dst[i].data_ptr() != src.data_ptr():
            dst[i].copy_(src)

    tree_map(put, tree, value)


def _learner_rows(tree):
    """(G, S, ...) leaves viewed as (G * S, ...) (None passes)."""
    if tree is None:
        return None
    return tree_map(lambda x: x.view((-1,) + tuple(x.shape[2:])), tree)


def masked_mean(tree, m, n_present):
    """Mean over the present rows of (S, ...) leaves in f32: the JAX masked
    inner average sum(x * m) / n, where an absent row adds x * 0 = 0. Only
    the present rows are summed, one after another into one f32 plane
    (all rows: ``torch.sum``, as x * 1 == x), and divided in place, so no
    (S, ...) product is formed."""
    keep = torch.nonzero(torch.as_tensor(m)).flatten().tolist()

    def mean(x):
        if len(keep) == x.shape[0]:
            total = torch.sum(x.to(torch.float32), dim=0)
        else:
            total = x[keep[0]].to(torch.float32, copy=True)
            for k in keep[1:]:
                total.add_(x[k])
        return total.div_(torch.full((), max(n_present, 1.0),
                                     dtype=torch.float32,
                                     device=total.device))

    return tree_map(mean, tree)


class Hierarchical(Topology):
    name = "hierarchical"

    def __init__(self, cfg: MAvgConfig, reducer=None, dither=None):
        t = cfg.topology
        assert cfg.num_learners % t.groups == 0, (cfg.num_learners, t.groups)
        self.cfg = cfg
        self.G = t.groups
        self.S = cfg.num_learners // t.groups
        self.H = t.outer_every
        self.mu_in = effective_momentum(cfg)
        self.mu_out = t.outer_momentum
        self.group_k = t.group_k
        self.elastic = t.elastic
        # per-learner base local-step counts: group g runs K_g of K
        self._base_steps = (
            np.repeat(np.asarray(t.group_k, np.int64), self.S)
            if t.group_k is not None
            else np.full((cfg.num_learners,), cfg.k_steps, np.int64)
        )
        from repro_torch.robust import make_robust

        self.robust = make_robust(cfg)
        agg = robust_aggregate(self.robust)
        self.inner_reducer = (
            reducer if reducer is not None
            else make_reducer_for(t.inner_comm or cfg.comm, cfg.meta_dtype,
                                  dither=dither, aggregate=agg)
        )
        self.outer_reducer = make_reducer_for(
            t.outer_comm or cfg.comm, cfg.meta_dtype, dither=dither,
            aggregate=agg)

    # ------------------------------------------------------------------
    def init_buffers(self, gp, cfg: MAvgConfig):
        G = self.G
        meta_dt = getattr(torch, cfg.meta_dtype)
        gparams = tree_map(
            lambda x: x.to(meta_dt).unsqueeze(0)
            .expand((G,) + tuple(x.shape)).clone(), gp)
        inner_res = self.inner_reducer.init_residual(gp, self.S)
        if inner_res is not None:  # stack the per-group EF residuals
            inner_res = tree_map(
                lambda x: torch.zeros((G,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device), inner_res)
        topo = {
            "group_params": gparams,
            "group_momentum": tree_map(torch.zeros_like, gparams),
            "inner_residual": inner_res,
            "outer_residual": self.outer_reducer.init_residual(gp, G),
        }
        if self.elastic is not None:
            topo["membership"] = torch.from_numpy(membership_schedule(
                cfg.num_learners, self.elastic, groups=G))
        return None, topo

    # ------------------------------------------------------------------
    def local_steps(self, topo, step):
        if self.group_k is None and self.elastic is None:
            return None
        base = self._base_steps
        if self.elastic is not None:
            m = membership_at(topo["membership"], step).numpy()
            base = base * m.astype(np.int64)
        return [int(k) for k in base]

    # ------------------------------------------------------------------
    def _inner_static(self, grouped, gparams, inner_res, avg, step):
        """Each group's reducer average into ``avg[g]``; the reducers
        keep each group's EF residual. Returns (intra bytes, dense)."""
        intra = dense = 0.0
        for g in range(self.G):
            a, r, m = self.inner_reducer.reduce(
                _part(grouped, g), _part(gparams, g), _part(inner_res, g),
                step=step)
            _put(avg, g, a)
            if r is not None:
                _put(inner_res, g, r)
            intra += m["comm_bytes"]
            dense += m["comm_bytes_dense"]
        return intra, dense

    def _inner_masked(self, grouped, gparams, inner_res, avg, mask, step):
        """The membership-masked inner average: present learners only.
        Absent learners ran no local steps, ship nothing, and keep their
        EF residual. Returns (intra bytes, dense, present per group)."""
        G, S = self.G, self.S
        present = [float(mask[g].sum()) for g in range(G)]
        # the schedules keep one learner of every group present, so every
        # group takes its inner update (JAX's group mask is all true)
        assert min(present) > 0, present
        dense = isinstance(self.inner_reducer, DenseReducer)
        idx = absent_index(mask.reshape(-1))
        flat_res = _learner_rows(inner_res)
        frozen = freeze_rows(flat_res, idx)
        if not dense:
            # delta = w - g, in the learner stack when it is f32 (it is
            # reset below)
            delta = tree_map(
                lambda w, gg: (
                    w.sub_(gg.to(torch.float32).unsqueeze(1))
                    if w.dtype == torch.float32
                    else w.to(torch.float32)
                    - gg.to(torch.float32).unsqueeze(1)),
                grouped, gparams)
        wire_sum = 0.0
        for g in range(G):
            m_g, n = mask[g], present[g]
            if dense:
                # the mean of the weights (not gp + mean(delta)), as the
                # static dense reducer, so all-present is bitwise static
                a = masked_mean(_part(grouped, g), m_g, n)
                wire = dense_bytes(_part(grouped, g))
            else:
                c, r, wire = compress_stack(
                    self.inner_reducer, _part(delta, g), _part(inner_res, g),
                    step=step, learners=_part(grouped, g))
                a = tree_map(lambda gg, mm: mm.add_(gg.to(torch.float32)),
                             _part(gparams, g), masked_mean(c, m_g, n))
                if r is not None:
                    _put(inner_res, g, r)
                del c
            _put(avg, g, a)
            # free this group's C and mean before the next group draws its
            # dither
            del a
            wire_sum += wire * n
        restore_rows(flat_res, idx, frozen)
        # wire scales with who actually showed up this step
        intra = wire_sum / S
        intra_dense = (dense_bytes(grouped) / G) * sum(present) / S
        return intra, intra_dense, present

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        cfg = self.cfg
        G, S = self.G, self.S
        meta_dt = getattr(torch, cfg.meta_dtype)
        gparams = topo["group_params"]
        gmom = topo["group_momentum"]
        inner_res = topo["inner_residual"]
        rmetrics = {}
        if self.robust is not None:
            # score and clip each learner against its own group's params
            # before the inner reducers: the inner wire and EF residual
            # only see clipped payloads
            learners, topo, rmetrics = self.robust.clip_anchored(
                learners, gparams, topo)

        # ---- inner level: per-group average + block momentum ----------
        grouped = tree_map(
            lambda x: x.view((G, S) + tuple(x.shape[1:])), learners)
        avg = tree_map(torch.empty_like, gparams)  # in the meta dtype
        present = None
        if self.elastic is None:
            intra_bytes, intra_dense = self._inner_static(
                grouped, gparams, inner_res, avg, step)
        else:
            mask = membership_at(topo["membership"], step).reshape(G, S)
            intra_bytes, intra_dense, present = self._inner_masked(
                grouped, gparams, inner_res, avg, mask, step)
        inner_disp = stack_dist(avg, gparams)
        gparams, gmom = block_momentum_update(
            gparams, gmom, avg, mu=self.mu_in, eta=cfg.meta_lr,
            nesterov=cfg.nesterov)
        del avg

        # ---- outer level: cross-group average + block momentum, every H
        fire = (int(step) + 1) % self.H == 0
        outer_res = topo["outer_residual"]
        outer_bytes = outer_dense = 0.0
        if fire:
            A, outer_res, om = self.outer_reducer.reduce(
                gparams, gp, outer_res, step=step)
            A = tree_cast(A, meta_dt)
            outer_bytes = om["comm_bytes"]
            outer_dense = dense_bytes(gparams)
            if is_packed_plane(gp):
                # the group planes are the outer level's "learners": the
                # update writes their reset in the same pass
                gp, v, gparams = fused_momentum_broadcast_update(
                    gp, v, A, gparams, mu=self.mu_out, eta=1.0,
                    nesterov=False)
            else:
                gp, v = block_momentum_update(gp, v, A, mu=self.mu_out,
                                              eta=1.0, nesterov=False)
                tree_map(lambda gg, w: gg.copy_(w.unsqueeze(0).expand_as(gg)),
                         gparams, gp)

        # ---- reset learners to their group's params ---------------------
        tree_map(lambda w, gg: w.copy_(gg.unsqueeze(1).expand_as(w)),
                 grouped, gparams)

        topo = dict(topo, group_params=gparams, group_momentum=gmom,
                    inner_residual=inner_res, outer_residual=outer_res)
        total_bytes = intra_bytes + outer_bytes
        total_dense = intra_dense + outer_dense
        metrics = {
            "v_norm": tree_norm(v),
            "group_v_norm": tree_norm(gmom),
            "displacement_norm": inner_disp,
            # cross-group consensus: how far the group params drifted from
            # their mean between outer averages
            "consensus_dist": consensus_dist(gparams, tree_map(
                lambda x: torch.mean(x, dim=0), gparams)),
            "outer_fired": float(fire),
            "comm_bytes_intra": intra_bytes,
            "comm_bytes_inter": outer_bytes,
            "comm_bytes": total_bytes,
            "comm_bytes_dense": total_dense,
            "comm_compression": (total_dense / max(total_bytes, 1.0)
                                 if total_bytes > 0 else 1.0),
        }
        metrics.update(rmetrics)
        if present is not None:
            metrics["present_count"] = float(sum(present))
        return gp, v, learners, comm_residual, topo, metrics
