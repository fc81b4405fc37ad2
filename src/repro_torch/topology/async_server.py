"""The async bounded-staleness meta server (the JAX package's
``topology/async_server.py``, DESIGN.md §12).

Every other topology barriers all live learners every K local steps.
This one retires the barrier: each learner pushes its displacement when
*it* finishes a K-step block and pulls the current w~ without waiting for
anyone. When each learner reaches its K is a deterministic schedule:

  * ``AsyncConfig.step_time[j]`` is learner j's cost of one K-step block
    in meta ticks (one tick = one meta step = the fastest learner's
    block). Learner j fires (pushes and pulls) on the ticks where its
    clock fills, and runs its K local steps only on those ticks.
  * Clocks start at ``-(j mod step_time[j])`` so pushes de-phase; a
    learner leaving its start lag pulls the current center at block start
    (it has computed nothing yet), so its first block obeys the same
    staleness bound as every later one.
  * Staleness tau_j = center updates between learner j's last pull and
    this push (``topo["updates"]`` minus ``topo["pull_update"][j]``),
    bounded by construction: tau_j <= step_time[j] - 1 <= staleness.
  * A fired displacement is weighted by ``decay**tau`` (default: the
    block momentum mu) under one of two update rules: ``mavg``
    (staleness-decayed block momentum on the mean of the ready
    displacements, each measured against the center its learner pulled,
    kept in ``topo["anchor"]``) or ``elastic`` (EASGD's force toward the
    current center; firing learners relax toward the new center instead
    of taking it).

The legacy ``eamsgd`` and ``downpour`` algorithms are aliases onto this
server (``resolve_async_config``). A uniform all-ones profile with the
mavg update is the synchronous degenerate case: ``mix`` delegates to
``FlatAllReduce``, bitwise. Elastic membership composes: an absent
learner neither fires nor refreshes, and its clock keeps filling.

Where the port differs from JAX in execution, not in math:

* The clocks (``clock``, ``pull_update``: (L,) int32; ``updates``: 0-d
  int32) live on the host, as the membership schedule and the robust
  ring do: the fire mask, the local-step counts, tau, the decay weights
  and the staleness metrics are host numbers and never read the card.
  ``decay**tau`` is taken in numpy float32 (``np.power``); JAX takes
  ``jnp.power`` on the device, and the two may differ by an ulp, so the
  trajectories agree to rounding (rtol 1e-5), not bitwise. The staleness
  p99 is ``numpy.nanpercentile`` (linear), as ``jnp.nanpercentile``.
* JAX forms (L, rows, 128) temporaries (the displacement stack, its
  weighted copy, the broadcast center). The port loops over windows of
  ``planes.WINDOW`` values and, in each, over the learners: the weighted
  f32 displacements accumulate into one f64 window (each sum of L f32
  values is exact there), rounded into ONE f32 plane; the momentum and
  center update in place window by window, and the fresh center is
  written into the fired and refreshed learners' slots and anchors. At
  full width the state is 2 + 2L planes (w~, v, the learners, the
  anchors) plus that accumulator. The exact sum does not depend on the
  order of the learners, so one rank of a mesh adds its own learners and
  one all-reduce of the f64 window completes the sum
  (``sharding/placed.py``), one process's bitwise. JAX sums in f32; the
  two agree to rounding.
* As in JAX, every learner enters the sum, a learner that does not fire
  with weight 0. 0 * NaN is NaN, so a non-finite learner that is still
  computing poisons the center on a tick it does not fire, unless the
  finite guard (``MAvgConfig.finite_guard``) reset it first (ROADMAP,
  "Departures of the reference").
* The robust clip scores the displacements from the Gram matrix of
  ``RobustAggregator.guard`` (windowed, never the stack) and scales a
  clipped learner's displacement as it is accumulated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm import dense_bytes
from repro_torch.configs.base import AsyncConfig, MAvgConfig
from repro_torch.kernels.planes import f32, windows
from repro_torch.topology.base import (
    FlatAllReduce,
    Topology,
    consensus_dist,
    effective_momentum,
    learner_dtype,
    robust_aggregate,
)
from repro_torch.topology.elastic import membership_at, membership_schedule
from repro_torch.utils.tree import (
    sq_sum,
    tree_broadcast_learners,
    tree_leaves,
    tree_map,
    tree_norm,
)


def resolve_async_config(cfg: MAvgConfig) -> AsyncConfig:
    """The AsyncConfig an MAvgConfig means, including the legacy aliases.

    eamsgd  -> elastic update, uniform profile, tau=0 (synchronous EASGD)
    downpour-> mavg update, decay 1.0 (stale displacements at full
               weight), uniform staleness+1-tick profile: the de-phased
               clocks give every push staleness ~min(L-1, tau) and hold
               the center for the first tau ticks (the legacy warmup)
    """
    explicit = cfg.topology.server
    if cfg.algorithm == "eamsgd":
        base = explicit if explicit is not None else AsyncConfig()
        return dataclasses.replace(
            base, update="elastic",
            elastic_alpha=(base.elastic_alpha if base.elastic_alpha
                           is not None else cfg.elastic_alpha),
        )
    if cfg.algorithm == "downpour":
        if explicit is not None:
            return explicit
        return AsyncConfig(
            staleness=cfg.staleness,
            step_time=(cfg.staleness + 1,) * cfg.num_learners,
            update="mavg", decay=1.0,
        )
    return explicit if explicit is not None else AsyncConfig()


def step_time_profile(L: int, acfg: AsyncConfig) -> np.ndarray:
    """(L,) int32 ticks-per-K-block profile, deterministic in the config.

    An explicit ``step_time`` wins; otherwise ``skew`` spreads {1..skew}
    evenly over the learners and a seeded permutation assigns the slots.
    """
    if acfg.step_time:
        assert len(acfg.step_time) == L, (acfg.step_time, L)
        return np.asarray(acfg.step_time, np.int32)
    if acfg.skew <= 1:
        return np.ones((L,), np.int32)
    prof = np.rint(np.linspace(1.0, float(acfg.skew), L)).astype(np.int32)
    rng = np.random.RandomState(acfg.seed)
    return prof[rng.permutation(L)]


def _ints(x) -> np.ndarray:
    """A host int32 topo buffer (the clocks and stamps) as numpy."""
    return np.asarray(x, np.int32)


class AsyncServer(Topology):
    """Push-when-ready / pull-without-waiting with bounded staleness."""

    name = "async"

    def __init__(self, cfg: MAvgConfig, reducer=None, dither=None):
        from repro_torch.comm import make_reducer
        from repro_torch.robust import make_robust

        self.cfg = cfg
        self.acfg = resolve_async_config(cfg)
        self.mu = effective_momentum(cfg)
        self.decay = self.acfg.decay if self.acfg.decay is not None else self.mu
        self.alpha = (self.acfg.elastic_alpha
                      if self.acfg.elastic_alpha is not None
                      else cfg.elastic_alpha)
        # the clip and the anomaly scores bound each learner's anchor
        # displacement every tick; the trimmed/median estimator applies
        # only in the degenerate case, where an L-way mean exists
        self.robust = make_robust(cfg)
        self.reducer = (
            make_reducer(cfg, dither=dither,
                         aggregate=robust_aggregate(self.robust))
            if reducer is None else reducer)
        self.profile = step_time_profile(cfg.num_learners, self.acfg)
        # de-phased start clocks: learner j first fires at tick
        # profile[j] - 1 + (j mod profile[j])
        self.start_clock = (
            -(np.arange(cfg.num_learners) % self.profile)).astype(np.int32)
        elastic = cfg.topology.elastic
        self.membership = (membership_schedule(cfg.num_learners, elastic)
                           if elastic is not None else None)
        # everyone fires every tick with staleness 0: FlatAllReduce's
        # arithmetic, bitwise
        self.degenerate = (self.acfg.update == "mavg"
                           and bool((self.profile == 1).all())
                           and self.membership is None)
        self._flat = FlatAllReduce(cfg, self.reducer)
        # host replay of the clock recurrence for work_completed()
        self._sim_clock = self.start_clock.copy()
        self._sim_t = 0
        self._sim_cum: list[int] = []

    # -- buffers -----------------------------------------------------------

    def init_buffers(self, gp, cfg: MAvgConfig):
        L = cfg.num_learners
        topo = {
            "clock": torch.from_numpy(self.start_clock.copy()),
            "pull_update": torch.zeros((L,), dtype=torch.int32),
            "updates": torch.zeros((), dtype=torch.int32),
            # the center each learner last pulled (meta dtype): the base
            # its pending displacement is measured against
            "anchor": tree_broadcast_learners(gp, L),
        }
        if self.membership is not None:
            topo["membership"] = torch.from_numpy(self.membership.copy())
        return self.reducer.init_residual(gp, L), topo

    # -- clock hooks -------------------------------------------------------

    def _fire(self, topo, step) -> np.ndarray:
        fire = (_ints(topo["clock"]) + 1) >= self.profile
        if "membership" in topo:
            fire &= np.asarray(membership_at(topo["membership"], step)) > 0
        return fire

    def fire_mask(self, topo, step) -> torch.Tensor:
        """(L,) bool on the host: which learners complete a K-step block
        this tick."""
        return torch.from_numpy(self._fire(topo, step))

    def local_steps(self, topo, step):
        if self.degenerate:
            return None
        k = self.cfg.k_steps
        return [k if f else 0 for f in self._fire(topo, step)]

    def work_completed(self, step) -> int:
        """Cumulative K-step blocks completed through meta step ``step``
        (host replay of the deterministic clock recurrence)."""
        n = int(step) + 1
        while self._sim_t < n:
            fire = (self._sim_clock + 1) >= self.profile
            if self.membership is not None:
                t = self._sim_t % self.membership.shape[0]
                fire = fire & (self.membership[t] > 0)
            prev = self._sim_cum[-1] if self._sim_cum else 0
            self._sim_cum.append(prev + int(fire.sum()))
            self._sim_clock = np.where(fire, 0, self._sim_clock + 1)
            self._sim_t += 1
        return self._sim_cum[n - 1] if n >= 1 else 0

    # -- the meta phase ----------------------------------------------------

    def _degenerate_mix(self, learners, gp, v, comm_residual, topo, step):
        L = self.cfg.num_learners
        # the async topo dict rides through the flat delegate, so its
        # robust clip ring (when on) advances and survives
        gp, v, learners, comm_residual, topo2, metrics = self._flat.mix(
            learners, gp, v, comm_residual, topo, step=step)
        tree_map(lambda a, g: a.copy_(g.unsqueeze(0).expand_as(a)),
                 topo["anchor"], gp)
        u = int(topo["updates"]) + 1
        topo = dict(topo2,
                    clock=torch.zeros((L,), dtype=torch.int32),
                    pull_update=torch.full((L,), u, dtype=torch.int32),
                    updates=torch.tensor(u, dtype=torch.int32),
                    anchor=topo["anchor"])
        metrics.update({
            "stale_norm": metrics["displacement_norm"],
            "staleness_mean": 0.0,
            "staleness_max": 0.0,
            "staleness_p99": 0.0,
            "fired_count": float(L),
        })
        return gp, v, learners, comm_residual, topo, metrics

    # what one rank of a mesh changes (``sharding/placed.py``): its stack
    # holds learners from ``_first_learner`` on, each f64 window of the
    # displacement sum is completed over the ranks, the telemetry norms
    # and the guard's Gram matrix are summed over them, and the wire bytes
    # are the whole stack's
    def _first_learner(self) -> int:
        return 0

    def _complete_sum(self, a64):
        return a64

    def _stack_norm(self, x):
        return x

    def _plane_norm(self, x):
        return x

    def _plane_sum(self, sq):
        return sq

    def _dense_bytes(self, learners) -> float:
        return dense_bytes(learners)

    def _guard(self, learners, topo, base):
        return self.robust.guard(learners, topo, anchor=base)

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        if self.degenerate:
            return self._degenerate_mix(learners, gp, v, comm_residual,
                                        topo, step)
        cfg = self.cfg
        L = cfg.num_learners
        mavg = self.acfg.update == "mavg"
        fire = self._fire(topo, step)
        n_fired = int(fire.sum())
        anyf = n_fired > 0
        u0 = int(topo["updates"])
        tau = np.maximum(u0 - _ints(topo["pull_update"]), 0).astype(
            np.float32)
        wgt = fire.astype(np.float32) * np.power(np.float32(self.decay), tau)
        ldt = learner_dtype(learners)

        # pre-update consensus: the stack's distance from the center
        consensus = self._stack_norm(consensus_dist(learners, gp))

        # the base each displacement is measured against: the anchor a
        # learner pulled (mavg) or the current center (elastic)
        base = (topo["anchor"] if mavg
                else tree_map(lambda g: g.unsqueeze(0), gp))
        rmetrics = {}
        scale = np.ones((L,), np.float32)
        if self.robust is not None:
            # scores and clip factors of every learner's displacement
            # (fired or not: the in-progress ones feed the scores and the
            # ring) before the staleness weighting
            s, topo, rmetrics = self._guard(learners, topo, base)
            scale = s.numpy().astype(np.float32)

        # sum_j decay^tau_j (w_j - base_j), one f32 plane a leaf, summed
        # exactly in f64 window by window; a learner that did not fire
        # enters with weight 0
        applied = []
        first = self._first_learner()
        for w, b in zip(tree_leaves(learners), tree_leaves(base)):
            acc = torch.empty(w.shape[1:], dtype=torch.float32,
                              device=w.device)
            a_flat = acc.view(-1)
            for sl in windows(a_flat.numel()):
                a64 = torch.zeros((sl.stop - sl.start,), dtype=torch.float64,
                                  device=w.device)
                for i in range(w.shape[0]):
                    j = first + i
                    wi = w[i].reshape(-1)
                    bi = b[i if b.shape[0] == w.shape[0] else 0].reshape(-1)
                    d = wi[sl].to(torch.float32) - bi[sl].to(torch.float32)
                    if scale[j] < 1.0:
                        d.mul_(float(scale[j]))
                    a64.add_(d.mul_(float(wgt[j])))
                a_flat[sl].copy_(self._complete_sum(a64))
                del a64
            if mavg:
                acc.div_(float(max(n_fired, 1)))
            applied.append(acc)

        # v <- mu v + c applied (c = eta, or alpha under elastic); the
        # center moves by v (Nesterov: mu v' + eta applied) only on ticks
        # with pushes: w~ <- w~ + gate * upd
        mu = f32(self.mu)
        c = f32(cfg.meta_lr if mavg else self.alpha)
        nesterov = mavg and cfg.nesterov
        gate = 1.0 if anyf else 0.0
        for g, vv, a in zip(tree_leaves(gp), tree_leaves(v), applied):
            gf, vf, af = g.view(-1), vv.view(-1), a.view(-1)
            for sl in windows(gf.numel()):
                v_new = mu * vf[sl] + c * af[sl]
                upd = mu * v_new + c * af[sl] if nesterov else v_new
                gf[sl].add_(upd * gate)
                if anyf:
                    vf[sl].copy_(v_new)

        # pull without waiting: firing learners take the fresh center
        # (mavg: hard reset; elastic: relax toward it) and re-anchor; a
        # learner whose clock just crossed 0 leaves its de-phased start
        # lag and pulls the center at block start (both rules)
        clock_new = np.where(fire, 0, _ints(topo["clock"]) + 1).astype(
            np.int32)
        refresh = (clock_new == 0) & ~fire
        if "membership" in topo:
            # an absent learner is frozen outright: it pulls nothing
            refresh &= np.asarray(membership_at(topo["membership"],
                                                step)) > 0
        alpha = f32(self.alpha)
        n_here = tree_leaves(learners)[0].shape[0]
        for j in np.nonzero(fire | refresh)[0].tolist():
            i = j - first  # this stack's entry of learner j
            if not 0 <= i < n_here:
                continue
            relax = bool(fire[j]) and not mavg
            for w, g, a in zip(tree_leaves(learners), tree_leaves(gp),
                               tree_leaves(topo["anchor"])):
                if relax:
                    wi, gi = w[i].view(-1), g.view(-1)
                    for sl in windows(wi.numel()):
                        d = wi[sl] - gi[sl].to(ldt)
                        wi[sl].sub_(d.mul_(alpha))
                else:
                    w[i].copy_(g.to(ldt))
                a[i].copy_(g)
        u_new = u0 + int(anyf)
        pull = np.where(fire | refresh, u_new, _ints(topo["pull_update"]))
        topo = dict(topo,
                    clock=torch.from_numpy(clock_new),
                    pull_update=torch.from_numpy(pull.astype(np.int32)),
                    updates=torch.tensor(u_new, dtype=torch.int32))

        # wire model: only the ready learners ship their (dense)
        # displacement plane this tick
        cb = self._dense_bytes(learners) / L * n_fired
        tau_fired = tau * fire.astype(np.float32)
        disp = torch.sqrt(self._plane_sum(torch.stack(
            [sq_sum(a) for a in applied]).sum())).to(torch.float32)
        metrics = {
            "v_norm": self._plane_norm(tree_norm(v)),
            "displacement_norm": disp,
            "stale_norm": disp,
            "consensus_dist": consensus,
            "staleness_mean": float(np.float32(tau_fired.sum())
                                    / np.float32(max(n_fired, 1))),
            "staleness_max": float(tau_fired.max()),
            "staleness_p99": (float(np.nanpercentile(
                np.where(fire, tau, np.nan), 99.0)) if anyf else 0.0),
            "fired_count": float(n_fired),
            "comm_bytes": cb,
            "comm_bytes_dense": cb,
            "comm_compression": 1.0,
        }
        metrics.update(rmetrics)
        return gp, v, learners, comm_residual, topo, metrics
