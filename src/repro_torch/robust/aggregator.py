"""Robust aggregation over the learner stack (the JAX package's
``robust/aggregator.py``, DESIGN.md §14).

* **Trimmed mean / median** (``aggregate``): coordinate-wise order
  statistics over the L axis replace the learner-stack mean inside the
  mean-based reducers, through the ``robust_reduce`` kernel (packed plane
  and per-leaf leaves alike). ``trim=0`` is bitwise the plain mean.
* **Norm clipping** (``guard``): each learner's displacement is scaled
  down to at most ``clip_mult x`` the median of a trailing ring of
  per-step median displacement norms. Clipped-away mass is rejected: the
  clip happens before the wire compressor, so it never enters the
  error-feedback residual.
* **Anomaly scores** (``anomaly_scores``): Krum-style nearest-neighbor
  distance sums from the (L, L) Gram matrix of the displacement stack.
  They feed the Trainer's inline quarantine.

Where the port differs from JAX in execution, not in math:

* The JAX guard forms the whole (L, ...) f32 displacement stack. At full
  width that is 27.5 GB beside 41.3 GB of state, more than one card
  holds. The port never forms it: ``gram`` takes the displacements
  d_j = w_j - a_j over windows of ``planes.WINDOW`` values of each
  learner (an (L, WINDOW) f32 window is 512 MB at L = 4) and
  accumulates the (L, L) Gram matrix of each window with one f64
  ``torch.matmul`` (the products of two f32 values are exact in f64),
  summed over the windows in f64 and rounded to f32 once (d^2 = G_jj +
  G_kk - 2 G_jk cancels, so the matrix is kept to its last bit). The
  f32 matrix then does not depend on how the sum is split: over the
  BLAS's blocks and threads, or over the ranks of a mesh, whose partial
  matrices are summed in f64 before the one rounding
  (``sharding/placed.py``). The per-learner norms are the square roots
  of its diagonal (JAX sums the squares apart; the two agree to
  rounding).
* The Gram matrix is read back to the host once per mix, and the ring,
  the medians, the budget, the clip factors and the scores are computed
  there in f32, in JAX's operation order. The ring buffers
  (``robust_ring``/``robust_count`` in ``MetaState.topo``) stay on the
  host, like the elastic membership schedule, so the clip's decision is
  a host branch.
* The clip writes in place, window by window, and only into the learners
  it scales: w_j <- a_j + s_j (w_j - a_j). Every other learner is left
  untouched, bit for bit, as JAX's ``where(s < 1, ...)`` leaves it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MAvgConfig, RobustConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.planes import f32, windows
from repro_torch.utils.tree import tree_leaves, tree_map

# every robust metric key the topologies emit starts with this; the
# Trainer repackages them out of the step records into ``robust`` records
ROBUST_METRIC_PREFIX = "robust_"

_EPS = 1e-12


def robust_ring_buffers(rcfg: RobustConfig) -> dict:
    """The trailing-median clip state merged into ``MetaState.topo`` by
    ``core.meta.init_state`` when clipping is on: a (clip_window,) f32 ring
    of per-step median displacement norms plus the int32 write cursor, on
    the host. No clipping fires until the ring has filled once."""
    return {
        "robust_ring": torch.zeros((rcfg.clip_window,), dtype=torch.float32),
        "robust_count": torch.zeros((), dtype=torch.int32),
    }


def _displacements(stack, anchor):
    """f32 (L, w) windows of d_j = w_j - a_{j // S} over every leaf of the
    (L, ...) ``stack``; ``anchor`` is None (the stack holds displacements
    already) or a tree of (A, ...) leaves, A dividing L."""
    anchors = [None] * len(tree_leaves(stack)) if anchor is None else (
        tree_leaves(anchor))
    for x, a in zip(tree_leaves(stack), anchors):
        L = x.shape[0]
        xf = x.reshape(L, -1)
        af = None if a is None else a.reshape(a.shape[0], -1)
        for sl in windows(xf.shape[1]):
            d = xf[:, sl].to(torch.float32)
            if af is None:
                yield d
            else:
                A = af.shape[0]
                w = sl.stop - sl.start
                yield (d.reshape(A, L // A, w)
                       - af[:, sl].to(torch.float32).unsqueeze(1)
                       ).reshape(L, w)


def gram64(stack, anchor=None) -> torch.Tensor:
    """The (L, L) f64 Gram matrix of the displacement stack (see
    ``_displacements``): each window's f32 displacements widened to f64,
    one f64 product a window, summed over windows and leaves on the
    stack's device."""
    G = None
    for d in _displacements(stack, anchor):
        d = d.to(torch.float64)
        g = d @ d.T
        G = g if G is None else G.add_(g)
    return G


def gram(stack, anchor=None, host: bool = True) -> torch.Tensor:
    """``gram64`` rounded to f32 once, returned on the host (left on the
    meta device when the step is costed, ``roofline.cost.jit_cost``; on
    the stack's device with ``host=False``)."""
    G = gram64(stack, anchor).to(torch.float32)
    if not host or G.device.type == "meta":  # costed: no host read
        return G
    return G.cpu()


def scores_from_gram(G: torch.Tensor, neighbors: int = 0) -> torch.Tensor:
    """Krum-style scores from the (L, L) Gram matrix: each learner's sum
    of its ``neighbors`` smallest non-self squared distances (0 = auto:
    L - 2), d^2_jk = G_jj + G_kk - 2 G_jk."""
    L = G.shape[0]
    sq = torch.diagonal(G)
    d2 = torch.maximum(sq[:, None] + sq[None, :] - 2.0 * G,
                       torch.zeros((), dtype=G.dtype, device=G.device))
    dev = G.device
    d2 = d2 + torch.where(torch.eye(L, dtype=torch.bool, device=dev),
                          torch.full((), float("inf"), device=dev),
                          torch.zeros((), device=dev))
    k = neighbors if neighbors > 0 else max(L - 2, 1)
    k = min(k, L - 1)
    return torch.sort(d2, dim=1).values[:, :k].sum(dim=1)


def anomaly_scores(delta, *, neighbors: int = 0) -> torch.Tensor:
    """Krum-style anomaly scores (L,) of an (L, ...) displacement stack:
    large = far from every cluster of peers = anomalous."""
    return scores_from_gram(gram(delta), neighbors)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-d f32 tensor: the mean of the two middle
    values, (lo + hi) * 0.5, and NaN if any value is NaN (a ``where`` on
    the tensor's device: no host read)."""
    s = torch.sort(x).values
    n = s.numel()
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(),
                       torch.full((), float("nan"), device=x.device), mid)


class RobustAggregator:
    """The per-topology robust hooks, built once by ``make_robust``."""

    def __init__(self, rcfg: RobustConfig, *, num_learners: int):
        self.cfg = rcfg
        self.num_learners = num_learners

    # -- trimmed mean / median -----------------------------------------
    @property
    def aggregates(self) -> bool:
        """Does the estimator replace the learner-stack mean (should the
        mean-based reducers get the ``aggregate`` hook)?"""
        return self.cfg.estimator != "mean"

    def trim_for(self, L: int) -> int:
        if self.cfg.estimator == "median":
            return kops.median_trim(L)
        if self.cfg.estimator == "trimmed":
            # an aggregation narrower than the config's width (the
            # hierarchical outer level over G groups) clamps to a valid
            # trim: (G - 1) // 2, 0 at G = 2
            return min(self.cfg.trim, (L - 1) // 2)
        return 0

    def aggregate(self, stacked):
        """Robust aggregate of a stacked (L, ...) tree: the drop-in for
        the learner-stack mean inside the reducers. f32 output."""
        L = tree_leaves(stacked)[0].shape[0]
        return kops.robust_reduce_tree(stacked, trim=self.trim_for(L))

    # -- norm clip + anomaly scores ------------------------------------
    @property
    def has_clip(self) -> bool:
        return self.cfg.clip_mult > 0.0

    def guard(self, stack, topo, anchor=None, gram_fn=None):
        """Score and clip factors of the displacements of ``stack`` from
        ``anchor`` (see ``_displacements``). ``gram_fn``: ``(stack,
        anchor) -> (L, L)`` Gram matrix on the host in place of ``gram``
        (the placed step's sum of every rank's partial Gram matrix; L then
        counts every rank's learners).

        Returns ``(scale, topo', metrics)``: ``scale`` is the (L,) f32
        per-learner clip factor on the host (1.0 = untouched), ``topo'``
        carries the advanced ring when clipping is on, and ``metrics``
        holds the ``robust_*`` scalars the Trainer repackages into
        ``robust`` records.
        """
        metrics = {}
        G = None
        if self.has_clip or self.cfg.score:
            G = (gram if gram_fn is None else gram_fn)(stack, anchor)
        L = tree_leaves(stack)[0].shape[0] if G is None else G.shape[0]
        scale = torch.ones((L,), dtype=torch.float32)
        if self.has_clip:
            norms = torch.sqrt(torch.diagonal(G))
            # the ring on the Gram matrix's device: the host, or meta
            # when costed
            ring = topo["robust_ring"].to(G.device)
            count = int(topo["robust_count"])
            W = self.cfg.clip_window
            full = count >= W
            budget = torch.tensor(f32(self.cfg.clip_mult)) * _median(ring)
            raw = torch.minimum(
                torch.ones(()),
                budget / torch.maximum(norms, torch.tensor(f32(_EPS))))
            if full:
                scale = raw
            ring = ring.clone()
            ring[count % W] = _median(norms)
            topo = {**topo, "robust_ring": ring,
                    "robust_count": torch.tensor(count + 1,
                                                 dtype=torch.int32)}
            metrics["robust_clipped_learners"] = (
                (scale < 1.0).sum().to(torch.float32))
            metrics["robust_clip_budget"] = (
                budget if full else torch.zeros(()))
        if self.cfg.score:
            scores = scores_from_gram(G, self.cfg.score_neighbors)
            metrics["robust_anomaly_score"] = scores.max()
            for j in range(L):
                metrics[f"robust_score_{j}"] = scores[j]
        metrics["robust_trim_fraction"] = torch.tensor(f32(
            2.0 * self.trim_for(self.num_learners) / self.num_learners))
        return scale, topo, metrics

    @staticmethod
    def _clipped(scale) -> list[tuple[int, float]]:
        """(learner, its f32 factor) of every learner the clip scales: a
        host read of the factors. A costed step (meta factors, no values)
        is counted as a clean one, where no learner is clipped and none
        is written (JAX's ``where`` writes every learner)."""
        if scale.device.type == "meta":
            return []
        return [(j, float(s)) for j, s in enumerate(scale.tolist())
                if s < 1.0]

    def clip_anchored(self, learners, anchor, topo):
        """The guard at the learner-weight level against a tree of (A, ...)
        anchors (flat: w~ with A = 1; hierarchical: the G group params,
        learner j anchored at group j // S). A learner whose displacement
        from its anchor exceeds the budget is pulled back to
        ``a + s (w - a)`` in place, BEFORE the reducer runs, so the wire
        compressor and the error-feedback residual only see the clipped
        displacement. Unclipped learners are not written.

        Returns (learners, topo', metrics).
        """
        scale, topo, metrics = self.guard(learners, topo, anchor=anchor)
        if self.has_clip:
            clip_rows(learners, anchor, self._clipped(scale))
        return learners, topo, metrics

    def clip_learners(self, learners, gp, topo):
        """``clip_anchored`` against the shared meta params w~ (the flat
        topology's anchor). Returns (learners, topo', metrics)."""
        return self.clip_anchored(
            learners, tree_map(lambda g: g.unsqueeze(0), gp), topo)

    def clip_stack(self, delta, topo):
        """The gossip guard on an already-formed (L, ...) displacement
        stack: over-budget rows are scaled down in place (in f32), the
        rest left untouched. Returns (delta', topo', metrics)."""
        delta = tree_map(lambda d: d.to(torch.float32), delta)
        scale, topo, metrics = self.guard(delta, topo)
        if self.has_clip:
            for j, s in self._clipped(scale):
                for d in tree_leaves(delta):
                    d[j].mul_(s)
        return delta, topo, metrics


def clip_rows(learners, anchor, clipped, offset: int = 0) -> None:
    """w_j <- a_j + s_j (w_j - a_j), in place, window by window, for each
    (learner j, factor s_j) of ``clipped`` (``RobustAggregator._clipped``)
    with ``offset <= j < offset + L`` (the stack's first learner is
    learner ``offset``; the placed step's rank holds L of them); learner
    j is anchored at entry ``j * A // L`` of the (A, ...) ``anchor``."""
    for j, s in clipped:
        for x, a in zip(tree_leaves(learners), tree_leaves(anchor)):
            if not 0 <= j - offset < x.shape[0]:
                continue
            xj = x[j - offset].reshape(-1)
            aj = a[(j - offset) * a.shape[0] // x.shape[0]].reshape(-1)
            for sl in windows(xj.numel()):
                af = aj[sl].to(torch.float32)
                d = xj[sl].to(torch.float32) - af
                xj[sl].copy_(d.mul_(s).add_(af))


def make_robust(cfg: MAvgConfig):
    """RobustAggregator for ``cfg.robust``, or None when the subsystem is
    off (the None keeps every other code path as it is)."""
    if cfg.robust is None:
        return None
    return RobustAggregator(cfg.robust, num_learners=cfg.num_learners)

