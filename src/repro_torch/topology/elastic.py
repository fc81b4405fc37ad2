"""Elastic learner membership: deterministic dropout/join schedules and
the masked, renormalized mixing algebra (the JAX package's
``topology/elastic.py``, DESIGN.md §8).

Membership is a deterministic (period, L) 0/1 schedule drawn once from a
seed and carried in ``MetaState.topo["membership"]``, so a resumed run
replays the same churn. An absent learner at meta step n runs zero local
steps, ships and receives nothing (its row and column of the mixing
matrix are masked), and keeps its params, momentum and error-feedback
residual frozen.

The port keeps the schedule, the masks and the (L, L) matrices on the
host (CPU tensors, f32): the step is a Python int, so the meta step
selects its row and masks its matrix without reading anything back from
the card. ``membership_schedule`` is the JAX code verbatim (numpy), so
the two packages draw the same schedules exactly.

``mask_mixing_matrix`` keeps the masked W doubly stochastic by re-wiring
around absent learners (the stochastic complement, Markov censoring of
the absent block)

    W'_pp = W_pp + W_pa (I - W_aa)^{-1} W_ap

with absent rows made identity rows. With an all-present mask the
correction is exactly zero and ``x * 1.0``, ``x + 0.0`` are exact, so the
masked matrix is W bit for bit and an all-present elastic run is bitwise
the static one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ElasticConfig
from repro_torch.utils.tree import tree_map


def membership_schedule(L: int, elastic: ElasticConfig, *,
                        groups: int = 1) -> np.ndarray:
    """(period, L) f32 0/1 mask, deterministic in ``elastic.seed``.

    Per scheduled step, ``round(drop_frac * L)`` learners are absent,
    chosen by seeded permutation subject to every group keeping at least
    one present member. An explicit ``elastic.schedule`` wins verbatim,
    under the same validation.
    """
    assert L >= 1 and L % groups == 0, (L, groups)
    S = L // groups
    if elastic.schedule is not None:
        sched = np.asarray(elastic.schedule, np.float32)
        assert sched.shape == (elastic.period, L), (
            f"explicit elastic schedule has shape {sched.shape}, expected "
            f"(period={elastic.period}, L={L})"
        )
        per_group = sched.reshape(elastic.period, groups, S).sum(axis=2)
        assert (per_group >= 1.0).all(), (
            "explicit elastic schedule leaves a group with no present "
            "learner in some row"
        )
        return sched
    rng = np.random.RandomState(elastic.seed)
    n_drop = min(int(round(elastic.drop_frac * L)), L - 1)
    sched = np.ones((elastic.period, L), np.float32)
    for t in range(elastic.period):
        dropped_per_group = [0] * groups
        dropped = []
        for j in rng.permutation(L):
            if len(dropped) == n_drop:
                break
            g = int(j) // S
            if dropped_per_group[g] < S - 1:  # keep >= 1 present per group
                dropped.append(int(j))
                dropped_per_group[g] += 1
        sched[t, dropped] = 0.0
    return sched


def membership_at(membership, step) -> torch.Tensor:
    """The (L,) mask of meta step ``step`` out of the (T, L) schedule."""
    return membership[int(step) % membership.shape[0]]


def mask_mixing_matrix(W, m) -> torch.Tensor:
    """Mask a symmetric doubly-stochastic (L, L) W by the (L,) 0/1 mask
    ``m``, on the host in f32: present rows re-wired through their absent
    neighbors (stochastic complement), absent rows identity rows. Bitwise
    W when every learner is present."""
    W = torch.as_tensor(W, dtype=torch.float32)
    m = torch.as_tensor(m, dtype=torch.float32)
    L = W.shape[0]
    a = 1.0 - m
    eye = torch.eye(L, dtype=W.dtype)
    W_pp = W * (m[:, None] * m[None, :])
    W_pa = W * (m[:, None] * a[None, :])
    W_ap = W * (a[:, None] * m[None, :])
    W_aa = W * (a[:, None] * a[None, :])
    # I - W_aa is the identity on present coordinates and I - W_aa on
    # absent ones: one full-size solve gives (I - W_aa)^{-1} W_ap embedded
    flow, info = torch.linalg.solve_ex(eye - W_aa, W_ap)
    if info != 0:
        # singular: some absent learners neighbour only each other (a
        # matched one-peer pair), so no flow reaches them from present
        # ones and the solve is singular on their block alone (JAX's
        # solve returns NaN there). The least-squares flow is the exact
        # one elsewhere, and their columns of W_pa are zero.
        flow = torch.linalg.lstsq(eye - W_aa, W_ap, driver="gelsd").solution
    # a product of nonnegative factors; the solve can leave -eps where an
    # entry is exactly zero
    correction = torch.maximum(W_pa @ flow, torch.zeros(()))
    return W_pp + correction + eye * a[:, None]


def present_edge_count(W, m) -> float:
    """Directed present-to-present edges of W (self loops excluded): the
    step's wire multiplier under churn."""
    W = torch.as_tensor(W, dtype=torch.float32)
    m = torch.as_tensor(m, dtype=torch.float32)
    L = W.shape[0]
    adj = (W > 0).to(torch.float32) * (1.0 - torch.eye(L))
    return float(torch.sum(adj * (m[:, None] * m[None, :])))


def absent_index(m) -> torch.Tensor | None:
    """Indices of the absent learners of the (L,) mask, or None when all
    are present."""
    idx = torch.nonzero(torch.as_tensor(m) == 0).flatten()
    return idx if idx.numel() else None


def freeze_rows(tree, idx):
    """Copies of rows ``idx`` of every (L, ...) leaf (None passes)."""
    if tree is None or idx is None:
        return None
    return tree_map(lambda x: x[idx.to(x.device)].clone(), tree)


def restore_rows(tree, idx, frozen):
    """Write the rows saved by ``freeze_rows`` back, in place: absent
    learners keep their pre-step values (``tree_where_mask`` of the JAX
    package, without forming the selection over the whole stack)."""
    if frozen is None:
        return tree
    return tree_map(lambda x, f: x.index_copy_(0, idx.to(x.device), f),
                    tree, frozen)


def tree_where_mask(m, new, old):
    """Leafwise ``where`` with the (L,) mask broadcast over trailing dims:
    present learners take ``new``, absent keep ``old``."""

    def sel(n, o):
        mm = torch.as_tensor(m, device=n.device).reshape(
            (m.shape[0],) + (1,) * (n.dim() - 1))
        return torch.where(mm != 0, n, o)

    return tree_map(sel, new, old)
