"""Tree arithmetic over nested dicts of tensors (the port's pytrees).

A tree is a tensor (a leaf, e.g. one packed (rows, 128) plane) or a dict
whose values are trees. Leaves are visited in sorted-key order — the
order ``jax.tree_util`` flattens a dict in — so a flattened port tree
lines up leaf for leaf with the JAX package's.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor (``torch.distributed.tensor``)? Told by its class
    name, so that nothing of ``torch.distributed`` is imported for it."""
    return type(x).__name__ == "DTensor"


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list[str]:
    """Slash-joined key path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [
            p for k in sorted(tree)
            for p in tree_paths(tree[k], f"{prefix}{k}/")
        ]
    return [prefix[:-1]]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(paths, leaves) -> dict:
    """Rebuild the nested dict from ``tree_paths``-style keys."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def sq_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``x`` in f64: the f32 norm of each row of its
    last dim (128 lanes on a packed plane), squared and summed in f64. A
    plane split by rows over ranks sums to the same value as one process
    (to f64 rounding), where one f32 reduction over a 1.3M-value plane
    errs by ~1e-5."""
    rows = torch.linalg.vector_norm(x.reshape(-1, x.shape[-1]) if x.dim()
                                    else x.reshape(1, 1), dim=-1,
                                    dtype=torch.float32)
    return torch.sum(rows.to(torch.float64) ** 2)


def tree_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``sq_sum``), in f32."""
    sq = [sq_sum(x) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum()).to(torch.float32)


def mean_axis0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading (learner) axis, in one summation order for
    every width.

    On the CPU, where the port is held to the JAX package, the sum is
    XLA's: ``acc = 0; acc += x[i]`` for i = 0..L-1 in turn (f32 for a
    16-bit dtype, as ``jnp.mean`` upcasts), then one multiplication by the
    f32 reciprocal of L (XLA turns the mean's division by the constant L
    into that).
    ATen's CPU ``mean`` vectorises across the kept dims, and sums a leaf
    narrower than its vector width (a 10-wide bias) in another order than
    a wide plane, so a per-leaf step and a packed one came out one
    rounding apart at L=8. Elsewhere (the card, the meta device of the
    cost model) it is ``torch.mean``, one pass over the stack.
    """
    if x.device.type != "cpu":
        return torch.mean(x, dim=0)
    acc_dt = (torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
              else x.dtype)
    acc = torch.zeros(x.shape[1:], dtype=acc_dt)
    for i in range(x.shape[0]):
        acc.add_(x[i])
    inv = float(np.float32(1.0) / np.float32(x.shape[0]))
    return acc.mul_(inv).to(x.dtype)


def tree_mean_axis0(tree):
    """Mean over the leading (learner) axis of every leaf (``mean_axis0``)."""
    return tree_map(mean_axis0, tree)


def tree_broadcast_learners(tree, num_learners: int):
    """w_j <- w~ for every learner j: a new leading learner axis (copied,
    so each learner owns its storage and can be updated in place)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_learners,) + tuple(x.shape))
        .clone(),
        tree,
    )
