"""Tree arithmetic over nested dicts of tensors (the port's pytrees).

A tree is a tensor (a leaf, e.g. one packed (rows, 128) plane) or a dict
whose values are trees. Leaves are visited in sorted-key order — the
order ``jax.tree_util`` flattens a dict in — so a flattened port tree
lines up leaf for leaf with the JAX package's.
"""
from __future__ import annotations

from typing import Callable

import torch


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


def tree_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, accumulated in f32."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def tree_mean_axis0(tree):
    """Mean over the leading (learner) axis of every leaf."""
    return tree_map(lambda x: torch.mean(x, dim=0), tree)


def tree_broadcast_learners(tree, num_learners: int):
    """w_j <- w~ for every learner j: a new leading learner axis (copied,
    so each learner owns its storage and can be updated in place)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_learners,) + tuple(x.shape))
        .clone(),
        tree,
    )
