"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first meta steps, taken from
their own state:

* ``losses``: each meta step's loss, the mean over its L x K local steps;
* ``first``: the norm of each leaf of the first displacement as the block
  momentum gets it, v after step 1 (v starts at 0, so v_1 = eta d_1);
* ``change``: the norm of each leaf of w~ after the last compared step
  minus the initial weights.

A leaf is one layer's slice of a stacked parameter (``blocks/attn/wq[3]``)
or a whole unstacked one. The numbers compared, each against its limit:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``first_gap`` and ``change_gap``: over the leaves, the largest gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median compared leaf, whichever is larger.
  ``change_gap`` leaves out the leaves whose reference gradient is under
  a thousandth of the median leaf's: round-off alone moves them.

Imports only torch.
"""
from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "first_gap", "change_gap")
QUIET_LEAF = 1e-3  # a leaf's gradient under this share of the median's


def leaf_norms(tree: dict, prefix: str = "") -> dict:
    """{leaf name: f64 norm} of a parameter tree; a leaf under a stack of
    layers (``blocks``, ``dense_blocks``) is split into its layers."""
    out = {}
    for key, node in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            out.update(leaf_norms(node, path))
        elif path.split("/")[0].endswith("blocks"):
            for i in range(node.shape[0]):
                out[f"{path}[{i}]"] = float(torch.linalg.vector_norm(
                    node[i], dtype=torch.float64))
        else:
            out[path] = float(torch.linalg.vector_norm(
                node, dtype=torch.float64))
    return out


def _norm_gap(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    floor = statistics.median(ref[name] for name in leaves)
    worst = 0.0
    for name in leaves:
        gap = abs(prog[name] - ref[name]) / max(ref[name], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of the program's readings against the
    reference's (same leaves, same steps)."""
    if set(prog["first"]) != set(ref["first"]) or \
            len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides read different leaves or steps")
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    floor = statistics.median(ref["first"].values())
    moving = [n for n, x in ref["first"].items() if x >= QUIET_LEAF * floor]
    return {
        "loss_gap": loss_gap,
        "first_gap": _norm_gap(prog["first"], ref["first"], ref["first"]),
        "change_gap": _norm_gap(prog["change"], ref["change"], moving),
    }


def verdict(values: dict, limits: dict) -> bool:
    """Every number finite and at or under its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in NUMBERS)


def report_lines(values: dict, limits: dict) -> list[str]:
    return [f"{k} {values[k]!r} limit {limits[k]!r}" for k in NUMBERS]
