"""The plain reference of the flat M-AVG meta step (the paper's
Algorithm 1), in float32: a frozen copy of the arithmetic of
``src/repro_torch/core/meta.py`` with the dense flat topology at commit
a2698f40, on parameter trees rather than packed planes.

    every learner j starts from w~ and runs K SGD steps
        w_j <- w_j - lr * grad loss(w_j, batch[j, k])
    a = mean_j w_j;  d = a - w~;  v <- mu v + eta d;  w~ <- w~ + v

The learners run one after another, so one learner's weights and one
gradient are alive at a time beside w~, v and the running sum of the
learners. Imports only torch and the benchmark's own modules.

``learner_dtype=torch.bfloat16`` is the control: the learners' weights,
gradients and SGD updates held in bfloat16 in place of the configuration's
float32 planes (each update computed in float32 and rounded, as
``MAvgConfig.compute_dtype`` means it), the model and the mix as they are.
"""
from __future__ import annotations

import torch

from benchlib import compare, inputs, ref_transformer


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    return list(ref_transformer.leaves(tree))


def meta_step(gp, v, batches, cfg, traffic, learner_dtype=torch.float32):
    """One meta step, in place on the trees ``gp`` (w~) and ``v``.
    ``batches``: {"tokens", "labels"} of (L, K, B, S). Returns the mean of
    the L x K local losses."""
    L, K = traffic["learners"], traffic["k_steps"]
    lr, mu, eta = (traffic["learner_lr"], traffic["momentum"],
                   traffic["meta_lr"])
    acc = tree_map(torch.zeros_like, gp)
    losses = []
    for j in range(L):
        w = tree_map(lambda x: x.to(learner_dtype, copy=True)
                     .requires_grad_(True), gp)
        for k in range(K):
            value = ref_transformer.loss(tree_map(lambda x: x.float(), w),
                                         cfg, batches["tokens"][j, k],
                                         batches["labels"][j, k])
            grads = torch.autograd.grad(value, leaves(w))
            with torch.no_grad():
                for x, g in zip(leaves(w), grads):
                    x.copy_(x.float() - lr * g.float())
            del grads
            losses.append(value.detach())
        with torch.no_grad():
            tree_map(lambda a, x: a.add_(x.float()), acc, w)
        del w
    with torch.no_grad():
        def mix(g, vv, a):
            d = a / L - g
            vv.mul_(mu).add_(eta * d)
            g.add_(vv)

        tree_map(mix, gp, v, acc)
    return float(torch.stack(losses).mean())


def readings(cfg: dict, traffic: dict, seed: int, steps: int, device,
             learner_dtype=torch.float32) -> dict:
    """The reference's readings of the first ``steps`` meta steps from the
    seed's weights and batches (``compare.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gp = inputs.make_params(cfg, seed, device)
    v = tree_map(torch.zeros_like, gp)
    losses, first = [], None
    for step in range(steps):
        batches = inputs.make_batches(cfg, traffic, seed, step, device)
        losses.append(meta_step(gp, v, batches, cfg, traffic,
                                learner_dtype))
        del batches
        if step == 0:
            first = compare.leaf_norms(v)
    del v
    change = {}
    for path in inputs.param_layout(cfg):
        node = gp
        for key in path.split("/"):
            node = node[key]
        diff = inputs.make_leaf(cfg, seed, path, device).sub_(node)
        change.update(compare.leaf_norms(inputs.nest({path: diff})))
        del diff
    return {"losses": losses, "first": first, "change": change}
