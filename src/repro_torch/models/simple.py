"""The MLP of the JAX package's ``models/simple.py`` (used by the fast CPU
algorithm tests). Batches are {'x': features, 'y': int labels}."""
from __future__ import annotations

import torch

from repro_torch.models.layers import cross_entropy, dense_init


def mlp_init(gen, d_in: int, hidden: int, classes: int, depth: int = 2,
             device="cuda"):
    params = {"in": dense_init(gen, (d_in, hidden), d_in, device)}
    for i in range(depth - 1):
        params[f"h{i}"] = dense_init(gen, (hidden, hidden), hidden, device)
    params["out"] = dense_init(gen, (hidden, classes), hidden, device)
    params["b_out"] = torch.zeros((classes,), device=device)
    return params


def mlp_forward(params, x):
    h = torch.tanh(x @ params["in"])
    i = 0
    while f"h{i}" in params:
        h = torch.tanh(h @ params[f"h{i}"])
        i += 1
    return h @ params["out"] + params["b_out"]


def mlp_loss(params, batch):
    logits = mlp_forward(params, batch["x"])
    loss = cross_entropy(logits, batch["y"])
    return loss, {"logits": logits}
