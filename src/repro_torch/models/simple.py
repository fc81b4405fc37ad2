"""The small models of the JAX package's ``models/simple.py``: the MLP and
the CNN of the paper-claim convergence runs (E1,
``repro_torch.benchmarks.convergence``) on the teacher-classification
stream. Batches are {'x': features, 'y': int labels}."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mlp_accuracy(params, batch):
    logits = mlp_forward(params, batch["x"])
    return (torch.argmax(logits, -1) == batch["y"]).to(torch.float32).mean()


# ---------------------------------------------------------------------------
# small CNN (CIFAR-shaped stand-in; batch['x'] is (B, H, W, C))
# ---------------------------------------------------------------------------
#
# The parameters keep JAX's HWIO kernel shapes, so the CNN packs into the
# same meta-plane layout and checkpoints under the same shapes as JAX's.
# The forward permutes to F.conv2d's NCHW/OIHW inside and back to NHWC
# before the flatten, so the rows of ``out`` meet the features in JAX's
# (h, w, c) order.


def cnn_init(gen, hw: int = 16, channels: int = 3, width: int = 16,
             classes: int = 10, device="cuda"):
    flat = (hw // 4) * (hw // 4) * (2 * width)
    return {
        "c1": dense_init(gen, (3, 3, channels, width), 9 * channels, device),
        "c2": dense_init(gen, (3, 3, width, 2 * width), 9 * width, device),
        "out": dense_init(gen, (flat, classes), flat, device),
        "b_out": torch.zeros((classes,), device=device),
    }


def _conv(x, w):
    """SAME 3x3 stride-1 convolution of NCHW ``x`` by an HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)


def _pool2(x):
    """2x2 max pool, stride 2, VALID (NCHW)."""
    return F.max_pool2d(x, 2, 2)


def cnn_forward(params, x):
    h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    h = _pool2(torch.relu(_conv(h, params["c1"])))
    h = _pool2(torch.relu(_conv(h, params["c2"])))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flatten in NHWC
    return h @ params["out"] + params["b_out"]


def cnn_loss(params, batch):
    logits = cnn_forward(params, batch["x"])
    return cross_entropy(logits, batch["y"]), {}


def cnn_accuracy(params, batch):
    logits = cnn_forward(params, batch["x"])
    return (torch.argmax(logits, -1) == batch["y"]).to(torch.float32).mean()
