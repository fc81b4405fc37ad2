"""The inputs of a run, made from ``--seed`` by the benchmark itself and
handed alike to the program and to the reference: the initial weights and
the token batches.

The weights are the model's parameter tree in the layout the port's
transformer takes (``src/repro_torch/models/{layers,moe,transformer}.py``
at commit a2698f40: stacked layers under ``blocks`` and, with leading
dense layers, ``dense_blocks``), with the port's initial scales (N(0, 1 /
fan_in), the embedding N(0, 0.02^2), norm scales 1, biases 0). Each leaf
is one draw from a generator of its own on the device, so any leaf can be
drawn again alone, and so a stack of layers is one large call.

The tokens are a frozen copy of ``src/repro_torch/data/synthetic.py::
uniform_batch_fn`` (same commit): (L, K, B, S) ids uniform over the
vocabulary, the labels equal to the tokens (the loss predicts the next
one). Each meta step's batch comes from a generator keyed on the seed and
the step, not from the generator the program offers.

Imports only torch and numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# purposes of the derived generators
WEIGHTS, TOKENS = 0, 1


def generator(device, seed: int, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``keys``. Any
    whole seed works: it is taken modulo 2**64."""
    state = np.random.SeedSequence(
        [int(seed) % 2**64, *map(int, keys)]).generate_state(2)
    dev = torch.device(device)
    value = (int(state[0]) | int(state[1]) << 32) & 0x7FFF_FFFF_FFFF_FFFF
    return torch.Generator(device=dev).manual_seed(value)


def param_layout(cfg: dict) -> dict:
    """{path: (shape, init)} of every leaf, in a fixed order. ``init`` is
    ``("normal", std)``, ``"ones"`` or ``"zeros"``."""
    d, nq, nkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                      cfg["head_dim"])
    V = cfg["vocab_size"]

    def dense(fan_in):
        return ("normal", 1.0 / math.sqrt(max(1, fan_in)))

    def stack(prefix, n, moe):
        out = {
            f"{prefix}/attn/wq": ((n, d, nq, hd), dense(d)),
            f"{prefix}/attn/wk": ((n, d, nkv, hd), dense(d)),
            f"{prefix}/attn/wv": ((n, d, nkv, hd), dense(d)),
            f"{prefix}/attn/wo": ((n, nq, hd, d), dense(nq * hd)),
        }
        if cfg.get("qkv_bias"):
            out[f"{prefix}/attn/bq"] = ((n, nq, hd), "zeros")
            out[f"{prefix}/attn/bk"] = ((n, nkv, hd), "zeros")
            out[f"{prefix}/attn/bv"] = ((n, nkv, hd), "zeros")
        if cfg.get("qk_norm"):
            out[f"{prefix}/attn/q_norm"] = ((n, hd), "ones")
            out[f"{prefix}/attn/k_norm"] = ((n, hd), "ones")
        out[f"{prefix}/attn_norm/scale"] = ((n, d), "ones")
        out[f"{prefix}/mlp_norm/scale"] = ((n, d), "ones")
        if moe:
            E, de = cfg["num_experts"], cfg["d_expert"]
            out[f"{prefix}/moe/router"] = ((n, d, E), dense(d))
            out[f"{prefix}/moe/w_in"] = ((n, E, d, 2, de), dense(d))
            out[f"{prefix}/moe/w_out"] = ((n, E, de, d), dense(de))
            if cfg.get("num_shared_experts"):
                f = cfg["num_shared_experts"] * de
                out[f"{prefix}/moe/shared/wi"] = ((n, d, 2, f), dense(d))
                out[f"{prefix}/moe/shared/wo"] = ((n, f, d), dense(f))
        else:
            f = cfg["d_ff"]
            out[f"{prefix}/mlp/wi"] = ((n, d, 2, f), dense(d))
            out[f"{prefix}/mlp/wo"] = ((n, f, d), dense(f))
        return out

    layout = {}
    if cfg.get("num_experts"):
        nd = cfg.get("first_dense_layers", 0)
        if nd:
            layout.update(stack("dense_blocks", nd, False))
        layout.update(stack("blocks", cfg["num_layers"] - nd, True))
    else:
        layout.update(stack("blocks", cfg["num_layers"], False))
    layout["embed/embedding"] = ((V, d), ("normal", 0.02))
    if not cfg.get("tie_embeddings"):
        layout["embed/head"] = ((d, V), dense(d))
    layout["final_norm/scale"] = ((d,), "ones")
    return layout


def make_leaf(cfg: dict, seed: int, path: str, device) -> torch.Tensor:
    """Leaf ``path`` of the initial weights, f32 on ``device``."""
    layout = param_layout(cfg)
    shape, init = layout[path]
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    index = list(layout).index(path)
    gen = generator(device, seed, WEIGHTS, index)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(init[1])


def nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = x
    return tree


def make_params(cfg: dict, seed: int, device) -> dict:
    """The whole initial parameter tree, f32 on ``device``."""
    return nest({p: make_leaf(cfg, seed, p, device)
                 for p in param_layout(cfg)})


def make_batches(cfg: dict, traffic: dict, seed: int, step: int,
                 device) -> dict:
    """Meta step ``step``'s batches: {"tokens", "labels"} of (L, K, B, S)
    int64 ids uniform over the vocabulary."""
    gen = generator(device, seed, TOKENS, step)
    shape = (traffic["learners"], traffic["k_steps"], traffic["batch"],
             traffic["seq_len"])
    toks = torch.randint(0, cfg["vocab_size"], shape, generator=gen,
                         device=torch.device(device))
    return {"tokens": toks, "labels": toks}
