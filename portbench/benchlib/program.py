"""The system under test: the port's ``Trainer`` built as
``src/repro_torch/launch/train.py --full`` builds it (the flat dense M-AVG
meta step on packed f32 planes, the model computing in ``cfg.dtype``, the
default ``full`` remat), fed the benchmark's weights and token batches
(``inputs.py``) and no learning-rate schedule.

``variant`` plants a fault whose readings a limit is held against; a run
of the benchmark always takes ``"program"``:

* ``"half_batch"``: each local step's loss over the first half of its
  rows, the mean taken over those;
* ``"unchanged"``: each meta step returns its state as it was.
"""
from __future__ import annotations

import sys

from benchlib import compare, inputs
from repro_torch.configs.base import (
    MAvgConfig,
    ModelConfig,
    ObsConfig,
    TrainConfig,
)
from repro_torch.core.trainer import Trainer
from repro_torch.models import api as model_api

VARIANTS = ("program", "half_batch", "unchanged")
MODEL_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim", "qk_norm",
              "qkv_bias", "tie_embeddings", "rope_theta", "num_experts",
              "num_shared_experts", "moe_top_k", "d_expert", "moe_aux_coef",
              "first_dense_layers", "capacity_factor", "norm_eps", "dtype")


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig(**{k: cfg[k] for k in MODEL_KEYS if k in cfg})


def build(cfg: dict, traffic: dict, seed: int, device, *, trace=False,
          variant: str = "program") -> Trainer:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    mcfg_model = model_config(cfg)

    def loss_fn(params, batch):
        if variant == "half_batch":
            half = batch["tokens"].shape[0] // 2
            batch = {k: x[:half] for k, x in batch.items()}
        return model_api.loss_fn(params, mcfg_model, batch)

    mcfg = MAvgConfig(
        algorithm="mavg", num_learners=traffic["learners"],
        k_steps=traffic["k_steps"], learner_lr=traffic["learner_lr"],
        momentum=traffic["momentum"], meta_lr=traffic["meta_lr"])
    tcfg = TrainConfig(model=mcfg_model, mavg=mcfg,
                       batch_per_learner=traffic["batch"],
                       seq_len=traffic["seq_len"], seed=0,
                       obs=ObsConfig(trace=trace))
    trainer = Trainer(
        tcfg, loss_fn,
        init_params_fn=lambda _gen: inputs.make_params(cfg, seed, device),
        batch_fn=lambda _gen, step: inputs.make_batches(cfg, traffic, seed,
                                                        step, device),
        device=device)
    if variant == "unchanged":
        step = trainer._step_fn

        def unchanged(state, batches, lr=None):
            saved = [x.clone() for x in (state.global_params,
                                         state.momentum, state.learners)]
            state, metrics = step(state, batches, lr=lr)
            for x, old in zip((state.global_params, state.momentum,
                               state.learners), saved):
                x.copy_(old)
            return state, metrics

        trainer._step_fn = unchanged
    return trainer


def log_to_stderr(line: str) -> None:
    print(line, file=sys.stderr)


def run_steps(trainer: Trainer, n: int) -> None:
    trainer.run(n, log=log_to_stderr)


def global_tree(trainer: Trainer) -> dict:
    state = trainer.state
    return state.spec.unpack(state.global_params)


def first_reading(trainer: Trainer) -> dict:
    """Leaf norms of v after the first meta step."""
    state = trainer.state
    return compare.leaf_norms(state.spec.unpack(state.momentum))


def change_reading(trainer: Trainer, cfg: dict, seed: int) -> dict:
    """Leaf norms of the initial weights minus w~ (the change's norms),
    each initial leaf drawn again from the seed, one at a time."""
    tree = global_tree(trainer)
    out = {}
    for path in inputs.param_layout(cfg):
        node = tree
        for key in path.split("/"):
            node = node[key]
        diff = inputs.make_leaf(cfg, seed, path, node.device).sub_(node)
        out.update(compare.leaf_norms(inputs.nest({path: diff})))
        del diff
    return out


def plane_bytes(trainer: Trainer) -> int:
    gp = trainer.state.global_params
    return gp.numel() * gp.element_size()
