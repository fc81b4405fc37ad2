"""End-to-end example: train a ~100M-parameter dense transformer with M-AVG
on the bigram-teacher LM stream (the JAX package's
``examples/train_100m.py``, on the port's Trainer).

The default runs a reduced width (4 layers, d_model 256, V 4096) so the
example finishes on the CPU; ``--width full`` selects the ~100M
configuration (12 layers, d_model 768, 12/4 heads, d_ff 2048, V 32,768)
on the same code path. Its bigram teacher is a (32768, 32768) f32 table
on the device (4.29 GB, built once for the batches and once for the
evaluation set).

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_100m --width full \\
      --steps 300

``run(args, params=, batch_at=, eval_set=, cfg=)`` takes JAX's initial
params, batches ``batch_at(step)``, evaluation set and a float32 copy of
the model config in a parity check.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.configs.base import MAvgConfig, ModelConfig, TrainConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data import lm_batch_fn, lm_eval_set
from repro_torch.models import api as model_api
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.pack import unpack_params
from repro_torch.utils.tree import tree_leaves, tree_map


def make_config(width: str) -> ModelConfig:
    if width == "full":  # ~100M params
        return ModelConfig(
            name="dense-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
            rope_theta=10000.0,
        )
    return ModelConfig(  # the CPU-friendly stand-in, same family and path
        name="dense-8m", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=4096,
        rope_theta=10000.0,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", default="small", choices=["small", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--momentum", type=float, default=0.7)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def param_count(cfg: ModelConfig) -> int:
    """The exact parameter count, from the shapes alone."""
    return sum(x.numel() for x in tree_leaves(
        model_api.init_params(None, cfg, "meta")))


def run(args, params: Optional[dict] = None,
        batch_at: Optional[Callable] = None,
        eval_set: Optional[dict] = None, log=print,
        cfg: Optional[ModelConfig] = None):
    """Train; returns (trainer, history, eval loss, parameter count).
    ``cfg`` replaces ``make_config(args.width)``."""
    cfg = make_config(args.width) if cfg is None else cfg
    dev = torch.device(args.device)
    n_params = param_count(cfg)
    log(f"model: {cfg.name} ({n_params / 1e6:.1f}M params, {n_params:,}), "
        f"P={args.learners} K={args.k} B={args.batch} seq={args.seq}")

    mcfg = MAvgConfig(algorithm="mavg", num_learners=args.learners,
                      k_steps=args.k, learner_lr=args.lr,
                      momentum=args.momentum)
    tcfg = TrainConfig(model=cfg, mavg=mcfg,
                       batch_per_learner=args.batch, seq_len=args.seq,
                       meta_steps=args.steps, log_every=10,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=100 if args.checkpoint_dir else 0)
    if params is None:
        def init(gen):
            return model_api.init_params(gen, cfg, dev)
    else:
        def init(_gen):
            return tree_map(lambda x: x.to(dev, copy=True), params)
    if batch_at is None:
        batch_fn = lm_batch_fn(cfg, args.learners, args.k, args.batch,
                               args.seq, device=dev)
    else:
        def batch_fn(_gen, step):
            return tree_map(lambda x: x.to(dev), batch_at(step))
    trainer = Trainer(
        tcfg, lambda p, b: model_api.loss_fn(p, cfg, b),
        init_params_fn=init, batch_fn=batch_fn,
        lr_schedule=warmup_cosine(args.lr, 20, args.steps), device=dev)
    history = trainer.run(log=log)
    if eval_set is None:
        eval_set = lm_eval_set(cfg, n=32, seq_len=args.seq, device=dev)
    else:
        eval_set = tree_map(lambda x: x.to(dev), eval_set)
    with torch.no_grad():
        loss, _ = model_api.loss_fn(unpack_params(trainer.state), cfg,
                                    eval_set)
    loss = float(loss)
    log(f"\ndone: train loss {history[0]['loss']:.3f} -> "
        f"{history[-1]['loss']:.3f}; eval loss {loss:.3f}; "
        f"samples {history[-1]['samples']}")
    return trainer, history, loss, n_params


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
