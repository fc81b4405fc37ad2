"""Training launcher of the port: end-to-end M-AVG training of an
assigned architecture (reduced or full config) on one card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --algorithm mavg --learners 4 --k 4 --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda \\
      --steps 3

The reduced config trains on the bigram-teacher stream and ends with an
eval loss. ``--full`` uses uniform random tokens instead: the bigram table
at the full vocabulary would take 92 GB (ROADMAP). ``--comm`` compresses
the meta average (``repro_torch.comm``), with error feedback unless
``--no-error-feedback``; at full width with f32 learners the EF residual
adds L planes, so ``--full --comm int8`` fits one 80 GB card at
``--learners 2``. The JAX launcher's other flags (topology, obs, chaos,
robust, checkpoints) are not ported yet.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import (
    AVERAGING_ALGOS,
    COMM_SCHEMES,
    CommConfig,
    MAvgConfig,
    TrainConfig,
    get_config,
)
from repro_torch.core.trainer import Trainer
from repro_torch.data import lm_batch_fn, lm_eval_set, uniform_batch_fn
from repro_torch.models import api as model_api
from repro_torch.optim import warmup_cosine
from repro_torch.pack import unpack_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--algorithm", default="mavg", choices=AVERAGING_ALGOS)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--momentum", type=float, default=0.7)
    ap.add_argument("--full", action="store_true",
                    help="full-scale config (one 80 GB card)")
    ap.add_argument("--comm", default="dense", choices=COMM_SCHEMES,
                    help="meta-communication compression scheme")
    ap.add_argument("--comm-k-frac", type=float, default=0.1,
                    help="kept fraction for the top-k comm schemes")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the comm error-feedback residual")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    mcfg = MAvgConfig(algorithm=args.algorithm, num_learners=args.learners,
                      k_steps=args.k, learner_lr=args.lr,
                      momentum=args.momentum,
                      comm=CommConfig(
                          scheme=args.comm, k_frac=args.comm_k_frac,
                          error_feedback=not args.no_error_feedback))
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=args.batch,
                       seq_len=args.seq, meta_steps=args.steps)
    shape = (cfg, args.learners, args.k, args.batch, args.seq)
    batch_fn = (uniform_batch_fn(*shape) if args.full
                else lm_batch_fn(*shape, device=device))

    def loss_fn(params, batch):
        return model_api.loss_fn(params, cfg, batch)

    trainer = Trainer(
        tcfg, loss_fn,
        init_params_fn=lambda gen: model_api.init_params(gen, cfg, device),
        batch_fn=batch_fn,
        lr_schedule=warmup_cosine(args.lr, 5, args.steps),
        device=device,
    )
    history = trainer.run()
    line = (f"\nfinal train loss {history[-1]['loss']:.4f}  "
            f"samples {history[-1]['samples']}")
    if args.comm != "dense":
        line += (f"  comm_compression {history[-1]['comm_compression']:.2f}"
                 f"  comm_error_norm {history[-1]['comm_error_norm']:.3e}")
    if not args.full:
        eval_batch = lm_eval_set(cfg, n=32, seq_len=args.seq, device=device)
        with torch.no_grad():
            loss, _ = loss_fn(unpack_params(trainer.state), eval_batch)
        line += f"  eval loss {float(loss):.4f}"
    print(line)


if __name__ == "__main__":
    main()
