"""Ablations beyond the paper: block-momentum flavours (the JAX
package's ``benchmarks/ablations.py``, with its variants and settings).

* heavy-ball (the paper's Algorithm 1), mu 0.6
* Nesterov block momentum (lookahead at the meta level), mu 0.6
* learner-level MSGD under block momentum (the paper's section V note),
  mu 0.4 and local momentum 0.5
* meta_lr (eta) 0.5 and 1.5 scaling of the displacement, mu 0.6

All at P=4, K=4, B=8, lr 0.15, 40 meta steps in quick mode and 80
otherwise, on the teacher-classification MLP; every variant must train
(its last loss below its first).

  PYTHONPATH=src python -m repro_torch.benchmarks.ablations --quick \\
      [--device cpu]

``params``, ``batch_at(i)`` and ``eval_set`` replace the port's own draws
for every variant (a parity test passes JAX's).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.benchmarks.common import (
    CLASSES,
    D_IN,
    HIDDEN,
    samples_to_target,
    seeded_batches,
    train_curve,
)
from repro_torch.configs.base import MAvgConfig
from repro_torch.data import classif_batch_fn, classif_eval_set
from repro_torch.models.simple import mlp_accuracy, mlp_init, mlp_loss
from repro_torch.pack import unpack_params
from repro_torch.utils.rng import seeded_generator

P, K, B, LR, TARGET = 4, 4, 8, 0.15, 1.1

VARIANTS = (
    ("heavy_ball", dict(momentum=0.6)),
    ("nesterov", dict(momentum=0.6, nesterov=True)),
    ("mlocal", dict(algorithm="mavg_mlocal", momentum=0.4,
                    local_momentum=0.5)),
    ("eta_0.5", dict(momentum=0.6, meta_lr=0.5)),
    ("eta_1.5", dict(momentum=0.6, meta_lr=1.5)),
)


def run_cfg(tag, steps=60, *, device="cuda", params: Optional[dict] = None,
            batch_at: Optional[Callable] = None,
            eval_set: Optional[dict] = None, log=print, **kw):
    """One variant; returns (losses, val_acc, samples to 1.1 or None)."""
    cfg = MAvgConfig(algorithm=kw.pop("algorithm", "mavg"), num_learners=P,
                     k_steps=K, learner_lr=LR, **kw)
    if params is None:
        params = mlp_init(seeded_generator(device, 0), D_IN, HIDDEN, CLASSES,
                          device=device)
    if batch_at is None:
        batch_at = seeded_batches(
            classif_batch_fn(D_IN, CLASSES, P, K, B, device=device), 1,
            device)
    losses, state = train_curve(mlp_loss, cfg, params, batch_at, steps)
    if eval_set is None:
        eval_set = classif_eval_set(D_IN, CLASSES, device=device)
    with torch.no_grad():
        acc = float(mlp_accuracy(unpack_params(state), eval_set))
    stt = samples_to_target(losses, TARGET, P, K, B)
    log(f"ablations,{tag},final_loss={losses[-1]:.4f},val_acc={acc:.4f},"
        f"samples_to_{TARGET}={stt}")
    return losses, acc, stt


def main(quick: bool = False, device="cuda", params: Optional[dict] = None,
         batch_at: Optional[Callable] = None,
         eval_set: Optional[dict] = None, log=print) -> dict:
    """{variant: (losses, val_acc, samples to 1.1)}; asserts that every
    variant trains."""
    steps = 40 if quick else 80
    results = {tag: run_cfg(tag, steps, device=device, params=params,
                            batch_at=batch_at, eval_set=eval_set, log=log,
                            **kw)
               for tag, kw in VARIANTS}
    for tag, (losses, _, _) in results.items():
        assert losses[-1] < losses[0], tag
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
