"""E1, the paper's acceptance (Figures 1-6, Table I): M-AVG reaches a
target loss in no more samples than K-AVG at the same (N, K, P, B).

The JAX package's ``benchmarks/convergence.py`` on the port, with the
same cases, settings, targets, seeds and hyperparameters: the MLP and the
CNN on the teacher-classification stream and the tiny transformer
(``qwen3-1.7b.reduced()``) on the bigram stream, each run as K-AVG (mu=0)
and M-AVG (mu=0.7) through ``make_meta_step`` on the packed flat
meta-plane.

  PYTHONPATH=src python -m repro_torch.benchmarks.convergence --quick \\
      [--device cpu]

``main`` prints the reference's CSV lines, then one JSON line per model
(``k_stt``, ``m_stt``, the speedup and whether each arm reached its
target), and asserts ``m_stt <= 1.1 * k_stt`` where the reference does:
only when both arms reached the target. In quick mode the CNN reaches its
2.2 target in neither arm (its loss stays near ln 10, in JAX too), so it
asserts nothing there.

Each runner takes optional initial ``params``, batches ``batch_at(i)``
and (for the classifiers) an ``eval_set``; a parity test passes JAX's,
carried over with ``repro_torch.interop.params_from_jax``. By default the
port draws its own from seeded generators on ``device``, which differ
from JAX's streams.
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Optional

import torch

from repro_torch.benchmarks.common import (
    run_mlp,
    samples_to_target,
    seeded_batches,
    train_curve,
)
from repro_torch.configs.base import MAvgConfig, get_config
from repro_torch.data import classif_batch_fn, classif_eval_set, lm_batch_fn
from repro_torch.models import api as model_api
from repro_torch.models.simple import cnn_accuracy, cnn_init, cnn_loss
from repro_torch.pack import unpack_params
from repro_torch.utils.rng import seeded_generator

CNN_HW = 12
TT_SEQ = 32


def run_cnn(algorithm, *, P=4, K=4, mu=0.7, lr=0.1, steps=40, batch=8,
            seed=0, device="cuda", params: Optional[dict] = None,
            batch_at: Optional[Callable] = None,
            eval_set: Optional[dict] = None):
    """The CNN on (hw, hw, 3) teacher-labelled features; returns (losses,
    val_acc) on a 512-example evaluation set."""
    hw = CNN_HW
    cfg = MAvgConfig(algorithm=algorithm, num_learners=P, k_steps=K,
                     learner_lr=lr, momentum=mu)
    if params is None:
        params = cnn_init(seeded_generator(device, seed), hw=hw, classes=10,
                          device=device)
    if batch_at is None:
        flat = seeded_batches(
            classif_batch_fn(hw * hw * 3, 10, P, K, batch, device=device),
            seed + 1, device)

        def batch_at(i):
            b = flat(i)
            return {"x": b["x"].reshape(P, K, batch, hw, hw, 3),
                    "y": b["y"]}

    losses, state = train_curve(cnn_loss, cfg, params, batch_at, steps)
    if eval_set is None:
        ev = classif_eval_set(hw * hw * 3, 10, n=512, device=device)
        eval_set = {"x": ev["x"].reshape(-1, hw, hw, 3), "y": ev["y"]}
    with torch.no_grad():
        acc = float(cnn_accuracy(unpack_params(state), eval_set))
    return losses, acc


def run_tiny_transformer(algorithm, *, P=4, K=2, mu=0.6, lr=0.5, steps=20,
                         batch=8, seed=0, device="cuda",
                         params: Optional[dict] = None,
                         batch_at: Optional[Callable] = None):
    """``qwen3-1.7b.reduced()`` on the bigram stream (sequences of 32);
    returns (losses, perplexity over the last five steps' losses)."""
    cfg = get_config("qwen3-1.7b").reduced()
    mcfg = MAvgConfig(algorithm=algorithm, num_learners=P, k_steps=K,
                      learner_lr=lr, momentum=mu)
    if params is None:
        params = model_api.init_params(seeded_generator(device, seed), cfg,
                                       device)
    if batch_at is None:
        batch_at = seeded_batches(
            lm_batch_fn(cfg, P, K, batch, TT_SEQ, device=device), seed + 1,
            device)
    losses, _ = train_curve(lambda p, b: model_api.loss_fn(p, cfg, b), mcfg,
                            params, batch_at, steps)
    return losses, math.exp(sum(losses[-5:]) / len(losses[-5:]))


def cases(quick: bool):
    """(model, runner, settings, target loss) of each E1 case."""
    steps = 30 if quick else 60
    return (
        ("mlp", run_mlp, dict(P=4, K=4, lr=0.2, steps=steps, batch=16), 1.0),
        ("cnn", run_cnn, dict(P=4, K=4, lr=0.1, steps=max(20, steps // 2)),
         2.2),
        ("tiny-transformer", run_tiny_transformer,
         dict(P=4, K=2, lr=0.5, steps=max(15, steps // 3)), 5.5),
    )


ARMS = (("kavg", 0.0), ("mavg", 0.7))


def main(quick: bool = False, device="cuda", log=print):
    """Primary metric: samples to the target loss (the paper's Lemma-4
    speed-up); secondary: final loss and the validation metric (Table I).
    Returns the rows (model, algorithm, mu, final loss, metric, samples to
    target) and one summary dict per model."""
    rows, summaries = [], []
    for model, runner, kw, target in cases(quick):
        stt = {}
        for algo, mu in ARMS:
            losses, metric = runner(algo, **kw, mu=mu, device=device)
            batch = kw.get("batch", 8)
            stt[algo] = samples_to_target(losses, target, kw["P"], kw["K"],
                                          batch)
            rows.append((model, algo, mu, losses[-1], metric, stt[algo]))
            log(f"convergence,{model},{algo},mu={mu},final_loss="
                f"{losses[-1]:.4f},metric={metric:.4f},"
                f"samples_to_{target}={stt[algo]}")
        k_stt, m_stt = stt["kavg"], stt["mavg"]
        summary = {"model": model, "target": target, "k_stt": k_stt,
                   "m_stt": m_stt,
                   "speedup": (k_stt / m_stt if k_stt and m_stt else None),
                   "kavg_reached": k_stt is not None,
                   "mavg_reached": m_stt is not None,
                   "asserted": bool(k_stt and m_stt)}
        if summary["asserted"]:
            log(f"convergence,{model},speedup,{k_stt / m_stt:.2f}x")
            # the paper's acceleration claim: M-AVG no slower (10 %
            # tolerance), asserted where the reference asserts it
            assert m_stt <= 1.1 * k_stt, (model, m_stt, k_stt)
        log(json.dumps(summary))
        summaries.append(summary)
    return rows, summaries


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick mode (30 MLP steps)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
