"""Robust aggregation under sticky finite corruption (the JAX package's
``benchmarks/robust_bench.py``, DESIGN.md section 14).

A learner whose wire payloads are persistently mis-scaled and bit-flipped,
huge but finite and so invisible to the in-step finite guard: the robust
mix (trimmed mean and trailing-median norm clip) must stay within 5 % of
the fault-free final loss at equal effective samples with zero supervisor
rollbacks, while the trusting plain mean degrades. Every arm trains the
teacher-classification MLP through the port's Trainer (P=4, K=4, mu 0.7,
lr 0.2, B=16; 16 meta steps in quick mode, 32 otherwise).

Arms:

  fault_free      no chaos, robust off: the loss bar
  corrupt_mean    sticky finite corruption, plain mean: must degrade
  corrupt_robust  the same corruption, trimmed mean + norm clip + anomaly
                  scores, under the port's Supervisor: within 5 % of the
                  bar and no recovery record
  robust_off      RobustConfig(mean, no clip, no score) against
                  robust=None: the final state bitwise equal

``main`` prints the reference's ``robust,...`` lines and returns its rows,
the last the ``robust_accept`` row that ``benchmarks/expected/robust.json``
gates; ``--json PATH`` writes them as the run-log envelope.

  PYTHONPATH=src python -m repro_torch.benchmarks.robust_bench --quick \\
      [--device cpu] [--json PATH]

``params`` and ``batch_at(step)`` replace the Trainer's own initial
params and batches in every arm (a parity test passes JAX's).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import CLASSES, D_IN, HIDDEN, write_rows
from repro_torch.chaos import ChaosConfig, FaultSpec
from repro_torch.configs.base import (
    MAvgConfig,
    ObsConfig,
    RobustConfig,
    TrainConfig,
)
from repro_torch.core.supervisor import RecoveryPolicy, Supervisor
from repro_torch.core.trainer import Trainer
from repro_torch.data import classif_batch_fn
from repro_torch.models.simple import mlp_init, mlp_loss
from repro_torch.utils.tree import tree_map

P, K, MU, LR, BATCH = 4, 4, 0.7, 0.2, 16
BAD = P - 1  # the persistently corrupt learner
PLANES = ("global_params", "momentum", "learners")

ROBUST = RobustConfig(estimator="trimmed", trim=1, clip_mult=3.0,
                      clip_window=4, score=True)
INERT = RobustConfig(estimator="mean", clip_mult=0.0, score=False)


def sticky_corruption(steps: int) -> ChaosConfig:
    """Learner BAD ships finite but corrupt payloads: bit 29 of one element
    flipped in every payload, all run long (a stuck exponent bit), plus a
    3-step burst scaling the whole plane x12 from step steps // 4. Both
    are order-statistic and norm-budget outliers the robust mix rejects.
    A persistent full-plane scale is left out, as in the reference: it
    biases the learner along gp, which bounding influence per step cannot
    fix (the inline quarantine's job)."""
    return ChaosConfig(seed=0, horizon=steps, faults=(
        FaultSpec("finite_bitflip", step=0, learner=BAD, duration=steps,
                  bit=29, sticky=True),
        FaultSpec("finite_scale", step=steps // 4, learner=BAD, duration=3,
                  magnitude=12.0, sticky=True),
    ))


def make_trainer(steps, *, device, chaos=None, robust=None, guard=False,
                 salt=0, lr_scale=1.0, momentum_scale=1.0,
                 params: Optional[dict] = None,
                 batch_at: Optional[Callable] = None) -> Trainer:
    mcfg = MAvgConfig(
        algorithm="mavg", num_learners=P, k_steps=K,
        learner_lr=LR * lr_scale, momentum=MU * momentum_scale,
        finite_guard=guard, robust=robust)
    tcfg = TrainConfig(
        model=None, mavg=mcfg, batch_per_learner=BATCH, meta_steps=steps,
        seed=0, log_every=2, chaos=chaos, data_salt=salt,
        obs=ObsConfig(sink="none"))
    if params is None:
        def init(gen):
            return mlp_init(gen, D_IN, HIDDEN, CLASSES, device=device)
    else:
        def init(_gen):
            return tree_map(lambda x: x.to(device, copy=True), params)
    if batch_at is None:
        batch_fn = classif_batch_fn(D_IN, CLASSES, P, K, BATCH, device=device)
    else:
        def batch_fn(_gen, step):
            return tree_map(lambda x: x.to(device), batch_at(step))
    return Trainer(tcfg, mlp_loss, init_params_fn=init, batch_fn=batch_fn,
                   device=device)


def final_loss(history):
    tail = [r["loss"] for r in history[-5:]]
    return sum(tail) / len(tail)


def state_finite(state) -> bool:
    return all(bool(torch.isfinite(getattr(state, f)).all())
               for f in PLANES)


def measured(quick: bool, device="cuda", params: Optional[dict] = None,
             batch_at: Optional[Callable] = None) -> list[dict]:
    steps = 16 if quick else 32
    inputs = dict(device=device, params=params, batch_at=batch_at)
    rows: list[dict] = []

    # fault-free bar
    tr = make_trainer(steps, **inputs)
    base_hist = tr.run(log=None)
    base_loss = final_loss(base_hist)
    base_samples = base_hist[-1]["samples"]
    rows.append({"kind": "robust_measured", "cell": "fault_free",
                 "final_loss": base_loss, "effective_samples": base_samples,
                 "state_finite": state_finite(tr.state)})
    tr.close()

    def base_loss_at(samples):
        upto = ([r for r in base_hist if r["samples"] <= samples]
                or base_hist[:1])
        return final_loss(upto)

    chaos = sticky_corruption(steps)

    # the plain mean under sticky finite corruption: the threat is real
    tr = make_trainer(steps, chaos=chaos, guard=True, **inputs)
    mean_hist = tr.run(log=None)
    mean_loss = final_loss(mean_hist)
    tr.close()
    mean_gap = mean_loss / base_loss_at(mean_hist[-1]["samples"])
    rows.append({"kind": "robust_measured", "cell": "corrupt_mean",
                 "final_loss": mean_loss, "loss_vs_fault_free": mean_gap,
                 "effective_samples": mean_hist[-1]["samples"]})

    # robust aggregation under the same corruption, supervised
    def make_sup_trainer(plan):
        return make_trainer(
            steps, chaos=chaos, robust=ROBUST, guard=True,
            salt=plan.data_salt, lr_scale=plan.lr_scale,
            momentum_scale=plan.momentum_scale, **inputs)

    sup = Supervisor(make_sup_trainer, target_steps=steps,
                     checkpoint_dir=None,
                     policy=RecoveryPolicy(max_retries=2))
    tr, _ = sup.run(log=None)
    rob_loss = final_loss(tr.history)
    rob_samples = tr.history[-1]["samples"]
    rollbacks = sum(1 for r in sup.records if r.get("kind") == "recovery")
    rob_finite = state_finite(tr.state)
    max_score = max((max(rb.get("scores", [0.0]))
                     for rb in tr.robust_records), default=0.0)
    # the single-element stuck bit is below the anomaly noise floor on
    # quiet steps; the pin is that the MOST anomalous observation of the
    # run fingers the bad learner
    scored = [rb for rb in tr.robust_records if "scores" in rb]
    anomalous_is_bad = bool(scored) and int(np.argmax(
        max(scored, key=lambda rb: max(rb["scores"]))["scores"])) == BAD
    n_robust_records = len(tr.robust_records)
    tr.close()
    rows.append({"kind": "robust_measured", "cell": "corrupt_robust",
                 "final_loss": rob_loss, "effective_samples": rob_samples,
                 "state_finite": rob_finite, "rollbacks": rollbacks,
                 "robust_records": n_robust_records,
                 "max_anomaly_score": float(max_score),
                 "anomalous_is_corrupt_learner": bool(anomalous_is_bad)})

    # robust hooks off == bitwise identity
    short = max(steps // 2, 8)
    tr_a = make_trainer(short, **inputs)
    tr_a.run(log=None)
    tr_b = make_trainer(short, robust=INERT, **inputs)
    tr_b.run(log=None)
    bitwise_off = all(torch.equal(getattr(tr_a.state, f),
                                  getattr(tr_b.state, f)) for f in PLANES)
    tr_a.close()
    tr_b.close()
    rows.append({"kind": "robust_measured", "cell": "robust_off",
                 "bitwise_identical": bitwise_off})

    for r in rows:
        print("robust," + ",".join(f"{k}={v}" for k, v in r.items()
                                   if k != "kind"))

    bar = base_loss_at(rob_samples)
    gap = rob_loss / bar
    # the corrupted plain mean must be demonstrably worse than the robust
    # run, or the corruption is too weak for the 5 % bound to mean much
    mean_degrades = mean_gap > 1.5 * max(gap, 1.0)
    accept = {
        "kind": "robust_accept",
        "loss_fault_free": bar,
        "loss_fault_free_full": base_loss,
        "loss_robust": rob_loss,
        "loss_mean_corrupt": mean_loss,
        "loss_vs_fault_free": gap,
        "within_5pct": bool(gap <= 1.05),
        "mean_degrades": bool(mean_degrades),
        "samples_vs_fault_free": rob_samples / max(base_samples, 1),
        "rollbacks": rollbacks,
        "state_finite": bool(rob_finite),
        "bitwise_off": bitwise_off,
        "anomalous_is_corrupt_learner": bool(anomalous_is_bad),
        "ok": bool(gap <= 1.05 and mean_degrades and rollbacks == 0
                   and rob_finite and bitwise_off and anomalous_is_bad),
    }
    rows.append(accept)
    print(f"robust_accept,loss_vs_fault_free,{gap:.3f},within_5pct,"
          f"{accept['within_5pct']},mean_degrades,{mean_degrades},"
          f"rollbacks,{rollbacks},bitwise_off,{bitwise_off},"
          f"anomalous_is_corrupt_learner,{anomalous_is_bad}")
    return rows


def main(quick: bool = False, json_path: Optional[str] = None,
         device="cuda", params: Optional[dict] = None,
         batch_at: Optional[Callable] = None) -> list[dict]:
    rows = measured(quick, device, params, batch_at)
    if json_path:
        write_rows(json_path, rows, suite="robust")
        print(f"wrote {len(rows)} rows to {json_path}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="few steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every row as the JSONL envelope")
    args = ap.parse_args()
    main(quick=args.quick, json_path=args.json, device=args.device)
