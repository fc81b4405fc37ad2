"""E2, the paper's Figures 9-12 and Lemma 6: with more learners P, the
best block momentum mu grows (and a very large mu pays only at large P).

The JAX package's ``benchmarks/mu_p_sweep.py`` on the port, with its
grid, settings, seeds and assertion: M-AVG on the teacher-classification
MLP for P in (2, 4, 8, 16) by mu in (0, 0.3, 0.5, 0.7, 0.9), K=4, lr
0.15, B=8, 40 meta steps in quick mode (one seed) and 80 otherwise (seeds
0, 1, 2, accuracies averaged). ``main`` prints the reference's CSV lines
and asserts that the best mu at P=16 is at least the best at P=2.

  PYTHONPATH=src python -m repro_torch.benchmarks.mu_p_sweep --quick \\
      [--device cpu]

``inputs(P=, K=, batch=, seed=)`` may return ``run_mlp`` keyword
overrides (``params``, ``batch_at``, ``eval_set``) for each run: a parity
test passes JAX's. By default the port draws its own from generators
seeded as ``common.run_mlp`` seeds them, which differ from JAX's streams.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from repro_torch.benchmarks.common import run_mlp

MUS = (0.0, 0.3, 0.5, 0.7, 0.9)
PS = (2, 4, 8, 16)
K, LR, BATCH = 4, 0.15, 8


def sweep(quick: bool = False, seeds=(0, 1, 2), device="cuda",
          inputs: Optional[Callable] = None, log=print):
    """The (P, mu) -> mean validation accuracy table, and each run's
    losses under the same key (a list a seed)."""
    steps = 40 if quick else 80
    if quick:
        seeds = seeds[:1]
    table, curves = {}, {}
    for P in PS:
        for mu in MUS:
            accs, curves[(P, mu)] = [], []
            for s in seeds:
                extra = inputs(P=P, K=K, batch=BATCH, seed=s) if inputs else {}
                losses, acc = run_mlp("mavg", P=P, K=K, mu=mu, lr=LR,
                                      steps=steps, batch=BATCH, seed=s,
                                      device=device, **extra)
                accs.append(acc)
                curves[(P, mu)].append(losses)
            table[(P, mu)] = float(np.mean(accs))
            log(f"mu_p_sweep,P={P},mu={mu},val_acc={table[(P, mu)]:.4f}")
    return table, curves


def best_mu(table) -> dict:
    """The best mu per P (the first of equal accuracies, as ``max``)."""
    return {P: max(MUS, key=lambda m: table[(P, m)]) for P in PS}


def main(quick: bool = False, seeds=(0, 1, 2), device="cuda",
         inputs: Optional[Callable] = None, log=print):
    """Returns (table, best mu per P); asserts Lemma 6's direction."""
    table, _ = sweep(quick, seeds, device, inputs, log)
    best = best_mu(table)
    log("mu_p_sweep,best_mu_per_P," +
        ",".join(f"P{P}={best[P]}" for P in PS))
    # Lemma 6 direction: the optimal mu is non-decreasing-ish in P
    assert best[PS[-1]] >= best[PS[0]], best
    return table, best


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
