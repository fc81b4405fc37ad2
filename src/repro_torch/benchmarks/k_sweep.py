"""E3, the paper's Lemmas 5 and 7: at a fixed sample budget S = N K,
(a) the best K is above 1 (communication can be delayed for free or
better), and (b) momentum shifts the best K down (K_opt(mu) <= K_opt(0)).

The JAX package's ``benchmarks/k_sweep.py`` on the port, with its grid,
settings, seeds and three assertions: M-AVG on the teacher-classification
MLP, P=4, lr 0.15, B=8, K in (1, 2, 4, 8, 16) at N = 128 / K meta steps,
mu 0 and 0.7, one seed in quick mode and seeds 0, 1, 2 otherwise.

The time proxy prices a meta step at K + comm_ratio local steps. Its
``comm_ratio=14.0`` is the reference's model input, the collective over
compute term of a TPU dry run (qwen3-1.7b, train_4k, single-pod mesh): it
is printed as such, is not measured here and is no speed figure of the
port. An H100 ratio belongs to the roofline of ROADMAP Queue 1, item 10.

  PYTHONPATH=src python -m repro_torch.benchmarks.k_sweep --quick \\
      [--device cpu]

``inputs(P=, K=, batch=, seed=)`` may return ``run_mlp`` keyword
overrides (``params``, ``batch_at``, ``eval_set``) for each run: a parity
test passes JAX's. By default the port draws its own from seeded
generators, which differ from JAX's streams.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from repro_torch.benchmarks.common import run_mlp

KS = (1, 2, 4, 8, 16)
TOTAL_LOCAL_STEPS = 128  # S = N * K held constant
P, BATCH = 4, 8
COMM_RATIO = 14.0  # the reference's TPU dry-run input, not measured here


def sweep(mu, seeds=(0, 1, 2), lr=0.15, device="cuda",
          inputs: Optional[Callable] = None, log=print):
    """K -> mean validation accuracy at mu, and each run's losses."""
    accs, curves = {}, {}
    for K in KS:
        N = TOTAL_LOCAL_STEPS // K
        vals, curves[K] = [], []
        for s in seeds:
            extra = inputs(P=P, K=K, batch=BATCH, seed=s) if inputs else {}
            losses, acc = run_mlp("mavg", P=P, K=K, mu=mu, lr=lr, steps=N,
                                  batch=BATCH, seed=s, device=device,
                                  **extra)
            vals.append(acc)
            curves[K].append(losses)
        accs[K] = float(np.mean(vals))
        log(f"k_sweep,mu={mu},K={K},N={N},val_acc={accs[K]:.4f}")
    return accs, curves


def time_proxy(comm_ratio: float) -> dict:
    """Simulated wall clock to equal samples: N meta steps cost
    N (K t_local + t_comm), with t_comm = comm_ratio t_local."""
    return {K: (TOTAL_LOCAL_STEPS // K) * (K + comm_ratio) for K in KS}


def main(quick: bool = False, comm_ratio: float = COMM_RATIO, device="cuda",
         inputs: Optional[Callable] = None, log=print):
    """Returns (accuracies at mu 0, at mu 0.7, K_opt with the comm cost);
    asserts Lemmas 5 and 7 as the reference does."""
    seeds = (0,) if quick else (0, 1, 2)
    acc0, _ = sweep(0.0, seeds, device=device, inputs=inputs, log=log)
    acc7, _ = sweep(0.7, seeds, device=device, inputs=inputs, log=log)
    k_opt0 = max(acc0, key=acc0.get)
    k_opt7 = max(acc7, key=acc7.get)
    log(f"k_sweep,K_opt_statistical(mu=0)={k_opt0},K_opt(mu=0.7)={k_opt7}")
    # Lemma 5, statistical side: K > 1 loses (almost) nothing per sample
    assert max(acc0[k] for k in KS if k > 1) >= acc0[1] - 0.02
    # Lemma 7: momentum prefers an equal or smaller K
    assert k_opt7 <= max(k_opt0, 8), (k_opt0, k_opt7)
    # ...and K > 1 wins outright once communication is priced in
    times = time_proxy(comm_ratio)
    eff = {K: acc0[K] / times[K] for K in KS}
    k_opt_time = max(eff, key=eff.get)
    log(f"k_sweep,comm_ratio={comm_ratio},reference TPU dry-run ratio, "
        f"not measured here")
    for K in KS:
        log(f"k_sweep,time_proxy,K={K},time={times[K]},acc_per_time="
            f"{eff[K]:.2e}")
    log(f"k_sweep,K_opt_with_comm_cost={k_opt_time}")
    assert k_opt_time > 1
    return acc0, acc7, k_opt_time


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
