"""The paper's tuning guidelines as a runnable study (Lemmas 6 and 7; the
JAX package's ``examples/momentum_tuning.py``):

1. more learners -> use a larger momentum mu
2. switching K-AVG -> M-AVG -> use a smaller K

  PYTHONPATH=src python -m repro_torch.examples.momentum_tuning \\
      [--device cpu]

``inputs(P=, K=, batch=, seed=)`` may return ``run_mlp`` keyword
overrides for each run (a parity test passes JAX's draws).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import run_mlp


def _run(P, K, mu, steps, device, inputs):
    extra = inputs(P=P, K=K, batch=8, seed=0) if inputs else {}
    return run_mlp("mavg", P=P, K=K, mu=mu, steps=steps, batch=8,
                   device=device, **extra)[1]


def guideline_1(device="cuda", inputs=None) -> dict:
    print("Guideline 1 (Lemma 6): optimal mu grows with P")
    best = {}
    for P in (2, 8):
        accs = {}
        for mu in (0.0, 0.5, 0.9):
            accs[mu] = _run(P, 4, mu, 60, device, inputs)
            print(f"  P={P} mu={mu}: val_acc={accs[mu]:.3f}")
        best[P] = max(accs, key=accs.get)
        print(f"  -> best mu at P={P}: {best[P]}")
    return best


def guideline_2(device="cuda", inputs=None) -> dict:
    print("Guideline 2 (Lemma 7): momentum prefers smaller K (S = N*K fixed)")
    best = {}
    for mu in (0.0, 0.7):
        accs = {}
        for K in (2, 8):
            accs[K] = _run(4, K, mu, 128 // K, device, inputs)
            print(f"  mu={mu} K={K}: val_acc={accs[K]:.3f}")
        best[mu] = max(accs, key=accs.get)
        print(f"  -> best K at mu={mu}: {best[mu]}")
    return best


def main(argv=None, inputs=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return (guideline_1(args.device, inputs),
            guideline_2(args.device, inputs))


if __name__ == "__main__":
    main()
