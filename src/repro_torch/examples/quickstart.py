"""Quickstart: the paper's algorithm on the port in a few lines.

Trains a small MLP on the synthetic teacher-classification stream with
M-AVG (Algorithm 1) and its K-AVG baseline, printing loss-per-samples
curves that show the block-momentum acceleration (the JAX package's
``examples/quickstart.py``, through the E1 runner's ``run_mlp``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import run_mlp

P, K, B = 4, 4, 16  # learners, local steps, batch


def train(algorithm: str, momentum: float, steps: int = 60, device="cuda"):
    losses, acc = run_mlp(algorithm, P=P, K=K, mu=momentum, lr=0.2,
                          steps=steps, batch=B, seed=0, device=device)
    for i in range(0, steps, 10):
        samples = (i + 1) * P * K * B
        print(f"  {algorithm:5s} samples={samples:6d} loss={losses[i]:.4f}")
    return losses, acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("K-AVG (the baseline: mu = 0)")
    k_losses, k_acc = train("kavg", 0.0, device=args.device)
    print("M-AVG (the paper: block momentum mu = 0.7)")
    m_losses, m_acc = train("mavg", 0.7, device=args.device)
    print(f"\nfinal: K-AVG loss={k_losses[-1]:.4f} acc={k_acc:.3f} | "
          f"M-AVG loss={m_losses[-1]:.4f} acc={m_acc:.3f}")
    print("M-AVG reaches the same loss with "
          f"~{sum(l > k_losses[-1] for l in m_losses) / len(m_losses):.0%}"
          " of the samples.")
    return k_losses, m_losses


if __name__ == "__main__":
    main()
