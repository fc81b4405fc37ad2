"""E4, the paper's section-IV baseline comparison: (K/M)-AVG against
Downpour and EAMSGD (and synchronous MSGD and the learner-momentum
variant) at equal samples (the JAX package's ``benchmarks/baselines.py``,
with its cases, settings, target and assertion).

  PYTHONPATH=src python -m repro_torch.benchmarks.baselines --quick \\
      [--device cpu]

Every arm trains the teacher-classification MLP at P=4, K=4 (sync: K=1
and four times the steps), B=8, lr 0.15; eamsgd and downpour run on the
async server (``repro_torch.topology.async_server``), as aliases. The
metric is samples to the 1.1 loss target, (ticks) x P x K x B as in the
reference. ``main`` prints the reference's CSV lines and asserts what it
asserts: M-AVG reaches the target, in at most 1.5x the samples of
downpour and of eamsgd wherever those reach it.

Where the port departs from the reference: a tick on which no learner
completes a block (downpour's first ``staleness`` ticks, when every
clock is still filling) runs no local step, and the meta step reports
loss 0 for it, in both packages. The reference's running minimum takes
that 0 as a loss under the target, so its downpour arm "reaches" 1.1 at
128 samples and its own assertion fails (quick mode, in JAX too). The
port reads those ticks as no measurement: the topology's host replay
(``work_completed``) finds them, and the running minimum skips them.

The port draws its own initial params and batches from generators seeded
as ``common.run_mlp`` seeds them, which differ from JAX's streams; a
parity test feeds ``run_mlp`` JAX's inputs instead.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import run_mlp, samples_to_target
from repro_torch.configs.base import MAvgConfig
from repro_torch.topology import make_topology

CASES = [
    ("mavg", dict(mu=0.7)),
    ("kavg", dict(mu=0.0)),
    ("mavg_mlocal", dict(mu=0.5, local_momentum=0.5)),
    ("sync", dict(mu=0.7)),           # K forced to 1 below
    ("eamsgd", dict(mu=0.7, elastic_alpha=0.05)),
    ("downpour", dict(mu=0.0, staleness=2)),
]
TARGET = 1.1
P, B, LR = 4, 8, 0.15


def settings(algo: str, quick: bool) -> dict:
    """The run_mlp settings of one arm."""
    steps = 40 if quick else 80
    K = 1 if algo == "sync" else 4
    return dict(P=P, K=K, lr=LR, steps=steps * (4 if algo == "sync" else 1),
                batch=B)


def idle_ticks(algo: str, st: dict, kw: dict) -> list[bool]:
    """Per tick of an arm, True where no learner completed a K-step block
    (so none ran a local step): the host replay of the arm's topology."""
    topo = make_topology(MAvgConfig(
        algorithm=algo, num_learners=st["P"], k_steps=st["K"],
        momentum=kw["mu"], staleness=kw.get("staleness", 1)))
    done = [topo.work_completed(i) for i in range(st["steps"])]
    return [b == a for a, b in zip([0] + done, done)]


def main(quick: bool = False, device="cuda") -> dict:
    """Returns {algo: (final loss, val acc, samples to target or None)}."""
    results = {}
    for algo, kw in CASES:
        st = settings(algo, quick)
        losses, acc = run_mlp(algo, device=device, **st, **kw)
        measured = [float("nan") if idle else x
                    for x, idle in zip(losses, idle_ticks(algo, st, kw))]
        stt = samples_to_target(measured, TARGET, P, st["K"], B)
        results[algo] = (losses[-1], acc, stt)
        print(f"baselines,{algo},final_loss={losses[-1]:.4f},"
              f"val_acc={acc:.4f},samples_to_{TARGET}={stt}")
    # M-AVG reaches the target, at worst within 1.5x of the stale and
    # elastic baselines' samples wherever they reach it
    assert results["mavg"][2] is not None
    for other in ("downpour", "eamsgd"):
        if results[other][2]:
            assert results["mavg"][2] <= 1.5 * results[other][2], (
                results["mavg"][2], other, results[other][2])
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
