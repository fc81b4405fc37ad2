"""Meta-communication benchmark: bytes on the wire, final loss and meta
step time per compression scheme (the JAX package's
``benchmarks/comm_bench.py``, on ``repro_torch.comm``).

Two layers of numbers:

1. *Measured*: the MLP trained under each of the five schemes (dense,
   int8, fp8, topk, int8_topk; error feedback on every compressed one),
   P=4, K=4, mu 0.7, 15 meta steps in quick mode and 60 otherwise: the
   reducer's own ``comm_bytes``, the compression against dense, the final
   loss and accuracy, and the median time of one meta step on a fixed
   batch. On the card that time is the card's (printed with its name).
2. *Modeled*: ``roofline.meta_wire_bytes`` of a full-scale config
   (qwen3-1.7b, P=8): bytes and compression per scheme at production
   size, and the link seconds of those bytes on the intra-node link
   (the reference's form, its TPU link rate replaced by the H100 data
   sheet's NVLink 4 rate, ``roofline.terms.H100_SXM``: an input, not a
   measurement).

Prints the reference's ``comm,...`` lines.

  PYTHONPATH=src python -m repro_torch.benchmarks.comm_bench --quick \\
      [--device cpu]

``params``, ``batch_at(i)``, ``eval_set`` and ``dither`` replace the
port's own draws in every measured run (a parity test passes JAX's
params, batches and stochastic-rounding dither).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.benchmarks.common import (
    CLASSES,
    D_IN,
    HIDDEN,
    run_mlp,
    timeit,
)
from repro_torch.configs.base import CommConfig, MAvgConfig, get_config
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.data import classif_batch_fn
from repro_torch.models.simple import mlp_init, mlp_loss
from repro_torch.roofline import H100_SXM, meta_wire_bytes
from repro_torch.topology import make_topology
from repro_torch.utils.rng import seeded_generator
from repro_torch.utils.tree import tree_map

SCHEMES = ("dense", "int8", "fp8", "topk", "int8_topk")
LINK_RATES = (f"link seconds at {H100_SXM.name}: intra-node "
              f"{H100_SXM.intra_link_bytes_per_s / 1e9:.0f} GB/s (NVLink 4), "
              f"inter-node {H100_SXM.inter_link_bytes_per_s / 1e9:.0f} GB/s "
              f"(ConnectX-7 NDR); inputs, not measured")


def _comm(scheme: str) -> CommConfig:
    return CommConfig(scheme=scheme, error_feedback=scheme != "dense")


def measured(quick: bool, *, P=4, K=4, mu=0.7, device="cuda",
             params: Optional[dict] = None,
             batch_at: Optional[Callable] = None,
             eval_set: Optional[dict] = None, dither=None) -> list[dict]:
    steps = 15 if quick else 60
    where = (torch.cuda.get_device_name(torch.device(device))
             if torch.device(device).type == "cuda" else "cpu")
    rows, dense_loss = [], None
    for scheme in SCHEMES:
        comm = _comm(scheme)
        losses, acc = run_mlp("mavg", P=P, K=K, mu=mu, steps=steps,
                              comm=comm, device=device, params=params,
                              batch_at=batch_at, eval_set=eval_set,
                              dither=dither)

        # one meta step on a fixed batch, for its time and its metrics
        cfg = MAvgConfig(algorithm="mavg", num_learners=P, k_steps=K,
                         learner_lr=0.2, momentum=mu, comm=comm)
        p0 = (mlp_init(seeded_generator(device, 0), D_IN, HIDDEN, CLASSES,
                       device=device) if params is None else params)
        b = (classif_batch_fn(D_IN, CLASSES, P, K, 16, device=device)(
            seeded_generator(device, 1), 0) if batch_at is None
            else batch_at(0))
        b = tree_map(lambda x: x.to(device), b)
        topo = make_topology(cfg, dither=dither)
        state = init_state(p0, cfg, topology=topo)
        step = make_meta_step(mlp_loss, cfg, topology=topo)
        _, m = step(state, b)
        wire = float(m["comm_bytes"])
        dense_b = float(m["comm_bytes_dense"])
        t_us = timeit(lambda s, bb: step(s, bb)[0], state, b,
                      iters=3 if quick else 10, warmup=1)

        final = sum(losses[-5:]) / len(losses[-5:])
        if scheme == "dense":
            dense_loss = final
        rows.append({"kind": "comm_measured", "scheme": scheme,
                     "bytes_wire": wire, "compression": dense_b / wire,
                     "step_time_us": t_us, "device": where,
                     "final_loss": final, "vs_dense": final / dense_loss,
                     "val_acc": acc, "losses": losses})
        print(f"comm,{scheme},bytes_wire,{wire:.0f},B")
        print(f"comm,{scheme},compression,{dense_b / wire:.2f},x")
        print(f"comm,{scheme},step_time,{t_us:.0f},us,{where}")
        print(f"comm,{scheme},final_loss,{final:.4f},"
              f"{final / dense_loss:.3f}x_dense")
        print(f"comm,{scheme},val_acc,{acc:.3f},frac")
    return rows


def modeled(arch: str = "qwen3-1.7b", P: int = 8) -> list[dict]:
    n = get_config(arch).param_count()
    rows = []
    for scheme in SCHEMES:
        dense, wire = meta_wire_bytes(n, _comm(scheme), num_learners=P)
        wire_s = wire / H100_SXM.intra_link_bytes_per_s
        rows.append({"kind": "comm_model", "arch": arch, "scheme": scheme,
                     "dense_bytes": dense, "wire_bytes": wire,
                     "compression": dense / wire, "wire_s": wire_s})
        print(f"comm_model,{arch},{scheme},{wire:.3e},B,"
              f"{dense / wire:.2f},x,{wire_s:.4f},s")
    print(f"comm_model,{LINK_RATES}")
    return rows


def main(quick: bool = False, device="cuda") -> None:
    measured(quick, device=device)
    modeled()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="few steps / few timing iters")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
