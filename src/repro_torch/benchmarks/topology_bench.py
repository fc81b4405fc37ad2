"""Topology benchmark: convergence and per-edge-class wire bytes of the
meta-mixing topologies, swept over topology x comm scheme (the JAX
package's ``benchmarks/topology_bench.py``, on ``repro_torch.topology``).

Two layers of numbers:

1. *Measured*: final loss and accuracy of the teacher-classification MLP
   (P=8, K=4, mu 0.7; 20 meta steps in quick mode, 80 otherwise) in each
   of six cells: flat dense, flat int8, hierarchical dense, hierarchical
   with int8_topk cross-group traffic (the acceptance cell), gossip ring
   and gossip exponential with momentum tracking.
2. *Modeled*: ``roofline.topology_wire_bytes`` of a full-scale config
   (qwen3-1.7b): intra- and inter-node bytes a meta step per cell, and
   the acceptance row, flat dense's inter-node bytes over the
   hierarchical int8_topk cell's (``benchmarks/expected/topology.json``:
   at least 50x). The reference also prices those bytes at a TPU pod's
   link rates; those seconds are left out here (ROADMAP Queue 1, item 10).

Prints the reference's ``topo,...`` lines; ``--json PATH`` writes every
row as the run-log envelope (suite ``topology_bench``, as the reference's;
the gate applies through ``run.py``'s ``BENCH_topology.json``).

  PYTHONPATH=src python -m repro_torch.benchmarks.topology_bench --quick \\
      [--device cpu] [--json PATH]

``params``, ``batch_at(i)``, ``eval_set`` and ``dither`` replace the
port's own draws in every measured cell (a parity test passes JAX's).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch.benchmarks.common import run_mlp, write_rows
from repro_torch.benchmarks.comm_bench import NO_LINK_RATE
from repro_torch.configs.base import CommConfig, TopologyConfig, get_config
from repro_torch.roofline import topology_wire_bytes

P, K, MU = 8, 4, 0.7

# the sweep: name -> (TopologyConfig, CommConfig)
CELLS = (
    ("flat_dense", TopologyConfig(), CommConfig()),
    ("flat_int8", TopologyConfig(),
     CommConfig(scheme="int8", error_feedback=True)),
    # mu_out = 0 on purpose, as in the reference: the inner level already
    # carries the block momentum
    ("hier_dense", TopologyConfig(kind="hierarchical", groups=2,
                                  outer_every=2),
     CommConfig()),
    # the acceptance cell: dense intra-group, int8_topk cross-group
    ("hier_int8topk_outer",
     TopologyConfig(kind="hierarchical", groups=2, outer_every=2,
                    outer_comm=CommConfig(scheme="int8_topk",
                                          error_feedback=True)),
     CommConfig()),
    ("gossip_ring", TopologyConfig(kind="gossip", graph="ring"), CommConfig()),
    ("gossip_exp_mt", TopologyConfig(kind="gossip", graph="exponential",
                                     momentum_tracking=True), CommConfig()),
)


def measured(quick: bool, device="cuda", params: Optional[dict] = None,
             batch_at: Optional[Callable] = None,
             eval_set: Optional[dict] = None, dither=None) -> list[dict]:
    steps = 20 if quick else 80
    rows, flat_loss = [], None
    for name, topo, comm in CELLS:
        losses, acc = run_mlp("mavg", P=P, K=K, mu=MU, steps=steps,
                              comm=comm, topology=topo, device=device,
                              params=params, batch_at=batch_at,
                              eval_set=eval_set, dither=dither)
        final = sum(losses[-5:]) / len(losses[-5:])
        if name == "flat_dense":
            flat_loss = final
        rows.append({
            "kind": "topo_measured", "cell": name,
            "topology": topo.kind, "graph": topo.graph,
            "groups": topo.groups, "outer_every": topo.outer_every,
            "final_loss": final, "vs_flat": final / flat_loss,
            "val_acc": acc, "meta_steps": steps,
        })
        print(f"topo,{name},final_loss,{final:.4f},"
              f"{final / flat_loss:.3f}x_flat")
        print(f"topo,{name},val_acc,{acc:.3f},frac")
    return rows


def modeled(arch: str = "qwen3-1.7b", num_learners: int = P) -> list[dict]:
    n = get_config(arch).param_count()
    rows = []
    for name, topo, comm in CELLS:
        edge = topology_wire_bytes(n, comm, topo, num_learners=num_learners)
        rows.append({"kind": "topo_model", "cell": name, "arch": arch,
                     **edge})
        print(f"topo_model,{arch},{name},intra,{edge['intra_bytes']:.3e},B,"
              f"inter,{edge['inter_bytes']:.3e},B")
    print(f"topo_model,{NO_LINK_RATE}")
    flat = next(r for r in rows if r["cell"] == "flat_dense")
    hier = next(r for r in rows if r["cell"] == "hier_int8topk_outer")
    ratio = flat["inter_bytes"] / max(hier["inter_bytes"], 1.0)
    rows.append({"kind": "topo_accept", "arch": arch,
                 "inter_reduction_vs_flat": ratio})
    print(f"topo_accept,{arch},inter_reduction,{ratio:.1f},x")
    return rows


def main(quick: bool = False, json_path: Optional[str] = None,
         device="cuda", params: Optional[dict] = None,
         batch_at: Optional[Callable] = None,
         eval_set: Optional[dict] = None, dither=None) -> list[dict]:
    rows = measured(quick, device, params, batch_at, eval_set,
                    dither) + modeled()
    if json_path:
        write_rows(json_path, rows, suite="topology_bench")
        print(f"wrote {len(rows)} rows to {json_path}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="few steps / few timing iters")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every row as the JSONL envelope")
    args = ap.parse_args()
    main(quick=args.quick, json_path=args.json, device=args.device)
