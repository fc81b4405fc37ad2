"""Elastic and heterogeneous execution (the JAX package's
``benchmarks/elastic_bench.py``, on ``repro_torch.topology``).

Three layers of numbers:

1. *Measured churn*: final loss and accuracy of the teacher-
   classification MLP (P=8, K=4, mu 0.7; 20 meta steps in quick mode, 80
   otherwise) under deterministic learner dropout (12.5-37.5 % churn)
   against each cell's own static topology at equal meta steps. The
   acceptance row: 25 % churn on the hierarchical topology within 5 % of
   its static loss.
2. *Heterogeneous K*: per-group ``group_k`` cells, uniform and skewed,
   the Lemma-5 trade-off per group.
3. *Modeled*: ``roofline.topology_wire_bytes`` of qwen3-1.7b with the
   degree-over-time wire model: inter-node bytes, the time-averaged
   degree and the learner and edge presence under churn, and ``wire_s``,
   those bytes at the H100 data sheet's link rates
   (``roofline.terms.H100_SXM``: inputs, not measured).

Prints the reference's ``elastic,...`` lines; ``--json PATH`` writes every
row as the run-log envelope (suite ``elastic_bench``; no gate file).

  PYTHONPATH=src python -m repro_torch.benchmarks.elastic_bench --quick \\
      [--device cpu] [--json PATH]

``params``, ``batch_at(i)`` and ``eval_set`` replace the port's own draws
in every run (a parity test passes JAX's).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch.benchmarks.common import run_mlp, write_rows
from repro_torch.benchmarks.comm_bench import LINK_RATES
from repro_torch.configs.base import (
    CommConfig,
    ElasticConfig,
    TopologyConfig,
    get_config,
)
from repro_torch.roofline import topology_wire_bytes, wire_seconds

P, K, MU = 8, 4, 0.7


def _drop(frac):
    return ElasticConfig(period=8, drop_frac=frac)


# churn sweep: name -> (TopologyConfig, baseline cell); each elastic cell
# is scored against its own static topology at equal meta steps
CHURN_CELLS = (
    ("gossip_ring_static", TopologyConfig(kind="gossip", graph="ring"),
     None),
    ("gossip_ring_drop12", TopologyConfig(kind="gossip", graph="ring",
                                          elastic=_drop(0.125)),
     "gossip_ring_static"),
    ("gossip_ring_drop25", TopologyConfig(kind="gossip", graph="ring",
                                          elastic=_drop(0.25)),
     "gossip_ring_static"),
    ("gossip_ring_drop37", TopologyConfig(kind="gossip", graph="ring",
                                          elastic=_drop(0.375)),
     "gossip_ring_static"),
    ("gossip_exp_static", TopologyConfig(kind="gossip",
                                         graph="exponential"), None),
    ("gossip_exp_drop25", TopologyConfig(kind="gossip", graph="exponential",
                                         elastic=_drop(0.25)),
     "gossip_exp_static"),
    ("gossip_one_peer", TopologyConfig(kind="gossip",
                                       graph="one_peer_exponential"),
     "gossip_ring_static"),
    ("hier_static", TopologyConfig(kind="hierarchical", groups=2,
                                   outer_every=2), None),
    ("hier_drop25", TopologyConfig(kind="hierarchical", groups=2,
                                   outer_every=2, elastic=_drop(0.25)),
     "hier_static"),
)

# heterogeneous K (Lemma 5 per group): uniform cells bracket the skewed
HETERO_K_CELLS = (
    ("group_k_1_1", (1, 1)),
    ("group_k_2_2", (2, 2)),
    ("group_k_4_4", (4, 4)),
    ("group_k_1_4", (1, 4)),
    ("group_k_2_4", (2, 4)),
    ("group_k_4_1", (4, 1)),
)

MODEL_CELLS = (
    ("flat_dense", TopologyConfig()),
    ("gossip_ring", TopologyConfig(kind="gossip", graph="ring")),
    ("gossip_exponential", TopologyConfig(kind="gossip",
                                          graph="exponential")),
    ("gossip_one_peer", TopologyConfig(kind="gossip",
                                       graph="one_peer_exponential")),
    ("gossip_ring_drop25", TopologyConfig(kind="gossip", graph="ring",
                                          elastic=_drop(0.25))),
    ("hier_drop25", TopologyConfig(kind="hierarchical", groups=2,
                                   outer_every=2, elastic=_drop(0.25))),
)


def measured_churn(quick: bool, device="cuda", **inputs) -> list[dict]:
    steps = 20 if quick else 80
    rows, finals = [], {}
    for name, topo, baseline in CHURN_CELLS:
        losses, acc = run_mlp("mavg", P=P, K=K, mu=MU, steps=steps,
                              topology=topo, device=device, **inputs)
        final = sum(losses[-5:]) / len(losses[-5:])
        finals[name] = final
        drop = topo.elastic.drop_frac if topo.elastic else 0.0
        vs = final / finals[baseline] if baseline else 1.0
        rows.append({
            "kind": "elastic_measured", "cell": name,
            "topology": topo.kind, "graph": topo.graph, "drop_frac": drop,
            "final_loss": final, "vs_static": vs,
            "val_acc": acc, "meta_steps": steps,
        })
        print(f"elastic,{name},final_loss,{final:.4f},{vs:.3f}x_static")
        print(f"elastic,{name},val_acc,{acc:.3f},frac")
    # acceptance: the group average renormalizes over present members, so
    # 25 % churn on the hierarchical cell lands within 5 % of static
    accept = next(r for r in rows if r["cell"] == "hier_drop25")
    rows.append({"kind": "elastic_accept",
                 "loss_vs_static_at_25pct_churn": accept["vs_static"],
                 "within_5pct": bool(accept["vs_static"] <= 1.05)})
    print(f"elastic_accept,hier_drop25_vs_static,{accept['vs_static']:.3f},"
          f"within_5pct,{accept['vs_static'] <= 1.05}")
    return rows


def measured_hetero_k(quick: bool, device="cuda", **inputs) -> list[dict]:
    steps = 20 if quick else 80
    rows = []
    for name, gk in HETERO_K_CELLS:
        topo = TopologyConfig(kind="hierarchical", groups=2, outer_every=2,
                              group_k=gk)
        losses, acc = run_mlp("mavg", P=P, K=K, mu=MU, steps=steps,
                              topology=topo, device=device, **inputs)
        final = sum(losses[-5:]) / len(losses[-5:])
        # samples consumed follow the per-group step counts
        samples = steps * (P // 2) * sum(gk) * 16
        rows.append({
            "kind": "hetero_k_measured", "cell": name, "group_k": list(gk),
            "final_loss": final, "val_acc": acc, "samples": samples,
            "loss_per_ksample": final / max(samples / 1e3, 1e-9),
        })
        print(f"elastic,{name},final_loss,{final:.4f},samples,{samples}")
    return rows


def modeled(arch: str = "qwen3-1.7b", num_learners: int = P) -> list[dict]:
    n = get_config(arch).param_count()
    rows = []
    for name, topo in MODEL_CELLS:
        edge = topology_wire_bytes(n, CommConfig(), topo,
                                   num_learners=num_learners)
        wire_s = wire_seconds(edge["intra_bytes"], edge["inter_bytes"])
        rows.append({"kind": "elastic_model", "cell": name, "arch": arch,
                     **edge, "wire_s": wire_s})
        print(f"elastic_model,{arch},{name},inter,{edge['inter_bytes']:.3e},B,"
              f"avg_deg,{edge['avg_degree']:.1f},"
              f"edge_presence,{edge['edge_presence']:.3f},"
              f"{wire_s:.4f},s")
    print(f"elastic_model,{LINK_RATES}")
    return rows


def main(quick: bool = False, json_path: Optional[str] = None,
         device="cuda", params: Optional[dict] = None,
         batch_at: Optional[Callable] = None,
         eval_set: Optional[dict] = None) -> list[dict]:
    inputs = dict(params=params, batch_at=batch_at, eval_set=eval_set)
    rows = (measured_churn(quick, device, **inputs)
            + measured_hetero_k(quick, device, **inputs) + modeled())
    if json_path:
        write_rows(json_path, rows, suite="elastic_bench")
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
