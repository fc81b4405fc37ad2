"""The async bounded-staleness server against the synchronous barrier (the
JAX package's ``benchmarks/async_bench.py``, its measured part).

Under a skewed per-learner step-time profile the barrier pays the
straggler's block time every round (idle share 1 - mean/max of the
profile), while the async server keeps every learner busy and applies
pushes with staleness-decayed weight. Three arms at equal effective
samples (completed K-step blocks x K x batch), on the teacher-
classification MLP, P=8, K=4, mu 0.7, lr 0.2, B=16:

  sync     flat M-AVG: the barrier, charged max(profile) ticks a round
  async    the server on the 4x-skewed profile (1,1,1,1,2,2,4,4), tau 3,
           one tick a meta step, run until it has completed as many
           blocks as the sync arm
  elastic  masking the stragglers out instead of waiting for them
           (hierarchical, 25 % absent): runs at the fast learners' pace
           but throws the absentees' samples away

``main`` prints the reference's ``async,...`` CSV lines and asserts the
reference's acceptance (its ``benchmarks/expected/async.json``): the async
arm's final loss within 5 % of the sync arm's, applied staleness <= tau on
every tick, the barrier idling >= 40 % of the ticks, and the async arm at
least 1.5x fewer ticks than the barrier. Then the modeled rows: the
per-tick wire bytes of flat dense, the uniform and the skewed async
server on qwen3-1.7b (``roofline.topology_wire_bytes``; the gate holds
``async_skew4``'s inter-node bytes), with ``wire_s``, those bytes at the
H100 data sheet's link rates (``roofline.terms.H100_SXM``: inputs, not
measured). ``--json PATH`` writes every row as the run-log envelope
(suite ``async``).

  PYTHONPATH=src python -m repro_torch.benchmarks.async_bench --quick \\
      [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.benchmarks.common import (
    CLASSES,
    D_IN,
    HIDDEN,
    seeded_batches,
    write_rows,
)
from repro_torch.benchmarks.comm_bench import LINK_RATES
from repro_torch.configs.base import (
    AsyncConfig,
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    TopologyConfig,
    get_config,
)
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.data import classif_batch_fn, classif_eval_set
from repro_torch.models.simple import mlp_accuracy, mlp_init, mlp_loss
from repro_torch.pack import unpack_params
from repro_torch.roofline import topology_wire_bytes, wire_seconds
from repro_torch.topology import make_topology
from repro_torch.utils.rng import seeded_generator

P, K, MU, LR, BATCH = 8, 4, 0.7, 0.2, 16

# 4x skew: half the learners at full speed, a 2x and a 4x straggler pair
PROFILE = (1, 1, 1, 1, 2, 2, 4, 4)
TAU = max(PROFILE) - 1


def run_arm(topology, ticks, *, seed=0, device="cuda", params=None,
            batch_at=None):
    """Train the MLP for ``ticks`` meta steps; returns (losses, val_acc,
    per-step metrics as floats, the topology). ``params`` and
    ``batch_at(i)`` replace the port's own draws (a parity test passes
    JAX's)."""
    cfg = MAvgConfig(algorithm="mavg", num_learners=P, k_steps=K,
                     learner_lr=LR, momentum=MU, topology=topology)
    topo = make_topology(cfg)
    if params is None:
        params = mlp_init(seeded_generator(device, seed), D_IN, HIDDEN,
                          CLASSES, device=device)
    if batch_at is None:
        batch_at = seeded_batches(
            classif_batch_fn(D_IN, CLASSES, P, K, BATCH, device=device),
            seed + 1, device)
    state = init_state(params, cfg, topology=topo)
    step = make_meta_step(mlp_loss, cfg, topology=topo)
    metrics = []
    for i in range(ticks):
        state, m = step(state, batch_at(i))
        metrics.append(m)
    # one read back of every step's numbers, at the end
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    with torch.no_grad():
        acc = float(mlp_accuracy(unpack_params(state),
                                 classif_eval_set(D_IN, CLASSES,
                                                  device=device)))
    return [m["loss"] for m in metrics], acc, metrics, topo


def final_loss(losses):
    tail = losses[-5:]
    return sum(tail) / len(tail)


def async_ticks(target_blocks: int) -> int:
    """Ticks the async arm needs to complete ``target_blocks`` blocks."""
    probe = make_topology(MAvgConfig(num_learners=P, k_steps=K,
                                     topology=ASYNC_TOPOLOGY))
    ticks = 1
    while probe.work_completed(ticks - 1) < target_blocks:
        ticks += 1
    return ticks


ASYNC_TOPOLOGY = TopologyConfig(
    kind="async", server=AsyncConfig(staleness=TAU, step_time=PROFILE))
ELASTIC_TOPOLOGY = TopologyConfig(
    kind="hierarchical", groups=2, outer_every=1,
    elastic=ElasticConfig(period=8, drop_frac=0.25))


def modeled(arch: str = "qwen3-1.7b") -> list[dict]:
    """Per-tick modeled wire bytes of flat dense and the async server
    (uniform and the 4x-skewed profile) at ``arch``'s parameter count."""
    n = get_config(arch).param_count()
    cells = (
        ("flat_dense", TopologyConfig()),
        ("async_uniform", TopologyConfig(kind="async",
                                         server=AsyncConfig())),
        ("async_skew4", TopologyConfig(
            kind="async", server=AsyncConfig(staleness=TAU,
                                             step_time=PROFILE))),
    )
    rows = []
    for name, topo in cells:
        edge = topology_wire_bytes(n, CommConfig(), topo, num_learners=P)
        wire_s = wire_seconds(edge["intra_bytes"], edge["inter_bytes"])
        rows.append({"kind": "async_model", "cell": name, "arch": arch,
                     **edge, "wire_s": wire_s})
        print(f"async_model,{arch},{name},inter,"
              f"{edge['inter_bytes']:.3e},B,{wire_s:.4f},s")
    print(f"async_model,{LINK_RATES}")
    return rows


def main(quick: bool = False, device="cuda",
         json_path: str | None = None) -> list[dict]:
    """The three arms, the acceptance row and the modeled rows."""
    rows = measured(quick, device)
    rows += modeled()
    if json_path:
        write_rows(json_path, rows, suite="async")
        print(f"wrote {len(rows)} rows to {json_path}")
    return rows


def measured(quick: bool = False, device="cuda") -> list[dict]:
    """The three arms and the acceptance row."""
    sync_rounds = 15 if quick else 60
    prof = PROFILE
    target_blocks = sync_rounds * P  # the sync arm's completed blocks
    samples_per_block = K * BATCH

    # sync: the barrier pays the straggler every round
    losses, acc, _, _ = run_arm(TopologyConfig(kind="flat"), sync_rounds,
                                 device=device)
    sync_wall = sync_rounds * max(prof)
    sync_idle = 1.0 - (sum(prof) / len(prof)) / max(prof)
    rows = [{
        "kind": "async_measured", "cell": "sync_barrier",
        "final_loss": final_loss(losses), "val_acc": acc,
        "effective_samples": target_blocks * samples_per_block,
        "wall_clock_ticks": sync_wall, "idle_frac": sync_idle,
        "staleness_max": 0.0,
    }]

    # async: run until the same number of blocks completed
    ticks = async_ticks(target_blocks)
    losses, acc, metrics, topo = run_arm(ASYNC_TOPOLOGY, ticks,
                                           device=device)
    stale = [m["staleness_max"] for m in metrics]
    stale_worst = max(stale)
    rows.append({
        "kind": "async_measured", "cell": f"async_skew{max(prof)}x",
        "final_loss": final_loss(losses), "val_acc": acc,
        "effective_samples":
            topo.work_completed(ticks - 1) * samples_per_block,
        "wall_clock_ticks": ticks, "idle_frac": 0.0,
        "staleness_max": stale_worst, "staleness_bound": TAU,
    })

    # elastic masking: drop the stragglers instead of waiting for them;
    # 25 % absent ~= masking out the 4x pair
    presence = 0.75
    eticks = math.ceil(sync_rounds / presence)
    losses, acc, _, _ = run_arm(ELASTIC_TOPOLOGY, eticks, device=device)
    rows.append({
        "kind": "async_measured", "cell": "elastic_mask25",
        "final_loss": final_loss(losses), "val_acc": acc,
        "effective_samples":
            int(eticks * P * presence) * samples_per_block,
        "wall_clock_ticks": eticks, "idle_frac": 0.0,
        "staleness_max": 0.0,
    })

    for r in rows:
        print(f"async,{r['cell']},final_loss,{r['final_loss']:.4f},"
              f"wall,{r['wall_clock_ticks']},idle,{r['idle_frac']:.2f},"
              f"stale_max,{r['staleness_max']:.0f}")

    gap = rows[1]["final_loss"] / rows[0]["final_loss"]
    accept = {
        "kind": "async_accept",
        "loss_vs_sync_at_equal_samples": gap,
        "within_5pct": bool(gap <= 1.05),
        "sync_idle_frac": sync_idle,
        "sync_idles_40pct": bool(sync_idle >= 0.40),
        "staleness_max": stale_worst,
        "staleness_bound": TAU,
        "staleness_bounded": bool(all(s <= TAU for s in stale)),
        "wall_clock_speedup": sync_wall / rows[1]["wall_clock_ticks"],
    }
    rows.append(accept)
    print(f"async_accept,loss_vs_sync,{gap:.3f},within_5pct,"
          f"{accept['within_5pct']},sync_idle,{sync_idle:.2f},"
          f"speedup,{accept['wall_clock_speedup']:.2f}x")
    # the reference's acceptance (benchmarks/expected/async.json)
    assert accept["within_5pct"], accept
    assert accept["staleness_bounded"], stale
    assert accept["sync_idles_40pct"], accept
    assert accept["wall_clock_speedup"] >= 1.5, accept
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every row as the JSONL envelope")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device, json_path=args.json)
