"""Training launcher of the port: end-to-end M-AVG training of an
assigned architecture (reduced or full config) on one card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --algorithm mavg --learners 4 --k 4 --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda \\
      --steps 3

The reduced config trains on the bigram-teacher stream and ends with an
eval loss. ``--full`` uses uniform random tokens instead: the bigram table
at the full vocabulary would take 92 GB (ROADMAP). ``--comm`` compresses
the meta average (``repro_torch.comm``), with error feedback unless
``--no-error-feedback``; at full width with f32 learners the EF residual
adds L planes, so ``--full --comm int8`` fits one 80 GB card at
``--learners 2``. ``--topology hierarchical|gossip`` mixes the learners
through ``repro_torch.topology`` (``--groups``, ``--outer-every``,
``--outer-momentum``, ``--outer-comm``, ``--group-k``; ``--gossip-graph``),
with elastic membership under ``--elastic-period``/``--elastic-drop``/
``--elastic-seed``; the flags mean what they mean in the JAX launcher.
Its other flags (async, obs, chaos, robust, checkpoints) are not ported
yet; ``--topology async`` is refused.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import (
    AVERAGING_ALGOS,
    COMM_SCHEMES,
    GOSSIP_GRAPHS,
    TOPOLOGIES,
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    TopologyConfig,
    TrainConfig,
    get_config,
)
from repro_torch.core.trainer import Trainer
from repro_torch.data import lm_batch_fn, lm_eval_set, uniform_batch_fn
from repro_torch.models import api as model_api
from repro_torch.optim import warmup_cosine
from repro_torch.pack import unpack_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--algorithm", default="mavg", choices=AVERAGING_ALGOS)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--momentum", type=float, default=0.7)
    ap.add_argument("--full", action="store_true",
                    help="full-scale config (one 80 GB card)")
    ap.add_argument("--comm", default="dense", choices=COMM_SCHEMES,
                    help="meta-communication compression scheme")
    ap.add_argument("--comm-k-frac", type=float, default=0.1,
                    help="kept fraction for the top-k comm schemes")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the comm error-feedback residual")
    ap.add_argument("--topology", default="flat", choices=TOPOLOGIES,
                    help="meta-level mixing topology (async: not ported)")
    ap.add_argument("--groups", type=int, default=1,
                    help="hierarchical: number of learner groups G")
    ap.add_argument("--outer-every", type=int, default=1,
                    help="hierarchical: cross-group average every H meta steps")
    ap.add_argument("--outer-momentum", type=float, default=0.0,
                    help="hierarchical: block momentum of the outer level")
    ap.add_argument("--gossip-graph", default="ring", choices=GOSSIP_GRAPHS,
                    help="gossip: mixing graph")
    ap.add_argument("--outer-comm", default=None, choices=COMM_SCHEMES,
                    help="cross-group comm scheme (default: same as --comm)")
    ap.add_argument("--group-k", default=None,
                    help="hierarchical: comma-separated per-group local-step "
                         "counts K_g (each <= --k), e.g. --group-k 2,4")
    ap.add_argument("--elastic-period", type=int, default=0,
                    help="elastic membership schedule length in meta steps "
                         "(0 = everyone always present)")
    ap.add_argument("--elastic-drop", type=float, default=0.25,
                    help="fraction of learners absent per scheduled step")
    ap.add_argument("--elastic-seed", type=int, default=0,
                    help="seed of the deterministic membership schedule")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.topology == "async":
        raise NotImplementedError(
            "--topology async: the async server is not ported yet "
            "(ROADMAP Queue 1, item 6)")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    outer_comm = (
        CommConfig(scheme=args.outer_comm, k_frac=args.comm_k_frac,
                   error_feedback=not args.no_error_feedback)
        if args.outer_comm else None
    )
    group_k = (tuple(int(k) for k in args.group_k.split(","))
               if args.group_k else None)
    elastic = (
        ElasticConfig(period=args.elastic_period, drop_frac=args.elastic_drop,
                      seed=args.elastic_seed)
        if args.elastic_period > 0 else None
    )
    mcfg = MAvgConfig(algorithm=args.algorithm, num_learners=args.learners,
                      k_steps=args.k, learner_lr=args.lr,
                      momentum=args.momentum,
                      comm=CommConfig(
                          scheme=args.comm, k_frac=args.comm_k_frac,
                          error_feedback=not args.no_error_feedback),
                      topology=TopologyConfig(
                          kind=args.topology, groups=args.groups,
                          outer_every=args.outer_every,
                          outer_momentum=args.outer_momentum,
                          graph=args.gossip_graph, outer_comm=outer_comm,
                          group_k=group_k, elastic=elastic))
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=args.batch,
                       seq_len=args.seq, meta_steps=args.steps)
    shape = (cfg, args.learners, args.k, args.batch, args.seq)
    batch_fn = (uniform_batch_fn(*shape) if args.full
                else lm_batch_fn(*shape, device=device))

    def loss_fn(params, batch):
        return model_api.loss_fn(params, cfg, batch)

    trainer = Trainer(
        tcfg, loss_fn,
        init_params_fn=lambda gen: model_api.init_params(gen, cfg, device),
        batch_fn=batch_fn,
        lr_schedule=warmup_cosine(args.lr, 5, args.steps),
        device=device,
    )
    history = trainer.run()
    line = (f"\nfinal train loss {history[-1]['loss']:.4f}  "
            f"samples {history[-1]['samples']}")
    last = history[-1]
    if "comm_error_norm" in last:
        line += (f"  comm_compression {last['comm_compression']:.2f}"
                 f"  comm_error_norm {last['comm_error_norm']:.3e}")
    elif args.topology != "flat":
        line += (f"  comm_compression {last['comm_compression']:.2f}"
                 f"  consensus_dist {last['consensus_dist']:.3e}")
    if "present_count" in last:
        line += f"  present {last['present_count']:.0f}/{args.learners}"
    if not args.full:
        eval_batch = lm_eval_set(cfg, n=32, seq_len=args.seq, device=device)
        with torch.no_grad():
            loss, _ = loss_fn(unpack_params(trainer.state), eval_batch)
        line += f"  eval loss {float(loss):.4f}"
    print(line)


if __name__ == "__main__":
    main()
