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
``--elastic-seed``. ``--robust mean|trimmed|median`` turns on robust
aggregation (``repro_torch.robust``: ``--robust-trim``, ``--robust-clip``,
``--robust-clip-window``, ``--robust-no-score``,
``--robust-quarantine-after``), ``--finite-guard`` the in-step NaN/Inf
barrier, and ``--chaos`` the standard fault schedule
(``repro_torch.chaos``: ``--chaos-seed``, ``--chaos-faults``).
``--checkpoint-dir`` saves the state every ``--checkpoint-every`` meta
steps (``repro_torch.checkpoint``, the JAX package's file format), keeping
the ``--checkpoint-keep`` newest verified snapshots; ``--resume`` restores
the newest verified snapshot there (else the newest) before training, so
a port run resumes a JAX run's checkpoint and the other way round.
``--obs-sink jsonl|csv|memory`` writes the structured run log
(``repro_torch.obs``) into ``--run-dir``, ``--trace`` the phase spans'
Chrome trace there, ``--profiler`` a ``torch.profiler`` trace,
``--obs-health`` the health watchdogs (``--obs-no-halt`` keeps fatal
rules from halting) and ``--obs-attribution`` the phase timing rows.
``--supervise`` wraps the run in the rollback supervisor
(``core/supervisor.py``: ``--supervise-retries``,
``--supervise-quarantine``, ``--supervise-readmit``; it needs
``--checkpoint-dir``). The flags mean what they mean in the JAX launcher.
Not ported yet, and refused: ``--topology async`` and the straggle fault
kind (ROADMAP Queue 1, item 6), and ``--obs-cost`` (item 10).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 4 --checkpoint-dir build/ck --checkpoint-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 2 --checkpoint-dir build/ck --checkpoint-every 2 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 4 --obs-sink jsonl --run-dir build/run --trace --obs-health
  python tools/check_telemetry.py build/run/run.jsonl
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.chaos import STANDARD_KINDS, standard_chaos
from repro_torch.checkpoint import latest_checkpoint, latest_verified_checkpoint
from repro_torch.configs.base import (
    AVERAGING_ALGOS,
    COMM_SCHEMES,
    GOSSIP_GRAPHS,
    OBS_SINKS,
    ROBUST_ESTIMATORS,
    TOPOLOGIES,
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    ObsConfig,
    RobustConfig,
    TopologyConfig,
    TrainConfig,
    get_config,
)
from repro_torch.core.supervisor import (
    RecoveryPlan,
    RecoveryPolicy,
    Supervisor,
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
    ap.add_argument("--chaos", action="store_true",
                    help="deterministic fault injection: the standard fault "
                         "schedule sized to --steps/--learners. Int-token LM "
                         "batches carry no float leaves, so the nan kind "
                         "perturbs nothing here")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the standard chaos schedule")
    ap.add_argument("--chaos-faults", default=None,
                    help="comma subset of the standard fault kinds "
                         "(crash,nan,payload,torn_save; straggle is not "
                         "ported); default all")
    ap.add_argument("--robust", default=None, choices=ROBUST_ESTIMATORS,
                    help="robust meta aggregation: the coordinate-wise "
                         "trimmed mean or median in place of the learner "
                         "mean ('mean' keeps it but enables clip/score)")
    ap.add_argument("--robust-trim", type=int, default=1,
                    help="learners trimmed from EACH end per coordinate")
    ap.add_argument("--robust-clip", type=float, default=0.0,
                    help="per-learner displacement norm clip at this "
                         "multiple of the trailing-median budget (0 = off)")
    ap.add_argument("--robust-clip-window", type=int, default=8,
                    help="trailing-median ring length (meta steps)")
    ap.add_argument("--robust-no-score", action="store_true",
                    help="disable the per-learner anomaly scores")
    ap.add_argument("--robust-quarantine-after", type=int, default=0,
                    help="mask a learner out of membership after this many "
                         "consecutive anomalous flush windows (0 = never; "
                         "needs a membership schedule)")
    ap.add_argument("--finite-guard", action="store_true",
                    help="in-step NaN/Inf barrier: a poisoned learner is "
                         "reset to the global params before the mix")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="checkpoint cadence in meta steps (with "
                         "--checkpoint-dir)")
    ap.add_argument("--checkpoint-keep", type=int, default=0,
                    help="keep only the N newest verified checkpoints "
                         "(0 = keep all)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest VERIFIED checkpoint from "
                         "--checkpoint-dir (torn/corrupt snapshots are "
                         "skipped) before training")
    ap.add_argument("--obs-sink", default="none", choices=OBS_SINKS,
                    help="structured run log sink (repro_torch.obs): "
                         "per-step telemetry records under a run manifest")
    ap.add_argument("--run-dir", default=None,
                    help="run-log / trace directory (required for the "
                         "jsonl and csv sinks)")
    ap.add_argument("--trace", action="store_true",
                    help="phase span timers + Chrome-trace export to "
                         "<run-dir>/trace.json")
    ap.add_argument("--profiler", action="store_true",
                    help="capture a torch.profiler trace into "
                         "<run-dir>/torch_trace")
    ap.add_argument("--obs-cost", action="store_true",
                    help="the compiled step's cost in the manifest (not "
                         "ported: ROADMAP Queue 1, item 10)")
    ap.add_argument("--obs-health", action="store_true",
                    help="run-health watchdogs over the flushed metric "
                         "windows: alerts in the run log, fatal rules halt "
                         "with a resumable checkpoint")
    ap.add_argument("--obs-no-halt", action="store_true",
                    help="demote fatal health rules to warn: record "
                         "alerts, never stop the run")
    ap.add_argument("--obs-attribution", action="store_true",
                    help="phase attribution rows (obs.profile), timed once "
                         "before step 0")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the run in core.supervisor.Supervisor: on a "
                         "health halt / checkpoint-verify failure, roll "
                         "back to the last verified snapshot and retry "
                         "with recovery policies (requires "
                         "--checkpoint-dir)")
    ap.add_argument("--supervise-retries", type=int, default=3,
                    help="supervisor retry budget before RecoveryExhausted")
    ap.add_argument("--supervise-quarantine", type=int, default=0,
                    help="probation window (meta steps) a suspect learner "
                         "is quarantined from membership after rollback "
                         "(0 = never)")
    ap.add_argument("--supervise-readmit", type=int, default=1,
                    help="quarantine hysteresis: clean probation windows a "
                         "quarantined learner must sit out before "
                         "readmission (total mask = window * this)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.topology == "async":
        raise NotImplementedError(
            "--topology async: the async server is not ported yet "
            "(ROADMAP Queue 1, item 6)")
    if args.obs_cost:
        raise SystemExit(
            "--obs-cost: the compiled-step cost model (roofline.hlo_cost) is "
            "not ported yet (ROADMAP Queue 1, item 10)")
    if args.supervise and not args.checkpoint_dir:
        raise SystemExit("--supervise needs --checkpoint-dir (the "
                         "verified rollback chain lives there)")
    chaos_cfg = None
    if args.chaos:
        kinds = (tuple(k.strip() for k in args.chaos_faults.split(","))
                 if args.chaos_faults else STANDARD_KINDS)
        unknown = set(kinds) - set(STANDARD_KINDS)
        if unknown:
            raise SystemExit(f"--chaos-faults: unknown kinds "
                             f"{sorted(unknown)}; choose from "
                             f"{STANDARD_KINDS}")
        chaos_cfg = standard_chaos(args.learners, args.steps,
                                   seed=args.chaos_seed, kinds=kinds)
    robust = (
        RobustConfig(estimator=args.robust, trim=args.robust_trim,
                     clip_mult=args.robust_clip,
                     clip_window=args.robust_clip_window,
                     score=not args.robust_no_score,
                     quarantine_after=args.robust_quarantine_after)
        if args.robust is not None else None
    )

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
    shape = (cfg, args.learners, args.k, args.batch, args.seq)
    batch_fn = (uniform_batch_fn(*shape) if args.full
                else lm_batch_fn(*shape, device=device))

    def loss_fn(params, batch):
        return model_api.loss_fn(params, cfg, batch)

    def make_trainer(plan: RecoveryPlan) -> Trainer:
        mcfg = MAvgConfig(
            algorithm=args.algorithm, num_learners=args.learners,
            k_steps=args.k, learner_lr=args.lr,
            momentum=args.momentum * plan.momentum_scale,
            finite_guard=args.finite_guard, robust=robust,
            comm=CommConfig(scheme=args.comm, k_frac=args.comm_k_frac,
                            error_feedback=not args.no_error_feedback),
            topology=TopologyConfig(
                kind=args.topology, groups=args.groups,
                outer_every=args.outer_every,
                outer_momentum=args.outer_momentum,
                graph=args.gossip_graph, outer_comm=outer_comm,
                group_k=group_k, elastic=elastic))
        tcfg = TrainConfig(
            model=cfg, mavg=mcfg,
            batch_per_learner=args.batch, seq_len=args.seq,
            meta_steps=args.steps, chaos=chaos_cfg,
            data_salt=plan.data_salt, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=(args.checkpoint_every
                              if args.checkpoint_dir else 0),
            checkpoint_keep=args.checkpoint_keep,
            obs=ObsConfig(sink=args.obs_sink, run_dir=args.run_dir,
                          trace=args.trace, profiler=args.profiler,
                          health=args.obs_health,
                          health_halt=not args.obs_no_halt,
                          attribution=args.obs_attribution))
        return Trainer(
            tcfg, loss_fn,
            init_params_fn=lambda gen: model_api.init_params(gen, cfg,
                                                             device),
            batch_fn=batch_fn,
            lr_schedule=warmup_cosine(args.lr * plan.lr_scale, 5,
                                      args.steps),
            device=device,
        )

    if args.supervise:
        sup = Supervisor(
            make_trainer, target_steps=args.steps,
            checkpoint_dir=args.checkpoint_dir,
            policy=RecoveryPolicy(
                max_retries=args.supervise_retries,
                quarantine_steps=args.supervise_quarantine,
                readmit_clean_windows=args.supervise_readmit))
        trainer, history = sup.run()
    else:
        trainer = make_trainer(RecoveryPlan())
        if args.resume:
            ckpt = (latest_verified_checkpoint(args.checkpoint_dir or "")
                    or latest_checkpoint(args.checkpoint_dir or ""))
            if ckpt is None:
                raise SystemExit("--resume: no checkpoint in "
                                 "--checkpoint-dir")
            trainer.restore(ckpt)
            print(f"resumed from {ckpt}")
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
    if "nonfinite_learners" in last:
        line += f"  nonfinite_learners {last['nonfinite_learners']:.0f}"
    if trainer.robust_records:
        rb = trainer.robust_records[-1]
        line += (f"  robust clipped {rb['clipped_learners']:.0f}"
                 f"  anomaly_score {rb['anomaly_score']:.3e}")
        if trainer.quarantined:
            line += f"  quarantined {sorted(trainer.quarantined)}"
    if not args.full:
        eval_batch = lm_eval_set(cfg, n=32, seq_len=args.seq, device=device)
        with torch.no_grad():
            loss, _ = loss_fn(unpack_params(trainer.state), eval_batch)
        line += f"  eval loss {float(loss):.4f}"
    print(line)
    trainer.close()


if __name__ == "__main__":
    main()
