"""Fault injection and supervised recovery on the async MLP trainer (the
JAX package's ``benchmarks/chaos_bench.py``).

Under the standard fault schedule (``repro_torch.chaos.standard_chaos``: a
learner crash window, a NaN batch burst, payload scale and bit-flip
corruption, a straggle spike on learner 1 and a torn checkpoint write), a
supervised run with the in-step finite guard and the verified checkpoint
chain must converge within 5 % of the fault-free loss at equal effective
samples, with no non-finite value in its final state or in any retained
snapshot. Every arm runs the teacher-classification MLP (P=4, K=4, mu
0.7, lr 0.2, B=16) on ``TopologyConfig(kind="async")`` with tau 2; the
crash and straggle faults turn its uniform profile into a membership
schedule and a skewed profile (``chaos.apply_chaos``).

Arms:

  fault_free        the same config, no chaos, no guard: the loss bar
  chaos_supervised  standard chaos + finite guard + Supervisor rollback
                    and retry over the verified checkpoint chain
  injectors_off     chaos installed but EMPTY (corruptor idle, guard on)
                    against the vanilla run: final state bitwise equal
  kill_mid_save     a torn write at the head of the chain: the newest
                    verified snapshot is the one before, and it restores
                    bit-exactly

``main`` prints the reference's ``chaos,...`` lines and asserts its
acceptance (``benchmarks/expected/chaos.json``); ``--json PATH`` writes
every row as the run-log envelope (suite ``chaos``). Checkpoints go to
``workdir`` (default: a temporary directory, removed afterwards).

  PYTHONPATH=src python -m repro_torch.benchmarks.chaos_bench --quick \\
      [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.benchmarks.common import CLASSES, D_IN, HIDDEN, write_rows
from repro_torch.chaos import ChaosConfig, standard_chaos
from repro_torch.checkpoint import (
    latest_verified_checkpoint,
    load_state,
    save_state,
    verify_checkpoint,
)
from repro_torch.configs.base import (
    AsyncConfig,
    MAvgConfig,
    ObsConfig,
    TopologyConfig,
    TrainConfig,
)
from repro_torch.core.supervisor import RecoveryPolicy, Supervisor
from repro_torch.core.trainer import Trainer
from repro_torch.data import classif_batch_fn
from repro_torch.models.simple import mlp_init, mlp_loss

P, K, MU, LR, BATCH = 4, 4, 0.7, 0.2, 16
TAU = 2
PLANES = ("global_params", "momentum", "learners")


def make_trainer(steps, *, device, chaos=None, guard=False, salt=0,
                 lr_scale=1.0, ckpt_dir=None, health=False,
                 momentum_scale=1.0) -> Trainer:
    mcfg = MAvgConfig(
        algorithm="mavg", num_learners=P, k_steps=K,
        learner_lr=LR * lr_scale, momentum=MU * momentum_scale,
        finite_guard=guard,
        topology=TopologyConfig(kind="async",
                                server=AsyncConfig(staleness=TAU)))
    tcfg = TrainConfig(
        model=None, mavg=mcfg, batch_per_learner=BATCH, meta_steps=steps,
        seed=0, log_every=2, checkpoint_dir=ckpt_dir,
        checkpoint_every=2 if ckpt_dir else 0,
        checkpoint_keep=4 if ckpt_dir else 0,
        chaos=chaos, data_salt=salt,
        obs=ObsConfig(sink="none", health=health))
    return Trainer(
        tcfg, mlp_loss,
        init_params_fn=lambda gen: mlp_init(gen, D_IN, HIDDEN, CLASSES,
                                            device=device),
        batch_fn=classif_batch_fn(D_IN, CLASSES, P, K, BATCH, device=device),
        device=device)


def final_loss(history):
    tail = [r["loss"] for r in history[-5:]]
    return sum(tail) / len(tail)


def state_finite(state) -> bool:
    return all(bool(torch.isfinite(getattr(state, f)).all())
               for f in PLANES)


def states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in PLANES)


def measured(quick: bool, device, workdir: str) -> list[dict]:
    # enough post-fault room for a full rollback replay to re-converge
    steps = 24 if quick else 40
    rows: list[dict] = []

    # fault-free bar
    tr = make_trainer(steps, device=device)
    base_hist = tr.run(log=None)
    base_loss = final_loss(base_hist)
    base_samples = base_hist[-1]["samples"]
    rows.append({"kind": "chaos_measured", "cell": "fault_free",
                 "final_loss": base_loss, "effective_samples": base_samples,
                 "state_finite": state_finite(tr.state)})
    tr.close()
    del tr

    def base_loss_at(samples):
        """Fault-free loss at ``samples`` effective samples: crash windows
        and quarantine cost the supervised run samples, and the fair bar
        charges the fault-free arm the same budget."""
        upto = ([r for r in base_hist if r["samples"] <= samples]
                or base_hist[:1])
        return final_loss(upto)

    # supervised run under the standard fault schedule
    chaos = standard_chaos(P, steps, seed=0)
    ckpt_dir = os.path.join(workdir, "ckpt")

    def make_sup_trainer(plan):
        return make_trainer(
            steps, device=device, chaos=chaos, guard=True,
            salt=plan.data_salt, lr_scale=plan.lr_scale,
            momentum_scale=plan.momentum_scale, ckpt_dir=ckpt_dir,
            health=True)

    sup = Supervisor(make_sup_trainer, target_steps=steps,
                     checkpoint_dir=ckpt_dir,
                     policy=RecoveryPolicy(max_retries=3,
                                           quarantine_steps=max(steps // 8,
                                                                2)))
    tr, _ = sup.run(log=None)
    sup_loss = final_loss(tr.history)
    sup_samples = tr.history[-1]["samples"]
    retries = max((r["attempt"] for r in sup.records
                   if r.get("kind") == "recovery"), default=0)
    sup_finite = state_finite(tr.state)
    # every retained snapshot verifies finite too
    chain_ok = True
    for f in sorted(os.listdir(ckpt_dir)):
        if f.endswith(".npz"):
            try:
                verify_checkpoint(os.path.join(ckpt_dir, f))
            except Exception:
                chain_ok = False
    tr.close()
    del tr
    rows.append({"kind": "chaos_measured", "cell": "chaos_supervised",
                 "final_loss": sup_loss, "effective_samples": sup_samples,
                 "state_finite": sup_finite, "chain_verified": chain_ok,
                 "retries_used": retries,
                 "faults_injected": len(chaos.faults)})

    # injectors off == bitwise identity
    short = max(steps // 4, 8)
    tr_a = make_trainer(short, device=device)
    tr_a.run(log=None)
    tr_b = make_trainer(short, device=device, guard=True,
                        chaos=ChaosConfig(seed=0, horizon=steps, faults=()))
    tr_b.run(log=None)
    bitwise_off = states_equal(tr_a.state, tr_b.state)
    tr_b.close()
    rows.append({"kind": "chaos_measured", "cell": "injectors_off",
                 "bitwise_identical": bitwise_off})

    # kill mid-save: the chain falls back bit-exactly (restored into a
    # fresh trainer's state: the port's load_state writes in place)
    kdir = os.path.join(workdir, "killsave")
    good = save_state(kdir, tr_a.state, 8)
    save_state(kdir, tr_a.state, 9, fault="torn")
    resume_ok = latest_verified_checkpoint(kdir) == good
    if resume_ok:
        tr_c = make_trainer(short, device=device)
        restored = load_state(good, tr_c.state)
        resume_ok = states_equal(restored, tr_a.state)
        tr_c.close()
    tr_a.close()
    rows.append({"kind": "chaos_measured", "cell": "kill_mid_save",
                 "resume_verified": bool(resume_ok)})

    for r in rows:
        print("chaos," + ",".join(f"{k}={v}" for k, v in r.items()
                                  if k != "kind"))

    bar = base_loss_at(sup_samples)
    gap = sup_loss / bar
    accept = {
        "kind": "chaos_accept",
        "loss_fault_free": bar,
        "loss_fault_free_full": base_loss,
        "loss_supervised": sup_loss,
        "loss_vs_fault_free": gap,
        "within_5pct": bool(gap <= 1.05),
        "samples_vs_fault_free": sup_samples / max(base_samples, 1),
        "state_finite": bool(sup_finite and chain_ok),
        "bitwise_off": bitwise_off,
        "resume_verified": bool(resume_ok),
        "retries_used": retries,
        "ok": bool(gap <= 1.05 and sup_finite and chain_ok and bitwise_off
                   and resume_ok),
    }
    rows.append(accept)
    print(f"chaos_accept,loss_vs_fault_free,{gap:.3f},within_5pct,"
          f"{accept['within_5pct']},state_finite,{accept['state_finite']},"
          f"bitwise_off,{bitwise_off},resume_verified,{resume_ok},"
          f"retries,{retries}")
    return rows


def main(quick: bool = False, device="cuda", workdir: str | None = None,
         json_path: str | None = None) -> list[dict]:
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="chaos_bench_") as tmp:
            rows = measured(quick, device, tmp)
    else:
        rows = measured(quick, device, workdir)
    if json_path:
        write_rows(json_path, rows, suite="chaos")
        print(f"wrote {len(rows)} rows to {json_path}")
    accept = rows[-1]
    # the reference's acceptance (benchmarks/expected/chaos.json)
    assert accept["ok"], accept
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every row as the JSONL envelope")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device, json_path=args.json)
