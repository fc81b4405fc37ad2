"""The training loop: model init, data, meta step, metric history and the
checkpoint cadence.

The JAX package's ``core/trainer.py`` without telemetry sinks (ROADMAP
Queue 1, item 8) or the supervisor (item 7). Metrics stay on the device
between ``log_every`` boundaries; a flush reads them back once and adds
host-side throughput. With ``TrainConfig.checkpoint_dir`` and
``checkpoint_every`` set, the state is saved (``repro_torch.checkpoint``)
after every ``checkpoint_every``-th meta step, keeping the
``checkpoint_keep`` newest verified snapshots; ``restore`` loads one back
into the live state, in place.

Fault injection (``repro_torch.chaos``) is wired as in JAX: the config
transform (crash windows -> elastic membership) before the topology is
built, the batch poisoner around ``batch_fn``, the payload corruptor
into the meta step, and the save faults (torn_save, corrupt_save) into
the checkpoint writer. Robust telemetry
(``repro_torch.robust``): each flush moves the ``robust_*`` metrics out of
the step records into ``robust_records``, and the inline quarantine masks
a persistently anomalous learner out of the membership schedule.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_state, save_state
from repro_torch.configs.base import MAvgConfig, TrainConfig
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.robust import ROBUST_METRIC_PREFIX
from repro_torch.utils.rng import seeded_generator


class Trainer:
    def __init__(
        self,
        train_cfg: TrainConfig,
        loss_fn: Callable,
        init_params_fn: Callable,  # (generator) -> params on ``device``
        batch_fn: Callable,  # (generator, step) -> batches (L, K, B, ...)
        lr_schedule: Optional[Callable] = None,
        device="cuda",
    ):
        from repro_torch.topology import make_topology

        self.cfg = train_cfg
        self.mcfg: MAvgConfig = train_cfg.mavg
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self.lr_schedule = lr_schedule
        self.device = torch.device(device)
        chaos_corruptor = None
        self._chaos_schedule = None
        if train_cfg.chaos is not None:
            from repro_torch.chaos import (
                FaultSchedule,
                PayloadCorruptor,
                apply_chaos,
                wrap_batch_fn,
            )

            self.mcfg = apply_chaos(self.mcfg, train_cfg.chaos,
                                    salt=train_cfg.data_salt)
            schedule = FaultSchedule(train_cfg.chaos, self.mcfg.num_learners,
                                     salt=train_cfg.data_salt)
            self._chaos_schedule = schedule
            self.batch_fn = wrap_batch_fn(batch_fn, schedule)
            if schedule.any_payload_faults:
                chaos_corruptor = PayloadCorruptor(schedule)
        # the init and data streams: seeded generators, one per purpose
        # (init) and per meta step (data), reproducible run to run
        params = init_params_fn(
            seeded_generator(self.device, train_cfg.seed, 0))
        self._topology = make_topology(self.mcfg)
        self.state = init_state(params, self.mcfg, topology=self._topology)
        del params  # the state holds its own copy
        self._step_fn = make_meta_step(loss_fn, self.mcfg,
                                       topology=self._topology,
                                       chaos=chaos_corruptor)
        self.history: list[dict] = []
        # inline quarantine: a host-side streak counter over the flushed
        # per-learner anomaly scores
        self.robust_records: list[dict] = []
        self.quarantined: dict[int, int] = {}  # learner -> quarantine step
        self._anomaly_streak = None

    def run(self, meta_steps: Optional[int] = None, log=print):
        """Drive ``meta_steps`` meta steps; returns ``history`` (one dict
        of floats per step, with throughput over its flush window)."""
        n = meta_steps if meta_steps is not None else self.cfg.meta_steps
        start = self.state.step
        samples_per_block = self.mcfg.k_steps * self.cfg.batch_per_learner
        samples_per_meta = self.mcfg.num_learners * samples_per_block
        run_t0 = last_t = time.perf_counter()
        pending: list[tuple[int, float, dict]] = []

        def flush():
            nonlocal last_t
            if not pending:
                return
            recs = [
                {"meta_step": s, "lr": lr,
                 **{k: float(v) for k, v in m.items()}}
                for s, lr, m in pending
            ]  # float() waits for the device: the window's one sync
            now = time.perf_counter()
            msps = len(recs) / max(now - last_t, 1e-9)
            last_t = now
            robust_rows = self._extract_robust(recs)
            for r in recs:
                r["samples"] = (self._topology.work_completed(r["meta_step"])
                                * samples_per_block)
                r["meta_steps_per_sec"] = msps
                r["samples_per_sec"] = msps * samples_per_meta
                r["elapsed_s"] = now - run_t0
            self.history.extend(recs)
            pending.clear()
            self._observe_robust(robust_rows)

        for i in range(n):
            step = start + i
            batches = self.batch_fn(
                seeded_generator(self.device, self.cfg.seed, 1, step), step
            )
            lr = (self.lr_schedule(step) if self.lr_schedule
                  else np.float32(self.mcfg.learner_lr))
            self.state, metrics = self._step_fn(self.state, batches, lr=lr)
            pending.append((step, float(lr), metrics))
            if step % self.cfg.log_every == 0 or i == n - 1:
                flush()
                if log:
                    m = self.history[-1]
                    log(f"[{self.mcfg.algorithm}] meta_step={step} "
                        f"loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                        f"{m['meta_steps_per_sec']:.2f} steps/s "
                        f"{m['samples_per_sec']:.0f} samples/s "
                        f"({m['elapsed_s']:.1f}s)")
            every = self.cfg.checkpoint_every
            if self.cfg.checkpoint_dir and every and (step + 1) % every == 0:
                sched = self._chaos_schedule
                save_state(
                    self.cfg.checkpoint_dir, self.state, step + 1,
                    keep=self.cfg.checkpoint_keep,
                    fault=None if sched is None else sched.save_fault(step + 1),
                )
        return self.history

    def restore(self, path):
        """Load the checkpoint at ``path`` into the live state, in place;
        the next ``run`` continues from its step."""
        self.state = load_state(path, self.state)

    # ------------------------------------------------------------------
    # robust telemetry + inline quarantine
    # ------------------------------------------------------------------

    def _extract_robust(self, recs):
        """Pop the ``robust_*`` scalars out of the flushed step records
        into ``robust`` records, one per meta step that carried them."""
        P = ROBUST_METRIC_PREFIX
        rows = []
        for r in recs:
            if not any(k.startswith(P) for k in r):
                continue
            rb = {
                "kind": "robust",
                "meta_step": r["meta_step"],
                "clipped_learners": r.pop(P + "clipped_learners", 0.0),
                "clip_budget": r.pop(P + "clip_budget", 0.0),
                "anomaly_score": r.pop(P + "anomaly_score", 0.0),
                "trim_fraction": r.pop(P + "trim_fraction", 0.0),
            }
            scores = []
            while f"{P}score_{len(scores)}" in r:
                scores.append(r.pop(f"{P}score_{len(scores)}"))
            if scores:
                rb["scores"] = scores
            for k in [k for k in r if k.startswith(P)]:
                r.pop(k)
            rows.append(rb)
        self.robust_records.extend(rows)
        return rows

    def _observe_robust(self, rows):
        """The inline quarantine: a learner whose windowed mean anomaly
        score exceeds ``score_ratio`` x the peer median for
        ``quarantine_after`` consecutive flush windows is masked out of
        the membership schedule on the spot. Needs a membership schedule
        (elastic or chaos crash faults); inert otherwise."""
        rcfg = self.mcfg.robust
        if rcfg is None or rcfg.quarantine_after <= 0:
            return
        sc = [row["scores"] for row in rows if "scores" in row]
        if not sc:
            return
        mean = np.asarray(sc, np.float64).mean(axis=0)  # (L,)
        med = float(np.median(mean))
        anomalous = mean > rcfg.score_ratio * max(med, 1e-30)
        if self._anomaly_streak is None:
            self._anomaly_streak = np.zeros(mean.shape[0], np.int64)
        self._anomaly_streak = np.where(anomalous,
                                        self._anomaly_streak + 1, 0)
        hit = [j for j in range(mean.shape[0])
               if self._anomaly_streak[j] >= rcfg.quarantine_after
               and j not in self.quarantined]
        topo = self.state.topo
        if not hit or not (isinstance(topo, dict) and "membership" in topo):
            return
        m = np.asarray(topo["membership"], np.float32).copy()
        m[:, hit] = 0.0
        if (m.sum(axis=1) < 1.0).any():
            return  # never quarantine away the last present learner(s)
        step = int(rows[-1]["meta_step"])
        self.set_membership(m)
        for j in hit:
            self.quarantined[j] = step
        rows[-1]["quarantined"] = sorted(self.quarantined)

    def set_membership(self, membership):
        """Replace the elastic membership schedule in the state: new
        (period, L) 0/1 rows of the same shape, every row with a learner
        present. Only valid on a run that has a membership schedule."""
        topo = self.state.topo
        if not (isinstance(topo, dict) and "membership" in topo):
            raise ValueError(
                "set_membership needs a run with an elastic membership "
                "schedule (TopologyConfig.elastic or chaos crash faults)")
        m = np.asarray(membership, np.float32)
        old = topo["membership"]
        if m.shape != tuple(old.shape):
            raise ValueError(f"membership shape {m.shape} != schedule "
                             f"shape {tuple(old.shape)}")
        if (m.sum(axis=1) < 1.0).any():
            raise ValueError(
                "quarantine membership leaves a row with no learner present")
        self.state = dataclasses.replace(
            self.state, topo={**topo, "membership": torch.from_numpy(m)})
