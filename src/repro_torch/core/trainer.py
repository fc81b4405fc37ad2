"""The training loop: model init, data, meta step, telemetry, the
checkpoint cadence and the health halt (the JAX package's
``core/trainer.py``).

Telemetry (``repro_torch.obs``, DESIGN.md §11): every per-step scalar the
meta step returns is written into a ``MetricsBuffer`` ring on the state's
device, so the host reads no metric between ``log_every`` boundaries: one
device-to-host read per flush window is the only sync. Flushed records,
with host-side wall-clock throughput, land in ``self.history`` and, when
``TrainConfig.obs`` selects a sink, in a structured run log under a run
manifest. ``obs.trace`` times the ``obs.*`` phases and exports a Chrome
trace, ``obs.profiler`` a ``torch.profiler`` trace, ``obs.health``
watches the flushed windows (a fatal rule saves a resumable checkpoint
and raises ``HealthHalt``), and ``obs.attribution`` times the step, the
local phase and the meta mix once before step 0. ``obs.cost_analysis``
is refused: XLA's cost model has no counterpart here yet (ROADMAP Queue 1,
item 10).

With ``TrainConfig.checkpoint_dir`` and ``checkpoint_every`` set, the
state is saved (``repro_torch.checkpoint``, with the run manifest) after
every ``checkpoint_every``-th meta step, keeping the ``checkpoint_keep``
newest verified snapshots; ``restore`` loads one back into the live
state, in place, and the next run appends to the same run log.

Fault injection (``repro_torch.chaos``) is wired as in JAX: the config
transform (crash windows -> elastic membership) before the topology is
built, the batch poisoner around ``batch_fn``, the payload corruptor
into the meta step, and the save faults (torn_save, corrupt_save) into
the checkpoint writer. ``TrainConfig.data_salt`` (a supervisor retry)
redraws the data stream. Robust telemetry (``repro_torch.robust``): each
flush moves the ``robust_*`` metrics out of the step records into
``robust`` records, and the inline quarantine masks a persistently
anomalous learner out of the membership schedule.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_state, save_state
from repro_torch.configs.base import MAvgConfig, TrainConfig
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.obs import (
    HealthHalt,
    MetricsBuffer,
    Tracer,
    make_monitor,
    make_sink,
    measured_peak_gbps,
    metric_keys,
    profile_phases,
    run_manifest,
)
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

        if train_cfg.obs.cost_analysis:
            raise NotImplementedError(
                "ObsConfig.cost_analysis: the compiled-step cost model "
                "(roofline.hlo_cost.jit_cost) is not ported yet (ROADMAP "
                "Queue 1, item 10)")
        self.cfg = train_cfg
        self.mcfg: MAvgConfig = train_cfg.mavg
        self.obs_cfg = train_cfg.obs
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
        # telemetry is built at the first step (the metric keys come from
        # its returned metrics)
        self._mb: Optional[MetricsBuffer] = None
        self._sink = None
        self.manifest: Optional[dict] = None
        self.tracer = Tracer(self.obs_cfg.trace)
        self._restored = False
        self.history: list[dict] = []
        # health watchdogs: they read only flushed host floats, so a
        # healthy run is bitwise identical with them on
        self._monitor = (make_monitor(halt=self.obs_cfg.health_halt)
                         if self.obs_cfg.health else None)
        self.attribution: list[dict] = []
        # inline quarantine: a host-side streak counter over the flushed
        # per-learner anomaly scores
        self.robust_records: list[dict] = []
        self.quarantined: dict[int, int] = {}  # learner -> quarantine step
        self._anomaly_streak = None

    # ------------------------------------------------------------------
    # telemetry assembly (once per Trainer, at the first step)
    # ------------------------------------------------------------------

    def _init_obs(self, metrics):
        """Build the metric ring, the manifest and the sink from the first
        step's returned ``metrics``: the port runs eagerly, so the metric
        keys are known once a step has run (JAX finds them with
        ``jax.eval_shape`` before its first dispatch)."""
        obs = self.obs_cfg
        self._mkeys = metric_keys(metrics)
        capacity = obs.buffer_capacity or max(self.cfg.log_every, 1)
        self._mb = MetricsBuffer(self._mkeys, capacity, device=self.device)
        self.manifest = run_manifest(
            train_cfg=self.cfg, mcfg=self.mcfg,
            spec=getattr(self.state, "spec", None), device=self.device)
        if obs.sink != "none" and self._sink is None:
            self._sink = make_sink(obs.sink, obs.run_dir,
                                   resume=self._restored)
            self._sink.open_run(self.manifest)

    def _attribute(self, batches, lr):
        """The phase attribution rows, once before step 0 (on a clone of the
        state; the live state is untouched). Best-effort telemetry, as in
        JAX: a failure leaves ``attribution`` empty."""
        try:
            self.attribution = profile_phases(
                self.loss_fn, self.mcfg, self.state, batches, lr,
                iters=5, warmup=2,
                peak_gbps=measured_peak_gbps(device=self.device),
            )
        except Exception:  # attribution is best-effort telemetry
            self.attribution = []

    # ------------------------------------------------------------------
    # driving loop
    # ------------------------------------------------------------------

    def run(self, meta_steps: Optional[int] = None, log=print):
        """Drive ``meta_steps`` meta steps; returns ``history``.

        Metrics stay on the device until a ``log_every`` boundary (or the
        end of the run): each step writes one row of the ``MetricsBuffer``
        ring, and only a flush pays one device-to-host read. ``history``
        holds one dict of floats per step, with the wall-clock throughput
        (``meta_steps_per_sec``, ``samples_per_sec``, ``elapsed_s``) of its
        flush window. The step updates the state in place, so the loop
        works off the returned state only.
        """
        n = meta_steps if meta_steps is not None else self.cfg.meta_steps
        run_t0 = time.time()
        start = int(self.state.step)
        self._last_flush_t = run_t0
        samples_per_block = self.mcfg.k_steps * self.cfg.batch_per_learner
        samples_per_meta = self.mcfg.num_learners * samples_per_block

        def flush():
            if self._mb is None or not self._mb.count:
                return
            with self.tracer.span("obs.host_flush"):
                recs = self._mb.flush()
            now = time.time()
            dt = max(now - self._last_flush_t, 1e-9)
            self._last_flush_t = now
            msps = len(recs) / dt
            robust_rows = self._extract_robust(recs)
            for r in recs:
                s = r["meta_step"]
                r["samples"] = (self._topology.work_completed(s)
                                * samples_per_block)
                r["meta_steps_per_sec"] = msps
                r["samples_per_sec"] = msps * samples_per_meta
                r["elapsed_s"] = now - run_t0
                self.history.append(r)
            self._observe_robust(robust_rows)
            alerts = (self._monitor.observe(recs)
                      if self._monitor is not None else ())
            if self._sink is not None:
                with self.tracer.span("obs.sink_append"):
                    for r in recs:
                        self._sink.append(r)
                    for rb in robust_rows:
                        self._sink.append(rb)
                    for a in alerts:
                        self._sink.append(a)
                    self._sink.flush()

        def maybe_halt(step):
            # raised only from in-loop flush boundaries (never from the
            # finally-flush: a halt must not mask a real traceback)
            if self._monitor is None or not self._monitor.halt_requested:
                return
            alert = self._monitor.halt_alert
            ckpt_dir = self.cfg.checkpoint_dir or (
                os.path.join(self.obs_cfg.run_dir, "halt_ckpt")
                if self.obs_cfg.run_dir else None)
            path = None
            if ckpt_dir:
                with self.tracer.span("obs.checkpoint_io"):
                    path = save_state(ckpt_dir, self.state, step + 1,
                                      manifest=self.manifest)
            raise HealthHalt(alert, path)

        # the session closes open spans, stops the profiler and exports the
        # Chrome traces on any exit, the final flush's spans included
        run_dir = self.obs_cfg.run_dir
        export_path = (os.path.join(run_dir, "trace.json")
                       if self.obs_cfg.trace and run_dir else None)
        profiler_dir = (os.path.join(run_dir, "torch_trace")
                        if self.obs_cfg.profiler and run_dir else None)
        with self.tracer.session(export_path, profiler_dir):
            try:
                for i in range(n):
                    step = start + i
                    batches = self.batch_fn(self._data_generator(step), step)
                    lr = (self.lr_schedule(step) if self.lr_schedule
                          else np.float32(self.mcfg.learner_lr))
                    if self._mb is None and self.obs_cfg.attribution:
                        self._attribute(batches, lr)
                    if self._mb is not None and self._mb.full:
                        flush()  # ring smaller than the log window
                        maybe_halt(step - 1)
                    with self.tracer.span("obs.dispatch"):
                        self.state, metrics = self._step_fn(
                            self.state, batches, lr=lr)
                        if self._mb is None:
                            self._init_obs(metrics)
                            if self._sink is not None:
                                for row in self.attribution:
                                    self._sink.append(row)
                        self._mb.append(metrics, step)
                    del metrics
                    if log and step % self.cfg.log_every == 0:
                        flush()
                        maybe_halt(step)
                        m = self.history[-1]
                        log(f"[{self.mcfg.algorithm}] meta_step={step} "
                            f"loss={m['loss']:.4f} "
                            f"gnorm={m.get('grad_norm', 0):.3f} "
                            f"{m['meta_steps_per_sec']:.2f} steps/s "
                            f"{m['samples_per_sec']:.0f} samples/s "
                            f"({time.time() - run_t0:.1f}s)")
                    every = self.cfg.checkpoint_every
                    if (self.cfg.checkpoint_dir and every
                            and (step + 1) % every == 0):
                        sched = self._chaos_schedule
                        with self.tracer.span("obs.checkpoint_io"):
                            save_state(
                                self.cfg.checkpoint_dir, self.state, step + 1,
                                manifest=self.manifest,
                                keep=self.cfg.checkpoint_keep,
                                fault=(None if sched is None
                                       else sched.save_fault(step + 1)),
                            )
                flush()  # the final (possibly partial) log window
                maybe_halt(start + n - 1)
            finally:
                flush()  # metrics of completed steps survive an interrupt
                if self._sink is not None:
                    self._sink.flush()
        return self.history

    def _data_generator(self, step: int):
        """The data stream's generator for meta step ``step``; a nonzero
        ``data_salt`` (a supervisor retry) redraws it."""
        salt = self.cfg.data_salt
        return seeded_generator(self.device, self.cfg.seed, 1, step,
                                *((salt,) if salt else ()))

    def restore(self, path):
        """Load the checkpoint at ``path`` into the live state, in place;
        the next ``run`` continues from its step, and a sink opened after
        the restore appends to the existing run log."""
        self.state = load_state(path, self.state)
        self._restored = True

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

    def emit(self, record: dict):
        """Append one structured record to the run's telemetry sink (the
        supervisor's fault/recovery records ride the same log as the step
        rows). No-op when no sink is open."""
        if self._sink is not None:
            self._sink.append(record)
            self._sink.flush()

    def close(self):
        """Flush and close the telemetry sink (idempotent)."""
        if self._sink is not None:
            self._sink.close()
            self._sink = None
