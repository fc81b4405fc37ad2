"""Minimal training driver: model init, data, meta step, metric history.

The JAX package's ``core/trainer.py`` without telemetry sinks, chaos,
checkpointing or robust aggregation (ROADMAP Queue 1, items 3 and 7-8).
Metrics stay on the device between ``log_every`` boundaries; a flush
reads them back once and adds host-side throughput.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import MAvgConfig, TrainConfig
from repro_torch.core.meta import init_state, make_meta_step
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
        # the init and data streams: seeded generators, one per purpose
        # (init) and per meta step (data), reproducible run to run
        params = init_params_fn(
            seeded_generator(self.device, train_cfg.seed, 0))
        self._topology = make_topology(self.mcfg)
        self.state = init_state(params, self.mcfg, topology=self._topology)
        del params  # the state holds its own copy
        self._step_fn = make_meta_step(loss_fn, self.mcfg,
                                       topology=self._topology)
        self.history: list[dict] = []

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
            for r in recs:
                r["samples"] = (self._topology.work_completed(r["meta_step"])
                                * samples_per_block)
                r["meta_steps_per_sec"] = msps
                r["samples_per_sec"] = msps * samples_per_meta
                r["elapsed_s"] = now - run_t0
            self.history.extend(recs)
            pending.clear()

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
        return self.history
