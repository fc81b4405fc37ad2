"""Supervised auto-recovery: rollback to the verified checkpoint chain
plus bounded-retry policies (the JAX package's ``core/supervisor.py``,
DESIGN.md §13).

The Trainer already turns a sick run into a structured event: a fatal
health rule (obs.health) halts at a flush boundary with a resumable
checkpoint and a ``HealthHalt`` carrying the triggering alert. The
``Supervisor`` closes the loop — it is the process-level analogue of the
in-step finite guard:

    halt/verify-failure -> roll back to the newest VERIFIED snapshot
    strictly BEFORE the fault step (one snapshot further back per retry
    that stalls without progress — see ``run``) -> apply a recovery
    policy -> rebuild the trainer -> run the REMAINING steps (equal
    effective samples by construction) -> repeat, at most
    ``RecoveryPolicy.max_retries`` times -> ``RecoveryExhausted``.

Recovery policies compose per retry:

* **re-salt the data stream** (``TrainConfig.data_salt``): the replayed
  batches are redrawn, and the chaos ``FaultSchedule`` drops its
  non-sticky faults — a transient fault does not recur, which is exactly
  how real rollback-recovery behaves (the re-read batch is clean).
* **quarantine the suspect learner** through the elastic membership mask
  (``Trainer.set_membership`` — the absence is re-wired around via the
  stochastic complement like any other churn, §8), for
  ``quarantine_steps`` of probation, then readmit.
* **exponential lr / momentum backoff** (``lr_backoff`` /
  ``momentum_backoff`` multiply ``RecoveryPlan.lr_scale`` /
  ``momentum_scale`` per retry — the trainer factory applies them).

Every transition is emitted into the run's telemetry sink as a schema-
valid ``fault`` / ``recovery`` record (tools/check_telemetry.py; the
``recovery`` record is also the checker's marker that the trajectory
legitimately rewound).

Where the port departs from JAX: card memory. JAX builds the retry's
trainer while the failed one still holds its state; on one card two
full-depth states do not fit (2 x 41.3 GB for Qwen3-1.7B at L=4). So
before it calls the factory, the port's supervisor releases the failed
trainer: it closes its sink, drops its state and returns the cached
blocks to the card (``torch.cuda.empty_cache``). The retry then restores
the rollback snapshot in place (``checkpoint.load_state``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import gc

import torch

from repro_torch.checkpoint import (
    CheckpointVerifyError,
    checkpoint_step,
    verified_checkpoints,
    verify_checkpoint,
)
from repro_torch.obs import HealthHalt, make_monitor


@dataclass(frozen=True)
class RecoveryPolicy:
    """What the supervisor is allowed to do per retry.

    max_retries        bounded: retry N times, then RecoveryExhausted
    lr_backoff         RecoveryPlan.lr_scale multiplier per retry
    momentum_backoff   RecoveryPlan.momentum_scale multiplier per retry
    quarantine_steps   probation window (meta steps) a suspect learner is
                       masked out of membership after rollback; 0 = never
                       quarantine
    readmit_clean_windows  quarantine hysteresis: the learner must sit
                       out M consecutive clean probation windows before
                       readmission — the total mask spans
                       ``quarantine_steps * M`` steps. 1 (the default)
                       is the single-window behavior, bit-for-bit.
    resalt_data        bump TrainConfig.data_salt per retry (redraw the
                       replayed batches; transient chaos faults drop out)
    """

    max_retries: int = 3
    lr_backoff: float = 0.5
    momentum_backoff: float = 1.0
    quarantine_steps: int = 0
    readmit_clean_windows: int = 1
    resalt_data: bool = True

    def __post_init__(self):
        assert self.max_retries >= 0, self.max_retries
        assert 0.0 < self.lr_backoff <= 1.0, self.lr_backoff
        assert 0.0 < self.momentum_backoff <= 1.0, self.momentum_backoff
        assert self.quarantine_steps >= 0, self.quarantine_steps
        assert self.readmit_clean_windows >= 1, self.readmit_clean_windows


@dataclass(frozen=True)
class RecoveryPlan:
    """One attempt's inputs — what the supervisor hands the trainer
    factory. Attempt 0 is the identity plan (scales 1.0, salt 0, no
    quarantine, fresh start)."""

    attempt: int = 0
    lr_scale: float = 1.0
    momentum_scale: float = 1.0
    data_salt: int = 0
    quarantine: tuple = field(default_factory=tuple)
    resume_path: Optional[str] = None


class RecoveryExhausted(RuntimeError):
    """The retry budget ran out (a sticky fault re-fired on every
    attempt). Carries the last fault record."""

    def __init__(self, fault: dict, attempts: int):
        self.fault = dict(fault)
        self.attempts = attempts
        super().__init__(
            f"supervised recovery exhausted after {attempts} attempt(s); "
            f"last fault: {fault.get('fault')!r} at meta_step "
            f"{fault.get('meta_step')}"
        )


class Supervisor:
    """Wraps ``Trainer.run`` in the rollback/retry loop.

    make_trainer   ``RecoveryPlan -> Trainer`` factory. Must honor the
                   plan: ``data_salt`` into TrainConfig, ``lr_scale`` /
                   ``momentum_scale`` into the lr schedule / mu. The
                   supervisor itself handles ``resume_path`` (restore)
                   and ``quarantine`` (set_membership).
    target_steps   the run completes when ``state.step`` reaches this —
                   each attempt runs only the REMAINING steps, so the
                   supervised run consumes equal effective samples.
    checkpoint_dir the verified chain rollback scans. The factory's
                   TrainConfig should checkpoint into the same directory.
    policy         RecoveryPolicy (default: 3 retries, lr halving,
                   re-salt, no quarantine).
    suspect_fn     optional ``meta_step -> learner | None`` attribution
                   hook for quarantine; defaults to the trainer's chaos
                   schedule oracle when one is attached (see
                   FaultSchedule.suspect).
    """

    def __init__(self, make_trainer: Callable[[RecoveryPlan], "object"], *,
                 target_steps: int, checkpoint_dir: Optional[str],
                 policy: Optional[RecoveryPolicy] = None,
                 suspect_fn: Optional[Callable[[int], Optional[int]]] = None):
        self.make_trainer = make_trainer
        self.target_steps = int(target_steps)
        self.checkpoint_dir = checkpoint_dir
        self.policy = policy or RecoveryPolicy()
        self.suspect_fn = suspect_fn
        # the supervisor's own watchdog surface: checkpoint-verify
        # failures and retry exhaustion become the same schema-valid
        # alert records every other failure mode gets (obs.health rules
        # checkpoint_verify_failed / recovery_exhausted), emitted into
        # the run log next to the fault/recovery records. halt=False:
        # the supervisor IS the halt handler.
        self.monitor = make_monitor(halt=False)
        self.records: list[dict] = []  # fault/recovery/alert, in order

    # ------------------------------------------------------------------
    def _emit(self, trainer, record: dict) -> None:
        self.records.append(dict(record))
        trainer.emit(record)

    def _alert(self, trainer, meta_step: int, metric: str) -> None:
        fired = self.monitor.observe([{"meta_step": meta_step, metric: 1.0}])
        for a in fired:
            self._emit(trainer, a)

    def _suspect(self, trainer, fault_step: int) -> Optional[int]:
        if self.suspect_fn is not None:
            return self.suspect_fn(fault_step)
        sched = getattr(trainer, "_chaos_schedule", None)
        return sched.suspect(fault_step) if sched is not None else None

    @staticmethod
    def _release(trainer) -> None:
        """Free the failed attempt's card memory before the next is built:
        close its sink, drop its state, return the cached blocks."""
        trainer.close()
        trainer.state = None
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def _quarantine(self, trainer, learners, start: int) -> None:
        """Mask ``learners`` out of membership for the probation span
        ``[start, start + quarantine_steps * readmit_clean_windows)``,
        keeping every row at least one learner strong; rows after the
        span are untouched, so the learner is readmitted automatically
        only after sitting out M consecutive clean windows (hysteresis —
        a marginal learner doesn't flap in and out every window). Skipped
        (with a note in the recovery record) on runs without a membership
        schedule."""
        import numpy as np

        topo = trainer.state.topo
        if not (isinstance(topo, dict) and "membership" in topo):
            return
        m = np.array(topo["membership"], np.float32)
        T = m.shape[0]
        span = self.policy.quarantine_steps * self.policy.readmit_clean_windows
        for s in range(start, start + span):
            row = m[s % T].copy()
            row[list(learners)] = 0.0
            if row.sum() >= 1.0:  # never quarantine the last learner
                m[s % T] = row
        trainer.set_membership(m)

    # ------------------------------------------------------------------
    def run(self, log=print):
        """Drive attempts until ``target_steps`` is reached. Returns
        ``(trainer, history)`` — the final (open) trainer and the
        concatenated flushed metric records of every attempt. Raises
        ``RecoveryExhausted`` when the retry budget runs out."""
        policy = self.policy
        plan = RecoveryPlan()
        history: list[dict] = []
        # rollback-point selection state: faults that recur without
        # forward progress deepen the walk-back (see below)
        walkback = 0
        last_fault_step: Optional[int] = None
        trainer = None
        while True:
            if trainer is not None:  # the failed attempt's
                self._release(trainer)
                trainer = None
            trainer = self.make_trainer(plan)
            if plan.resume_path is not None:
                trainer.restore(plan.resume_path)
            elif plan.attempt > 0:
                # scratch retry (no verified snapshot yet): still append
                # to the same run log — the recovery record documents the
                # rewind to step 0
                trainer._restored = True
            start = int(trainer.state.step)
            remaining = self.target_steps - start
            if remaining <= 0:
                return trainer, history
            if plan.quarantine:
                self._quarantine(trainer, plan.quarantine, start)
            if plan.attempt > 0 and history and \
                    getattr(trainer, "_monitor", None) is not None:
                # arm the retry's rel_* watchdogs with the pre-rollback
                # medians: a rebuilt trainer's monitor starts empty, and
                # a short retry can diverge to garbage entirely inside
                # ``min_history`` — seeding the healthy history below the
                # resume step makes loss_divergence fire on the FIRST
                # replayed step of a still-sick state
                trainer._monitor.seed(
                    r for r in history
                    if r.get("meta_step", self.target_steps) < start
                )
            try:
                trainer.run(remaining, log=log)
                history.extend(trainer.history)
                return trainer, history
            except (HealthHalt, CheckpointVerifyError) as e:
                history.extend(trainer.history)
                fault_step = int(trainer.state.step)
                attempt = plan.attempt + 1
                if isinstance(e, HealthHalt):
                    fault = {
                        "kind": "fault",
                        "fault": e.alert.get("rule"),
                        "layer": "health",
                        "meta_step": fault_step,
                        "attempt": plan.attempt,
                        "metric": e.alert.get("metric"),
                        "value": e.alert.get("value"),
                    }
                    # the halt snapshot of a sick state may itself be
                    # unverifiable (NaN planes) — probe it so the
                    # checkpoint_verify_failed watchdog has signal
                    if e.checkpoint_path is not None:
                        try:
                            verify_checkpoint(e.checkpoint_path)
                        except CheckpointVerifyError:
                            self._alert(
                                trainer, fault_step, "ckpt_verify_failed"
                            )
                else:
                    fault = {
                        "kind": "fault",
                        "fault": "checkpoint_verify_failed",
                        "layer": "checkpoint",
                        "meta_step": fault_step,
                        "attempt": plan.attempt,
                        "detail": str(e),
                    }
                    self._alert(trainer, fault_step, "ckpt_verify_failed")
                suspect = self._suspect(trainer, fault_step)
                if suspect is not None:
                    fault["learner"] = suspect
                self._emit(trainer, fault)

                if attempt > policy.max_retries:
                    self._alert(trainer, fault_step, "recovery_exhausted")
                    trainer.close()
                    raise RecoveryExhausted(fault, plan.attempt + 1) from e

                # Rollback target: the newest VERIFIED snapshot strictly
                # BEFORE the fault step. Integrity alone is not enough —
                # the emergency halt snapshot of a diverged-but-finite
                # state (e.g. a mis-scaled payload that blew the params
                # up without minting a NaN) verifies cleanly, and naive
                # latest-verified would "roll back" INTO it, replaying
                # the sick state on every retry. And when a retry halts
                # again without progressing past the previous fault, the
                # snapshot it resumed from is itself suspect (the
                # corruption landed before it was cut): walk one snapshot
                # further back per stalled retry, down to a scratch
                # restart.
                if last_fault_step is not None and \
                        fault_step <= last_fault_step:
                    walkback += 1
                else:
                    walkback = 0
                last_fault_step = fault_step
                chain = (
                    verified_checkpoints(
                        self.checkpoint_dir, before_step=fault_step
                    )
                    if self.checkpoint_dir else []
                )
                if walkback:
                    chain = chain[:-walkback] if walkback < len(chain) else []
                resume = chain[-1] if chain else None
                resume_step = 0 if resume is None else checkpoint_step(resume)
                quarantine = plan.quarantine
                actions = ["rollback"]
                if policy.quarantine_steps > 0 and suspect is not None:
                    quarantine = tuple(sorted(set(quarantine) | {suspect}))
                    actions.append("quarantine")
                if policy.lr_backoff < 1.0:
                    actions.append("lr_backoff")
                if policy.momentum_backoff < 1.0:
                    actions.append("momentum_backoff")
                if policy.resalt_data:
                    actions.append("resalt")
                plan = RecoveryPlan(
                    attempt=attempt,
                    lr_scale=plan.lr_scale * policy.lr_backoff,
                    momentum_scale=(
                        plan.momentum_scale * policy.momentum_backoff
                    ),
                    data_salt=(
                        plan.data_salt + 1 if policy.resalt_data
                        else plan.data_salt
                    ),
                    quarantine=quarantine,
                    resume_path=resume,
                )
                self._emit(trainer, {
                    "kind": "recovery",
                    "policy": "+".join(actions),
                    "attempt": attempt,
                    "meta_step": resume_step,
                    "resume_path": resume,
                    "lr_scale": plan.lr_scale,
                    "momentum_scale": plan.momentum_scale,
                    "data_salt": plan.data_salt,
                    "quarantine": list(quarantine),
                })
                if log:
                    log(
                        f"[supervisor] {fault['fault']} at meta_step "
                        f"{fault_step}; attempt {attempt}/"
                        f"{policy.max_retries}: {'+'.join(actions)} -> "
                        f"resume at {resume_step}"
                    )
