"""Run-health watchdogs: declarative rules over flushed metric windows
(the JAX package's ``obs/health.py``, rule for rule).

The Trainer flushes one window of host-side metric records per
``log_every`` boundary (``repro_torch.obs.metrics``). A ``HealthMonitor`` consumes
exactly those records — it never touches device buffers, adds no syncs,
and is therefore bitwise-invisible to a healthy run (pinned in
tests/test_torch_obs_health.py). Per record it evaluates a list of
``HealthRule``s:

* ``nonfinite`` — the metric is NaN/inf (a dead run: NaN loss or
  displacement norm propagates to every parameter within one meta step);
* ``max`` / ``min`` — absolute threshold (e.g. mixing_spectral_gap
  collapsing toward 0 under churn means consensus has stalled);
* ``rel_max`` / ``rel_min`` — the value vs the trailing-window median of
  the SAME metric (loss divergence, consensus_dist blow-up, throughput
  collapse — the straggler signal: a skewed learner drags
  meta_steps_per_sec down long before it shows in loss).

Violations become structured ``alert`` records (``kind: "alert"``,
schema-validated by tools/check_telemetry.py) appended to the run sink
next to the step records they fired on. A ``fatal`` rule additionally
asks the Trainer to halt-with-checkpoint: the run stops at the next
flush boundary with a resumable checkpoint and a ``HealthHalt``
exception carrying the alert — crash forensics with a restart point, not
a stack trace and a dead run.

This signal surface is what the ROADMAP's K/μ autotuner and the async
bounded-staleness server consume: both need machine-readable "this run
is sick, and how" long before a human reads a loss curve.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, replace

SEVERITIES = ("warn", "fatal")
RULE_KINDS = ("nonfinite", "max", "min", "rel_max", "rel_min")


@dataclass(frozen=True)
class HealthRule:
    """One declarative health check over a single metric.

    name         alert identity (rule field of the emitted record)
    metric       key of the flushed step record to watch (absent -> skip)
    kind         nonfinite | max | min | rel_max | rel_min
    threshold    absolute bound (max/min) or multiplier vs the trailing
                 median (rel_max: fire when value > median * threshold;
                 rel_min: fire when value < median * threshold)
    window       trailing history length for the rel_* median
    min_history  rel_* rules stay silent until this many prior values —
                 the first windows of a run are legitimately wild
    severity     warn (record only) | fatal (record + request halt)
    """

    name: str
    metric: str
    kind: str
    threshold: float = 0.0
    window: int = 16
    min_history: int = 4
    severity: str = "warn"

    def __post_init__(self):
        assert self.kind in RULE_KINDS, (
            f"unknown rule kind {self.kind!r}; choose from {RULE_KINDS}"
        )
        assert self.severity in SEVERITIES, (
            f"unknown severity {self.severity!r}; choose from {SEVERITIES}"
        )
        assert self.window >= 1 and self.min_history >= 1

    @property
    def halt(self) -> bool:
        return self.severity == "fatal"


# the default watch list: the failure modes this repo's subsystems have
# actual metrics for. Divergence multipliers are deliberately loose —
# a watchdog that cries on a noisy-but-converging run teaches people to
# disable it.
DEFAULT_RULES = (
    HealthRule("nonfinite_loss", "loss", "nonfinite", severity="fatal"),
    HealthRule("nonfinite_displacement", "displacement_norm", "nonfinite",
               severity="fatal"),
    HealthRule("loss_divergence", "loss", "rel_max", threshold=10.0,
               severity="fatal"),
    HealthRule("consensus_blowup", "consensus_dist", "rel_max",
               threshold=50.0),
    HealthRule("spectral_gap_collapse", "mixing_spectral_gap", "min",
               threshold=1e-4),
    # straggler skew: per-learner step times aren't separable under SPMD
    # (one fused program), so the observable is the window throughput —
    # a straggling host/device drags meta_steps_per_sec far below its
    # own trailing median
    HealthRule("throughput_collapse", "meta_steps_per_sec", "rel_min",
               threshold=0.1, min_history=8),
    # async bounded-staleness server: applied staleness is bounded by
    # construction (tau <= AsyncConfig.staleness, validated at config
    # time), so a p99 drifting past any sane bound means the step-time
    # profile or the clock state is corrupt — absolute, loose, and absent
    # from synchronous runs (absent metric -> rule skipped)
    HealthRule("staleness_runaway", "staleness_p99", "max",
               threshold=32.0),
    # supervised recovery (core/supervisor.py, DESIGN.md §13): the
    # supervisor feeds these synthetic metrics into its own monitor so
    # checkpoint-chain damage and retry exhaustion surface as the same
    # schema-valid alert records every other failure mode gets. Both
    # metrics are absent from ordinary step records, so the rules are
    # skipped on every normal run.
    HealthRule("checkpoint_verify_failed", "ckpt_verify_failed", "max",
               threshold=0.0, severity="warn"),
    HealthRule("recovery_exhausted", "recovery_exhausted", "max",
               threshold=0.0, severity="fatal"),
)


class HealthHalt(RuntimeError):
    """A fatal health rule fired and the Trainer halted the run.

    Carries the triggering alert record and the path of the checkpoint
    written at the halt boundary (None when checkpointing was off)."""

    def __init__(self, alert: dict, checkpoint_path=None):
        self.alert = dict(alert)
        self.checkpoint_path = checkpoint_path
        where = f"; checkpoint at {checkpoint_path}" if checkpoint_path else ""
        super().__init__(
            f"health rule {alert.get('rule')!r} fired on "
            f"{alert.get('metric')!r}={alert.get('value')!r} at meta_step "
            f"{alert.get('meta_step')}{where}"
        )


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


class HealthMonitor:
    """Evaluates rules against each flushed record; collects alerts.

    ``observe(records)`` returns the alert dicts fired by this window (in
    record order) and remembers whether any of them requested a halt
    (``halt_requested`` / ``halt_alert``). Each record is checked against
    the history EXCLUDING itself, then pushed into the trailing windows —
    so a divergence rule compares today against the recent past, not
    against a median it already contaminated. Non-finite values are never
    pushed into rel_* histories (one NaN would poison every later
    median).
    """

    def __init__(self, rules=DEFAULT_RULES):
        self.rules = tuple(rules)
        self._hist: dict[str, deque] = {
            r.metric: deque(maxlen=r.window)
            for r in self.rules if r.kind in ("rel_max", "rel_min")
        }
        # widen a shared metric's window to the largest requesting rule
        for r in self.rules:
            if r.metric in self._hist and r.window > (
                    self._hist[r.metric].maxlen or 0):
                self._hist[r.metric] = deque(
                    self._hist[r.metric], maxlen=r.window
                )
        self.alerts: list[dict] = []
        self.halt_alert: dict | None = None

    @property
    def halt_requested(self) -> bool:
        return self.halt_alert is not None

    # ------------------------------------------------------------------
    def _check(self, rule: HealthRule, value, record) -> dict | None:
        if rule.kind == "nonfinite":
            if _finite(value):
                return None
            reference = None
        elif rule.kind == "max":
            if not _finite(value) or float(value) <= rule.threshold:
                return None
            reference = rule.threshold
        elif rule.kind == "min":
            if not _finite(value) or float(value) >= rule.threshold:
                return None
            reference = rule.threshold
        else:  # rel_max / rel_min vs trailing median
            hist = self._hist[rule.metric]
            if not _finite(value) or len(hist) < rule.min_history:
                return None
            med = _median(hist)
            if rule.kind == "rel_max":
                if med <= 0 or float(value) <= med * rule.threshold:
                    return None
            else:
                if med <= 0 or float(value) >= med * rule.threshold:
                    return None
            reference = med
        alert = {
            "kind": "alert",
            "rule": rule.name,
            "metric": rule.metric,
            "value": float(value) if value is not None else None,
            "severity": rule.severity,
            "halt": rule.halt,
            "meta_step": record.get("meta_step"),
            "rule_kind": rule.kind,
            "threshold": rule.threshold,
            "window": rule.window,
        }
        if reference is not None:
            alert["reference"] = float(reference)
        return alert

    def seed(self, records) -> None:
        """Pre-load the rel_* trailing windows from historical records
        WITHOUT evaluating any rule. A rolled-back retry remembers its
        pre-fault medians (core/supervisor.py seeds the rebuilt
        trainer's monitor with the history below the resume step) —
        otherwise a short retry diverges silently inside ``min_history``
        and the rel_* watchdogs never arm."""
        for rec in records:
            for metric, hist in self._hist.items():
                if metric in rec and _finite(rec[metric]):
                    hist.append(float(rec[metric]))

    def observe(self, records) -> list[dict]:
        fired = []
        for rec in records:
            for rule in self.rules:
                if rule.metric not in rec:
                    continue
                alert = self._check(rule, rec[rule.metric], rec)
                if alert is not None:
                    fired.append(alert)
                    if alert["halt"] and self.halt_alert is None:
                        self.halt_alert = alert
            # push AFTER checking: the rel_* median is strictly trailing
            for metric, hist in self._hist.items():
                if metric in rec and _finite(rec[metric]):
                    hist.append(float(rec[metric]))
        self.alerts.extend(fired)
        return fired


def make_monitor(rules=None, *, halt: bool = True) -> HealthMonitor:
    """Monitor over ``rules`` (default ``DEFAULT_RULES``). ``halt=False``
    demotes every fatal rule to warn — alerts are still recorded, the
    run never stops (ObsConfig.health_halt)."""
    rules = DEFAULT_RULES if rules is None else tuple(rules)
    if not halt:
        rules = tuple(
            replace(r, severity="warn") if r.severity == "fatal" else r
            for r in rules
        )
    return HealthMonitor(rules)
