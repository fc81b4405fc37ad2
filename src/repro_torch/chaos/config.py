"""Fault-injection configuration (the JAX package's ``chaos/config.py``,
DESIGN.md §13), kept as a copy so the port imports nothing of ``repro``
(``tests/test_torch_isolation.py`` holds the two equal field for field).

A chaos run is fully described by a frozen, hashable ``ChaosConfig``: a
seed, a horizon, and a tuple of ``FaultSpec``s. Everything downstream (the
mask arrays of ``FaultSchedule``, the batch poisoner and payload corruptor
of ``inject.py``, the crash membership schedule) is a pure function of
this config and the retry ``salt``, so a chaos run is deterministic and
replayable.

Fault kinds, by the layer they perturb:

  nan_batch / inf_batch   data: the target learner's float batch leaves
                          for the step are poisoned on the way in.
                          Int-token LM batches have no float leaves and
                          are unaffected.
  payload_bitflip         comm: one seeded element of the target learner's
                          post-local-phase plane gets one bit XOR-flipped.
  payload_scale           comm: the target learner's whole plane is
                          scaled by ``magnitude`` (huge but finite).
  finite_scale /          the same two, bounded so the corrupted plane
  finite_bitflip          stays finite: invisible to the finite guard.
  crash                   topology: the learner is removed from the
                          elastic membership mask for ``duration`` steps.
  straggle                the async server: the learner's step-time
                          profile entry gains ``magnitude`` extra ticks
                          (the staleness bound is raised to stay valid).
  torn_save / corrupt_save  checkpoint (``repro_torch.checkpoint``): the
                          save at ``step`` is torn (truncated, no sidecar)
                          or corrupted (one byte flipped after the save).

``sticky``: a non-sticky fault is *transient*: it fires only on the first
attempt (retry ``salt`` 0). A sticky fault re-fires on every retry.
"""
from __future__ import annotations

from dataclasses import dataclass, field

FAULT_KINDS = (
    "nan_batch",
    "inf_batch",
    "payload_bitflip",
    "payload_scale",
    "crash",
    "straggle",
    "torn_save",
    "corrupt_save",
    "finite_scale",
    "finite_bitflip",
)

# kinds that target a specific learner (the rest target the run)
LEARNER_KINDS = (
    "nan_batch", "inf_batch", "payload_bitflip", "payload_scale",
    "crash", "straggle", "finite_scale", "finite_bitflip",
)

# the largest |magnitude| a finite_scale fault may carry: scaled f32
# payloads of magnitude up to ~2^87 stay strictly below the f32 max
# (2^40 * 2^87 < 2^128), so the corrupted plane is finite BY CONSTRUCTION
FINITE_SCALE_MAX = 2.0 ** 40


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault.

    kind       one of ``FAULT_KINDS``
    step       absolute meta step the fault fires at
    learner    target learner index (learner-targeted kinds; -1 draws one
               deterministically from ``ChaosConfig.seed`` and ``step``)
    duration   steps the fault persists (nan/inf bursts, crash windows)
    magnitude  payload_scale multiplier / straggle extra ticks
    bit        payload_bitflip: which bit of the f32 word to flip
               (bf16 planes flip ``bit - 16``; bits below 16 are then
               clamped to the sign of the mantissa head)
    sticky     re-fires on supervisor retries (see module docstring)
    """

    kind: str
    step: int
    learner: int = -1
    duration: int = 1
    magnitude: float = 8.0
    bit: int = 30
    sticky: bool = False

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, (
            f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}"
        )
        assert self.step >= 0, self.step
        assert self.duration >= 1, self.duration
        assert 0 <= self.bit <= 31, self.bit
        if self.kind in ("torn_save", "corrupt_save"):
            assert self.learner == -1, (
                f"{self.kind} targets the run's save path, not a learner"
            )
        if self.kind == "finite_scale":
            # the finiteness guarantee is by construction, not hope: the
            # multiplier itself must be finite and bounded away from the
            # f32 overflow region (see FINITE_SCALE_MAX)
            import math

            assert math.isfinite(self.magnitude), self.magnitude
            assert 0 < abs(self.magnitude) <= FINITE_SCALE_MAX, (
                f"finite_scale magnitude {self.magnitude} outside "
                f"(0, {FINITE_SCALE_MAX}]"
            )
        if self.kind == "finite_bitflip":
            # mask the exponent-top bit: flipping bit 30 (f32) / 14 (bf16)
            # of a normal value lands in the inf/NaN exponent range, which
            # is exactly what the finite guard WOULD catch. Bits <= 29
            # produce huge-but-finite corruption the guard cannot see.
            object.__setattr__(self, "bit", min(self.bit, 29))


@dataclass(frozen=True)
class ChaosConfig:
    """The whole fault schedule: seed + horizon + fault tuple (frozen,
    hashable — rides in TrainConfig like every other config).

    horizon    schedule length T in meta steps; every fault must fire and
               expire within it (faults are compiled to (T, L) masks).
               Also the period of the crash membership schedule, so keep
               ``horizon >= meta_steps`` when crashes are injected — the
               schedule then never wraps and quarantine windows map 1:1
               onto absolute steps.
    """

    seed: int = 0
    horizon: int = 64
    faults: tuple = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        assert self.horizon >= 1, self.horizon
        for f in self.faults:
            assert isinstance(f, FaultSpec), f
            assert f.step + f.duration <= self.horizon, (
                f"fault {f.kind!r} at step {f.step} (duration "
                f"{f.duration}) exceeds the chaos horizon {self.horizon}"
            )

    @property
    def has_crash(self) -> bool:
        return any(f.kind == "crash" for f in self.faults)

    @property
    def has_straggle(self) -> bool:
        return any(f.kind == "straggle" for f in self.faults)


STANDARD_KINDS = ("crash", "nan", "payload", "straggle", "torn_save")


def standard_chaos(num_learners: int, meta_steps: int, *, seed: int = 0,
                   kinds=STANDARD_KINDS) -> ChaosConfig:
    """The chaos bench's standard fault schedule (crash + NaN burst +
    payload corruption + straggle + torn save), sized to the run: faults
    land in the first half so a supervised run has room to recover, the
    horizon covers the whole run so the crash schedule never wraps.
    ``kinds`` selects a subset (CLI ``--chaos-faults``)."""
    assert num_learners >= 2, num_learners
    assert meta_steps >= 8, (
        f"the standard chaos schedule needs >= 8 meta steps to place its "
        f"faults, got {meta_steps}"
    )
    q = max(meta_steps // 8, 1)
    faults = []
    if "crash" in kinds:
        faults.append(FaultSpec("crash", step=q, learner=1,
                                duration=min(2 * q, meta_steps - q)))
    if "nan" in kinds:
        faults.append(FaultSpec("nan_batch", step=2 * q, learner=0))
    if "payload" in kinds:
        faults.append(FaultSpec("payload_scale", step=3 * q,
                                learner=num_learners - 1, magnitude=64.0))
        faults.append(FaultSpec("payload_bitflip", step=4 * q,
                                learner=num_learners - 1))
    if "straggle" in kinds:
        faults.append(FaultSpec("straggle", step=0, learner=1,
                                magnitude=1.0, duration=1))
    if "torn_save" in kinds:
        faults.append(FaultSpec("torn_save", step=5 * q))
    return ChaosConfig(seed=seed, horizon=max(meta_steps, 8),
                       faults=tuple(faults))
