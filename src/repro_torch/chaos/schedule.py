"""``FaultSchedule``: the compiled, replayable form of a ``ChaosConfig``
(the JAX package's ``chaos/schedule.py``, numpy as there).

The schedule of faults is a deterministic function of the config,
compiled into per-step numpy mask arrays indexed by the absolute meta
step; the seeded draws use ``numpy.random.RandomState`` exactly as JAX's
copy does, so both packages compile the same arrays. A resumed run
replays the same faults.

Retry semantics ride on ``salt`` (the retry counter): non-sticky faults
exist only at salt 0, sticky ones at every salt.

Steps at or beyond the horizon are fault-free: the payload corruptor's
arrays carry a trailing all-clear row and clamp the index, and every
host-side lookup bounds-checks.
"""
from __future__ import annotations

import numpy as np

from repro_torch.chaos.config import ChaosConfig, FaultSpec


class FaultSchedule:
    """Per-kind mask arrays over ``(horizon, num_learners)``.

    nan / inf        (T, L) f32 0/1 — poison the learner's batch floats
    scale            (T, L) f32 — payload multiplier (1.0 = clean)
    xor              (T, L) int32 — payload bit-flip word (0 = clean)
    pos              (T, L) int32 — seeded raw index of the flipped
                     element (the corruptor mods it by the plane size)
    crash            (T, L) f32 0/1 — 0 while the learner is crashed
    straggle_extra   (L,) int — extra step-time ticks per learner
    save faults      {step: "torn" | "corrupt"}
    """

    def __init__(self, cfg: ChaosConfig, num_learners: int, *,
                 salt: int = 0):
        self.cfg = cfg
        self.num_learners = int(num_learners)
        self.salt = int(salt)
        T, L = cfg.horizon, self.num_learners
        self.nan = np.zeros((T, L), np.float32)
        self.inf = np.zeros((T, L), np.float32)
        self.scale = np.ones((T, L), np.float32)
        self.xor = np.zeros((T, L), np.int32)
        self.pos = np.zeros((T, L), np.int32)
        self.crash = np.ones((T, L), np.float32)
        self.straggle_extra = np.zeros((L,), np.int64)
        self.save_faults: dict[int, str] = {}
        for f in cfg.faults:
            if not (f.sticky or salt == 0):
                continue  # transient fault: the retry replays clean
            self._compile(f)

    # ------------------------------------------------------------------
    def _learner(self, f: FaultSpec) -> int:
        if f.learner >= 0:
            assert f.learner < self.num_learners, (f, self.num_learners)
            return f.learner
        # seeded draw, deterministic per (config seed, fault step/kind)
        rng = np.random.RandomState(
            (self.cfg.seed * 1000003 + f.step * 101
             + hash(f.kind) % 9973) % (2**31)
        )
        return int(rng.randint(0, self.num_learners))

    def _compile(self, f: FaultSpec) -> None:
        steps = range(f.step, f.step + f.duration)
        if f.kind in ("torn_save", "corrupt_save"):
            tag = "torn" if f.kind == "torn_save" else "corrupt"
            for s in steps:
                self.save_faults[s] = tag
            return
        j = self._learner(f)
        if f.kind == "nan_batch":
            self.nan[f.step: f.step + f.duration, j] = 1.0
        elif f.kind == "inf_batch":
            self.inf[f.step: f.step + f.duration, j] = 1.0
        elif f.kind in ("payload_scale", "finite_scale"):
            # finite_scale rides the same compiled array: the finiteness
            # guarantee lives in FaultSpec validation (bounded finite
            # magnitude), not in a separate injection path
            self.scale[f.step: f.step + f.duration, j] = f.magnitude
        elif f.kind in ("payload_bitflip", "finite_bitflip"):
            word = np.int32(np.uint32(1 << f.bit).view(np.int32))
            self.xor[f.step: f.step + f.duration, j] = word
            rng = np.random.RandomState(
                (self.cfg.seed * 7919 + f.step * 31 + j) % (2**31)
            )
            self.pos[f.step: f.step + f.duration, j] = rng.randint(
                0, 2**31 - 1
            )
        elif f.kind == "crash":
            self.crash[f.step: f.step + f.duration, j] = 0.0
        elif f.kind == "straggle":
            self.straggle_extra[j] += int(f.magnitude)

    # ------------------------------------------------------------------
    # host-side lookups (batch poisoning, save faults, attribution)
    # ------------------------------------------------------------------

    def batch_fault_at(self, step: int):
        """(nan_mask, inf_mask): (L,) f32 0/1 host arrays for ``step``
        (all-clear beyond the horizon)."""
        if 0 <= step < self.cfg.horizon:
            return self.nan[step], self.inf[step]
        z = np.zeros((self.num_learners,), np.float32)
        return z, z

    def save_fault(self, step: int):
        """``"torn"`` / ``"corrupt"`` / None for the save at ``step`` —
        threaded into ``checkpoint.save_state(fault=...)``."""
        return self.save_faults.get(int(step))

    def suspect(self, step: int):
        """The learner most recently targeted by a data/payload fault at
        or before ``step`` (None if none) — the attribution oracle the
        supervisor's quarantine policy consumes in tests/benches. Real
        deployments would attribute from telemetry (per-learner loss
        spread, comm CRC failures); under injected chaos the schedule
        itself is ground truth."""
        hi = min(int(step), self.cfg.horizon - 1)
        for s in range(hi, -1, -1):
            for mask in (self.nan[s], self.inf[s]):
                if mask.any():
                    return int(np.argmax(mask))
            if (self.scale[s] != 1.0).any():
                return int(np.argmax(self.scale[s] != 1.0))
            if (self.xor[s] != 0).any():
                return int(np.argmax(self.xor[s] != 0))
        return None

    # ------------------------------------------------------------------
    # compiled views for the other layers
    # ------------------------------------------------------------------

    @property
    def any_batch_faults(self) -> bool:
        return bool(self.nan.any() or self.inf.any())

    @property
    def any_payload_faults(self) -> bool:
        return bool((self.scale != 1.0).any() or (self.xor != 0).any())

    @property
    def any_crash_faults(self) -> bool:
        return bool((self.crash == 0.0).any())

    def crash_schedule(self) -> np.ndarray:
        """(T, L) 0/1 membership rows encoding the crash windows — ANDed
        into the elastic membership schedule by ``inject.apply_chaos``."""
        return self.crash.copy()

    def straggled_profile(self, profile) -> tuple:
        """The async step-time profile with straggle spikes added."""
        prof = np.asarray(profile, np.int64)
        assert prof.shape == (self.num_learners,), (
            prof.shape, self.num_learners
        )
        return tuple(int(t) for t in prof + self.straggle_extra)
