"""Fault injectors, one per layer (the JAX package's ``chaos/inject.py``).
Each is a no-op that leaves a run bitwise as it was when its schedule is
quiet.

  wrap_batch_fn      data layer: poisons the target learner's float batch
                     leaves with NaN/Inf as the batches come in.
  PayloadCorruptor   comm layer: corrupts the post-local-phase learner
                     planes (the payload the reducer is about to ship):
                     whole-plane scale and a single real bit-flip.
  apply_chaos        topology layer, a config transform: crash windows
                     become rows of an explicit elastic membership
                     schedule, and straggle spikes land on the async
                     server's step-time profile (with the staleness bound
                     raised to keep the config valid).

Where the port differs from JAX in execution, not in math: JAX selects the
corrupted planes with a ``where`` over the whole (L, ...) stack and flips
its bit through a one-hot over every element of the learner plane (a
6.9 GB temporary per learner at full width). The port writes in place and
only into the dirty learners: it scales their planes window by window
(in f32, rounded back to the plane's dtype, as JAX does) and XORs one
word of the first float leaf through an integer view at ``pos % n``.
Clean learners and quiet steps are never written.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.chaos.config import ChaosConfig
from repro_torch.chaos.schedule import FaultSchedule
from repro_torch.configs.base import AsyncConfig, ElasticConfig, MAvgConfig
from repro_torch.kernels.planes import f32, windows
from repro_torch.utils.tree import tree_leaves, tree_map

def wrap_batch_fn(batch_fn, schedule: FaultSchedule):
    """``batch_fn`` with the schedule's NaN/Inf batch faults applied to the
    target learner's float leaves (leading axis L). Int-token LM batches
    carry no float leaves and pass through untouched. Returns ``batch_fn``
    itself when the schedule has no batch faults."""
    if not schedule.any_batch_faults:
        return batch_fn

    def wrapped(gen, step):
        b = batch_fn(gen, step)
        nan, inf = schedule.batch_fault_at(int(step))
        if not (nan.any() or inf.any()):
            return b

        def poison(x):
            if not x.is_floating_point():
                return x
            x = x.clone()
            x[torch.from_numpy(nan.astype(bool)).to(x.device)] = float("nan")
            x[torch.from_numpy(inf.astype(bool)).to(x.device)] = float("inf")
            return x

        return tree_map(poison, b)

    return wrapped


def _flip_word(x: torch.Tensor, j: int, word: int, pos: int) -> None:
    """XOR ``word`` (the f32 bit mask) into element ``pos % n`` of learner
    ``j``'s plane of ``x``, in place. bf16 planes take the top half of the
    word (bit - 16); a bit below 16 then flips nothing."""
    w32 = np.int32(word)
    if x.dtype == torch.float32:
        itype, mask = torch.int32, int(w32)
    elif x.dtype == torch.bfloat16:
        itype = torch.int16
        mask = int(np.uint16(w32.view(np.uint32) >> np.uint32(16))
                   .view(np.int16))
    else:
        return
    words = x[j].reshape(-1).view(itype)
    i = pos % words.numel()
    words[i:i + 1].bitwise_xor_(mask)


class PayloadCorruptor:
    """Payload corruption gated on the compiled schedule arrays.

    ``__call__(learners, step)`` scales every float leaf of the dirty
    learners (f32 math, rounded back to the leaf's dtype) and bit-flips
    one seeded element of the first float leaf (under packing that leaf
    IS the whole-model plane), in place. Clean learners and quiet steps
    are left untouched.
    """

    def __init__(self, schedule: FaultSchedule):
        T, L = schedule.cfg.horizon, schedule.num_learners

        def pad(a, fill):
            # trailing all-clear row: steps beyond the horizon index it
            return np.concatenate([a, np.full((1, L), fill, a.dtype)], 0)

        self._scale = pad(schedule.scale, 1.0).astype(np.float32)
        self._xor = pad(schedule.xor, 0).astype(np.int32)
        self._pos = pad(schedule.pos, 0).astype(np.int32)
        self._T = T
        self.active = schedule.any_payload_faults

    def __call__(self, learners, step):
        idx = min(int(step), self._T)
        scale, xorm, pos = self._scale[idx], self._xor[idx], self._pos[idx]
        dirty = (scale != 1.0) | (xorm != 0)
        leaves = [x for x in tree_leaves(learners) if x.is_floating_point()]
        for j in np.flatnonzero(dirty).tolist():
            s = f32(scale[j])
            for x in leaves:
                xj = x[j].reshape(-1)
                for sl in windows(xj.numel()):
                    w = xj[sl]
                    if w.dtype == torch.float32:
                        w.mul_(s)
                    else:
                        w.copy_(w.to(torch.float32).mul_(s))
            if leaves and xorm[j] != 0:
                _flip_word(leaves[0], j, int(xorm[j]), int(pos[j]))
        return learners


def _crash_membership(schedule: FaultSchedule, topo_cfg) -> np.ndarray:
    """(horizon, L) membership rows: the configured elastic schedule (if
    any) ANDed with the crash windows."""
    crash = schedule.crash_schedule()
    T, L = crash.shape
    if topo_cfg.elastic is not None:
        from repro_torch.topology.elastic import membership_schedule

        groups = topo_cfg.groups if topo_cfg.kind == "hierarchical" else 1
        base = membership_schedule(L, topo_cfg.elastic, groups=groups)
        P = base.shape[0]
        rows = np.stack([base[s % P] for s in range(T)]) * crash
    else:
        rows = crash
    if (rows.sum(axis=1) < 1.0).any():
        bad = int(np.argmin(rows.sum(axis=1)))
        raise ValueError(
            f"chaos crash schedule leaves NO learner present at step "
            f"{bad} (crash windows composed with the elastic schedule) — "
            f"shrink the crash duration or the elastic drop_frac"
        )
    return rows


def apply_chaos(mcfg: MAvgConfig, chaos: ChaosConfig, *,
                salt: int = 0) -> MAvgConfig:
    """The config-level injections: crash faults -> an explicit elastic
    membership schedule, straggle faults -> the async step-time profile
    (with the staleness bound raised to stay valid). With neither fault
    kind present the config is returned UNCHANGED (the identical
    object)."""
    # STRUCTURE is decided at salt 0, CONTENT at the caller's salt: a retry
    # that drops a transient crash still carries the membership schedule
    schedule0 = FaultSchedule(chaos, mcfg.num_learners, salt=0)
    schedule = (schedule0 if salt == 0
                else FaultSchedule(chaos, mcfg.num_learners, salt=salt))
    t = mcfg.topology
    if not (schedule0.any_crash_faults or schedule0.straggle_extra.any()):
        return mcfg
    if schedule0.any_crash_faults:
        if t.kind == "flat":
            raise ValueError(
                "chaos crash faults map onto the elastic membership mask, "
                "which the flat topology has no mixing rows for — use "
                "hierarchical / gossip / async (TopologyConfig.kind)"
            )
        rows = _crash_membership(schedule, t)
        elastic = t.elastic if t.elastic is not None else ElasticConfig(
            drop_frac=0.0)
        elastic = replace(
            elastic, period=rows.shape[0],
            schedule=tuple(tuple(float(v) for v in r) for r in rows),
        )
        t = replace(t, elastic=elastic)
    if schedule0.straggle_extra.any():
        if t.kind != "async":
            raise ValueError(
                "chaos straggle faults perturb the async server's "
                "step-time profile — use TopologyConfig(kind='async')"
            )
        from repro_torch.topology.async_server import step_time_profile

        server = t.server if t.server is not None else AsyncConfig()
        prof = schedule.straggled_profile(
            step_time_profile(mcfg.num_learners, server))
        server = replace(server, step_time=prof,
                         staleness=max(server.staleness, max(prof) - 1))
        t = replace(t, server=server)
    return replace(mcfg, topology=t)
