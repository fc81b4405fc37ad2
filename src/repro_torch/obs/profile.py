"""Steady-state timing and phase attribution (the JAX package's
``obs/profile.py``).

Every timing number flows through one harness, so the method is stated
once:

* **steady state**: ``warmup`` untimed calls first, so first-touch
  allocation, cuBLAS heuristics and kernel builds never leak into a
  reported number;
* **device completion**: on the card each timed call sits between two
  ``torch.cuda.synchronize()`` calls, so what is measured is the card
  finishing the work, not the host enqueueing it; on the CPU the call is
  synchronous already;
* **median of N with the IQR**: the reported statistic is the median over
  ``iters`` repeats, with the interquartile range as the noise bar.

``profile_fn`` joins the timing of a function with its modeled cost
(``roofline.cost.jit_cost``, counted on meta copies of the arguments, as
JAX joins it with ``roofline.hlo_cost``): ``modeled_hbm_bytes``,
``modeled_flops``, ``achieved_gbps`` (modeled bytes over the measured
seconds) and ``pct_of_bound`` against ``measured_peak_gbps``. A function
that reads values on the host has no meta cost: its row carries the
timing alone, as JAX's rows do without a cost. ``profile_phases`` times the three parts of one meta
iteration: the whole step, the local phase alone and the meta mix alone.

JAX times functional copies of its donated step. The port's step updates
the state in place, so ``profile_phases`` clones the state once and times
on the clone: the live state is untouched. A clone that would not fit the
card raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch


# ---------------------------------------------------------------------------
# steady-state timing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Timing:
    """Median-of-N wall clock with IQR noise bar (seconds)."""

    median_s: float
    iqr_s: float
    n: int
    warmup: int
    times_s: tuple

    @property
    def median_us(self) -> float:
        return self.median_s * 1e6

    @property
    def iqr_us(self) -> float:
        return self.iqr_s * 1e6


def _quantile(sorted_xs, q: float) -> float:
    """Linear-interpolated quantile of an already-sorted list."""
    if len(sorted_xs) == 1:
        return sorted_xs[0]
    pos = q * (len(sorted_xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_xs) - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1 - frac) + sorted_xs[hi] * frac


def _has_cuda(obj) -> bool:
    """Whether ``obj`` (a tensor, or a dataclass / dict / list / tuple of
    them) holds a tensor on the card."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(_has_cuda(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return any(_has_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_cuda(v) for v in obj)
    return False


def steady_timeit(fn, *args, iters: int = 10, warmup: int = 2) -> Timing:
    """Time ``fn(*args)`` in steady state; returns a :class:`Timing`.

    Where the arguments or the result lie on the card, every timed call is
    bracketed by ``torch.cuda.synchronize()``: the measurement runs from
    dispatch to the card's completion.
    """
    assert iters >= 1 and warmup >= 0, (iters, warmup)
    cuda = _has_cuda(args)
    for _ in range(warmup):
        cuda = _has_cuda(fn(*args)) or cuda
    times = []
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda or _has_cuda(out):
            cuda = True
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    xs = sorted(times)
    return Timing(
        median_s=_quantile(xs, 0.5),
        iqr_s=_quantile(xs, 0.75) - _quantile(xs, 0.25),
        n=iters,
        warmup=warmup,
        times_s=tuple(times),
    )


# ---------------------------------------------------------------------------
# measured peak bandwidth
# ---------------------------------------------------------------------------

_PEAK_CACHE: dict[tuple, float] = {}


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def measured_peak_gbps(nbytes: int = 1 << 26, *, device=None,
                       refresh: bool = False, iters: int = 5,
                       warmup: int = 2) -> float:
    """Achievable memory bandwidth of ``device`` (default: the card when
    one is visible), GB/s: the triad ``y + 1.5 x`` over ``nbytes`` of f32
    in one ``torch.add`` (two reads and one write, as JAX's fused triad),
    timed by ``steady_timeit``. Cached per (device, size): one measurement
    per process."""
    dev = torch.device(device) if device is not None else _default_device()
    key = (str(dev), nbytes)
    if not refresh and key in _PEAK_CACHE:
        return _PEAK_CACHE[key]
    n = max(nbytes // 4, 1024)
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.ones(n, dtype=torch.float32, device=dev)
    t = steady_timeit(lambda a, b: torch.add(b, a, alpha=1.5), x, y,
                      iters=iters, warmup=warmup)
    gbps = 3.0 * n * 4 / t.median_s / 1e9
    _PEAK_CACHE[key] = gbps
    return gbps


# ---------------------------------------------------------------------------
# attribution rows
# ---------------------------------------------------------------------------


def attribution_row(op: str, timing: Timing, cost=None, *,
                    peak_gbps: float | None = None, device=None,
                    extra=None) -> dict:
    """One measured :class:`Timing` as the canonical attribution record;
    ``backend`` is the torch device type of ``device`` (default: the card
    when one is visible). Given a ``cost`` (any object with ``hbm_bytes``
    and ``flops``), the modeled bytes, ``achieved_gbps`` and, with
    ``peak_gbps``, ``pct_of_bound`` are added as in JAX."""
    dev = torch.device(device) if device is not None else _default_device()
    row = {
        "kind": "attribution",
        "op": op,
        "median_us": timing.median_us,
        "iqr_us": timing.iqr_us,
        "iters": timing.n,
        "warmup": timing.warmup,
        "backend": dev.type,
    }
    if cost is not None:
        achieved = cost.hbm_bytes / timing.median_s / 1e9
        row.update(
            modeled_hbm_bytes=float(cost.hbm_bytes),
            modeled_flops=float(cost.flops),
            achieved_gbps=achieved,
        )
        if peak_gbps:
            row.update(
                peak_gbps=float(peak_gbps),
                pct_of_bound=100.0 * achieved / peak_gbps,
            )
    if extra:
        row.update(extra)
    return row


def profile_fn(op: str, fn, *args, iters: int = 10, warmup: int = 2,
               peak_gbps: float | None = None, device=None, extra=None,
               host=()) -> dict:
    """Model ``fn(*args)`` (``jit_cost`` on meta copies; ``host``: the
    argument tensors it reads on the host, kept there) and time it in
    steady state; returns the attribution row joining the two."""
    from repro_torch.roofline.cost import jit_cost

    try:
        cost = jit_cost(fn, *args, host=host)
    except (RuntimeError, NotImplementedError):
        cost = None  # a host read of a meta value (.item(), .tolist())
    timing = steady_timeit(fn, *args, iters=iters, warmup=warmup)
    return attribution_row(op, timing, cost, peak_gbps=peak_gbps,
                           device=device, extra=extra)


# ---------------------------------------------------------------------------
# training-phase attribution: whole step, local phase, meta mix
# ---------------------------------------------------------------------------


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


_STATE_PLANES = ("global_params", "momentum", "learners", "local_momentum",
                 "comm_residual", "topo")


def clone_state(state):
    """A copy of ``state`` with every buffer cloned, for timing the in-place
    step without touching the live state. Raises ``ValueError`` when the
    copy of the state's card buffers would not fit the card's free memory
    (the free bytes ``mem_get_info`` reports plus what the caching
    allocator holds unused)."""
    on_card = [t for t in _tensors(state) if t.is_cuda]
    need = sum(t.numel() * t.element_size() for t in on_card)
    if need:
        dev = on_card[0].device
        free, _ = torch.cuda.mem_get_info(dev)
        free += (torch.cuda.memory_reserved(dev)
                 - torch.cuda.memory_allocated(dev))
        if need > free:
            raise ValueError(
                f"profile_phases: a copy of the state ({need / 1e9:.2f} GB "
                f"on the card) does not fit the {free / 1e9:.2f} GB free "
                f"there; attribute a smaller configuration")
    return dataclasses.replace(
        state, **{f: _clone(getattr(state, f)) for f in _STATE_PLANES})


def _leaves(x) -> list:
    """The tensors of a tensor / dict / list / tuple tree (no closure: a
    recursive nested function would hold its tensors in a reference cycle
    until the garbage collector runs, and these are full planes)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _tensors(state) -> list:
    return [t for f in _STATE_PLANES for t in _leaves(getattr(state, f))]


def profile_phases(loss_fn, cfg, state, batches, lr=None, *, iters: int = 10,
                   warmup: int = 2, peak_gbps: float | None = None,
                   profiler_trace_dir: str | None = None,
                   phases=None) -> list[dict]:
    """Attribution rows ``phase:step``, ``phase:local`` and
    ``phase:meta_mix`` for one meta iteration of ``cfg`` on ``state``.

    Times, with ``steady_timeit``, (a) the whole meta step, (b) the local
    phase alone (K local steps on every learner) and (c) the meta mix alone
    (``topology.mix`` on the state's planes), each on one clone of
    ``state`` (``clone_state``): the passed state is left as it was.

    ``profiler_trace_dir``: also export a ``torch.profiler`` trace of one
    more whole step into this directory. ``phases``: the (whole step,
    local phase, meta mix) callables of ``(state, batches, lr)``,
    ``(state, batches, lr)`` and ``(state,)`` in place of the one-process
    ones (one rank of a mesh: ``sharding/placed.py::placed_phases``).
    """
    from repro_torch.core.meta import _local_phase, make_meta_step
    from repro_torch.topology import host_buffers, make_topology

    lr = np.float32(cfg.learner_lr if lr is None else lr)
    topology = make_topology(cfg, None)
    step_fn = make_meta_step(loss_fn, cfg, topology=topology)
    work = clone_state(state)
    device = next((t.device for t in _tensors(work)), torch.device("cpu"))

    def whole_step(s, b, lr_):
        return step_fn(s, b, lr=lr_)

    def local_phase(s, b, lr_):
        steps = topology.local_steps(s.topo, s.step)
        return _local_phase(loss_fn, s.learners, s.local_momentum, b, cfg,
                            float(lr_), spec=s.spec, steps=steps)

    def meta_mix(s):
        with torch.no_grad():
            return topology.mix(s.learners, s.global_params, s.momentum,
                                s.comm_residual, s.topo, step=s.step)

    if phases is not None:
        whole_step, local_phase, meta_mix = phases
    targets = [
        ("phase:step", whole_step, (work, batches, lr)),
        ("phase:local", local_phase, (work, batches, lr)),
        ("phase:meta_mix", meta_mix, (work,)),
    ]
    extra = {"algorithm": cfg.algorithm, "topology": cfg.topology.kind}
    rows = [
        profile_fn(op, fn, *args, iters=iters, warmup=warmup,
                   peak_gbps=peak_gbps, device=device, extra=extra,
                   host=host_buffers(work.topo))
        for op, fn, args in targets
    ]
    if profiler_trace_dir:
        from repro_torch.obs.trace import Tracer

        t = Tracer(enabled=True)
        t.profiler_start(profiler_trace_dir)
        try:
            whole_step(work, batches, lr)
        finally:
            t.profiler_stop()
    del work
    return rows
