"""One meta step under ``torch.profiler``, reduced to what the per-layer
metrics read: every device operation with its time and the host range
that launched it, the union of device busy time, and the breakdown.

A device operation is a kernel, a copy or a fill on the card (an event
off the host that is not a range's device-side copy). Its launch is the
host runtime call with the same correlation id; the range that
launched it is the innermost of ``RANGES`` open on the host at that
moment: the Trainer's ``obs.dispatch`` and ``obs.host_flush`` spans and
the meta step's ``obs.local_phase`` and ``obs.meta_mix`` ranges (names
the program records; ``local_phase`` and ``meta_mix`` lie inside
``dispatch``). Imports only torch.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

RANGES = ("obs.dispatch", "obs.host_flush", "obs.local_phase",
          "obs.meta_mix")
# host calls into CUDA (`cuda*`, `cu*`): a launch shares its
# correlation id with the device operation it starts
RUNTIME_CALLS = ("cuda", "cuLaunch", "cuMem")
NAME_CHARS = 100


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    range: str | None


@dataclass
class Trace:
    ops: list = field(default_factory=list)
    busy_s: float = 0.0
    wall_s: float = 0.0
    launches_matched: int = 0
    gaps: list = field(default_factory=list)  # (seconds, label)

    def ops_in(self, range_name: str) -> list:
        return [op for op in self.ops if op.range == range_name]

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_ns * 1e-9
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:top]
        return {"device_ops": [[n, s] for n, s in device_ops],
                "idle_gaps": [[label, s] for s, label in gaps]}


def _innermost(intervals, starts, t):
    """The name of the innermost (latest-starting) interval holding t, of
    ``intervals`` sorted by start (``starts`` their starts)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, -1, -1):
        s, e, name = intervals[j]
        if e >= t:
            best = name
            break
    return best


def profile_step(step_fn) -> Trace:
    """Run ``step_fn()`` (one meta step) under the profiler, the card
    synchronised before and after, and reduce its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0_ns = time.time_ns()
        w0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        t1_ns = time.time_ns()
    return reduce_events(prof.profiler.kineto_results.events(), wall,
                         t0_ns, t1_ns)


def reduce_events(events, wall_s: float, t0_ns: int, t1_ns: int) -> Trace:
    ranges, cpu_ops, launches, device = [], [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            if name not in RANGES:  # the ranges' device-side copies
                device.append(ev)
        elif name in RANGES:
            ranges.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith(RUNTIME_CALLS):
            launches[ev.correlation_id()] = ev.start_ns()
        else:
            cpu_ops.append((ev.start_ns(), ev.end_ns(), name))
    ranges.sort()
    cpu_ops.sort()
    r_starts = [r[0] for r in ranges]
    c_starts = [c[0] for c in cpu_ops]
    trace = Trace(wall_s=wall_s)
    for ev in device:
        at = launches.get(ev.correlation_id())
        if at is not None:
            trace.launches_matched += 1
        trace.ops.append(DeviceOp(
            name=ev.name()[:NAME_CHARS], start_ns=ev.start_ns(),
            dur_ns=ev.duration_ns(),
            range=None if at is None else _innermost(ranges, r_starts, at)))
    spans = sorted((op.start_ns, op.start_ns + op.dur_ns) for op in trace.ops)
    merged: list[list[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    trace.busy_s = sum(e - s for s, e in merged) * 1e-9
    edges = [t0_ns] + [x for m in merged for x in m] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    for s, e in longest:
        mid = (s + e) // 2
        host = _innermost(ranges, r_starts, mid) or "no range"
        op = _innermost(cpu_ops, c_starts, mid) or "no op"
        trace.gaps.append(((e - s) * 1e-9, f"{host} {op}"[:NAME_CHARS]))
    return trace
