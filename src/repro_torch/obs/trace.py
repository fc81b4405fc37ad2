"""Phase tracing: config-gated spans on the profiler's clock, device time of
the local step, and Chrome-trace export (the JAX package's
``obs/trace.py``, extended).

Spans. The Trainer (``core/trainer.py``) times the data draw
(``obs.data``), step dispatch (``obs.dispatch``: the local phase and the
meta mix enqueued; its args hold the step's deltas of the caching
allocator's ``num_alloc_retries``, ``num_device_alloc`` and
``num_device_free`` on a card), the host flush (``obs.host_flush``: the
one read per ``log_every`` window), checkpoint I/O
(``obs.checkpoint_io``), sink writes (``obs.sink_append``) and every
collection of Python's collector (``obs.gc``: a ``gc.callbacks`` hook the
session installs, its generation and objects collected in the args).
Inside the meta step (``core/meta.py``, which the one-process and the
placed step share) ``phase`` opens ``obs.local_phase`` and
``obs.meta_mix`` (host spans only) and, in every local step,
``obs.forward`` (the gradient zeroed, the loss), ``obs.backward``
(``loss.backward()``, the remat recompute included, and the ranks'
gradient mean) and ``obs.update`` (the gradient's norm and the SGD
apply), which are also timed on the card. Each span records its parent (the
innermost span open when it began) and the Trainer's meta step.

Clock. Every span is stamped on the clock of ``torch.profiler``'s events,
epoch nanoseconds (``time.time_ns``), as ``time.perf_counter_ns`` plus one
offset taken when the Tracer is made, so spans stay monotonic.
``events`` holds ``(name, t0_s, dur_s)`` triples, ``t0_s`` in epoch
seconds; ``export_chrome_trace`` writes ``ts`` on the base of the torch
trace this Tracer exported (its ``baseTimeNanoseconds``), so the two
files lay over each other.

Device time. A ``phase`` whose tensors lie on a card also records a pair
of timing events (``torch.cuda.Event``, from a pool) on the current
stream. ``resolve`` turns the pending pairs into ``<span>.device``
triples once the stream has passed them: the Trainer calls it after each
host flush, whose read has synchronised the stream, and the session at
its end. Their ``t0_s`` is placed on the host clock by an anchor event
recorded after them on the drained stream. No pair is taken on the CPU
or on the meta device (``roofline/cost.py``), and the Trainer pauses the
hook while it costs or attributes the step outside the loop.

Profiler ranges. ``Tracer.span`` opens a ``torch.profiler.record_function``
of its name, so the spans land in a torch trace beside the meta step's
own ranges. The step's phases and ``obs.gc`` open an operator-scope range
instead (``op_range``): it labels the host's events alike but is not
copied onto the card's timeline, where a reader of device operations
would count it as one. ``profiler_start``/``profiler_stop`` run
``torch.profiler.profile`` over the CPU and, where there is one, the
card, and export its Chrome trace (the Trainer points it at
``torch_trace/``).

Cost. With no enabled Tracer in session, ``phase`` is one branch: no
range, no event, no allocation; a disabled Tracer's ``span`` is one
predicate.

Tracing is exception-safe: ``session`` is the context manager the Trainer
wraps its whole run in. On any exit (normal, KeyboardInterrupt, a crash
mid-span) it closes still-open spans (recorded as ``interrupted``),
removes its collector hook, resolves the pending pairs, stops a live
profile and writes the Chrome-trace file, so a crashed run still yields a
loadable trace of everything up to the failure.
"""
from __future__ import annotations

import gc
import json
import os
import re
import time
from contextlib import contextmanager, nullcontext

import torch

# the caching allocator's counters a dispatch span carries (for operators:
# a retry or a device allocation tells an allocator stall from a pause)
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free")
DEVICE_SUFFIX = ".device"

_NULL = nullcontext()
_ACTIVE: "Tracer | None" = None  # the enabled Tracer in session, if any
_BASE_RE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def phase(name: str, at=None, *, profiler_range: str | None = "op"):
    """The meta step's span hook. With no enabled Tracer in session: a
    shared no-op context, one branch. Otherwise that Tracer's
    ``span(name, at, profiler_range=...)``: ``at`` a tensor (or a tree of
    them) on the step's device, which decides the device pair."""
    tracer = _ACTIVE
    if tracer is None:
        return _NULL
    return tracer.span(name, at, profiler_range=profiler_range)


def op_range(name: str):
    """A profiler range of ``name`` at operator scope (see the module
    doc)."""
    return torch._C._profiler._RecordFunctionFast(name)


def _cuda_device(at):
    """The CUDA device ``at`` (a tensor or a tree of them) lies on, or
    None."""
    if at is None:
        return None
    if not isinstance(at, torch.Tensor):
        from repro_torch.utils.tree import tree_leaves

        at = next((x for x in tree_leaves(at)
                   if isinstance(x, torch.Tensor)), None)
        if at is None:
            return None
    dev = at.device
    return dev if dev.type == "cuda" else None


def _alloc_counts(device):
    if device is None or torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return [int(stats.get(k, 0)) for k in ALLOC_COUNTERS]


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        # (name, t0, dur) in seconds, t0 on the profiler's epoch clock
        self.events: list[tuple[str, float, float]] = []
        self.args: list[dict] = []  # one per event: parent, step, ...
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.step = None  # the meta step the Trainer is on
        self._base_ns = 0  # the exported torch trace's time base
        self._profiler = None  # the live torch.profiler.profile
        self._profiler_dir = None
        # spans entered but not yet exited, as (name, t0_ns, args), for
        # close_open_spans to finalize after an abnormal unwind
        self._open: list[tuple[str, int, dict]] = []
        self.interrupted: list[str] = []  # names closed abnormally
        self._pending: list[tuple] = []  # device pairs not yet resolved
        self._pool: dict[torch.device, list] = {}  # free timing events
        self._gc = None  # (t0_ns, range) of the collection under way

    def now_ns(self) -> int:
        """The profiler's clock: epoch nanoseconds, monotonic."""
        return time.perf_counter_ns() + self._offset_ns

    def _record(self, name: str, t0_ns: int, dur_ns: int, args: dict):
        self.events.append((name, t0_ns * 1e-9, dur_ns * 1e-9))
        self.args.append(args)

    @contextmanager
    def span(self, name: str, at=None, *, profiler_range: str | None = "user",
             alloc=None):
        """Time a phase; a no-op (one branch) when disabled. ``at``: a
        tensor (or tree) whose card, if any, also times
        the span on the device. ``profiler_range``: ``"user"`` a
        ``record_function``, ``"op"`` an ``op_range``, None no range (the
        caller opens its own). ``alloc``: a device whose allocator
        counters' deltas over the span go in its args."""
        if not self.enabled:
            yield
            return
        args = {"step": self.step}
        if self._open:
            args["parent"] = self._open[-1][0]
        dev = _cuda_device(at)
        mem0 = _alloc_counts(alloc)
        rng = (_NULL if profiler_range is None
               else op_range(name) if profiler_range == "op"
               else torch.profiler.record_function(name))
        t0 = self.now_ns()
        entry = (name, t0, args)
        self._open.append(entry)
        pair = None
        try:
            with rng:
                if dev is not None:
                    stream = torch.cuda.current_stream(dev)
                    pair = (self._event(dev), self._event(dev))
                    pair[0].record(stream)
                try:
                    yield
                finally:
                    if pair is not None:
                        pair[1].record(stream)
        finally:
            if entry in self._open:
                self._open.remove(entry)
            self._record(name, t0, self.now_ns() - t0, args)
            if pair is not None:
                self._pending.append((name, dev, pair, t0, args))
            if mem0 is not None:
                mem1 = _alloc_counts(alloc)
                args.update({k: b - a for k, a, b in
                             zip(ALLOC_COUNTERS, mem0, mem1)})

    def _event(self, dev):
        pool = self._pool.setdefault(dev, [])
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _anchor_on(self, dev) -> tuple:
        """An event recorded on ``dev``'s current stream, once the stream
        has run it, with the host time it ran at."""
        ev = self._event(dev)
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
        return ev, self.now_ns()

    def resolve(self) -> None:
        """Turn every pending device pair into a ``<span>.device`` event
        once the stream has passed it (the last end event synchronised
        first). A pair's start is placed on the host clock by an anchor
        event recorded after it, on the drained stream."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        pending[-1][2][1].synchronize()
        anchors = {dev: self._anchor_on(dev) for dev in
                   dict.fromkeys(p[1] for p in pending)}
        for name, dev, (start, end), _t0, args in pending:
            end.synchronize()  # a no-op but on another stream
            dur_ns = round(start.elapsed_time(end) * 1e6)
            ev, at_ns = anchors[dev]
            t0 = at_ns - round(start.elapsed_time(ev) * 1e6)
            self._record(name + DEVICE_SUFFIX, t0, dur_ns, dict(args))
            self._pool[dev] += (start, end)
        for dev, (ev, _ns) in anchors.items():
            self._pool[dev].append(ev)

    def _gc_hook(self, stage: str, info: dict):
        """``gc.callbacks``: one ``obs.gc`` span a collection. Touches no
        tensor and not the span stack of the code it interrupts."""
        if stage == "start":
            rng = op_range("obs.gc")
            rng.__enter__()
            self._gc = (self.now_ns(), rng)
            return
        if self._gc is None:
            return
        (t0, rng), self._gc = self._gc, None
        rng.__exit__(None, None, None)
        args = {"step": self.step, "generation": info.get("generation"),
                "collected": info.get("collected"),
                "uncollectable": info.get("uncollectable")}
        if self._open:
            args["parent"] = self._open[-1][0]
        self._record("obs.gc", t0, self.now_ns() - t0, args)

    @contextmanager
    def hooks_paused(self):
        """No step phase is recorded inside (the Trainer's one-off cost
        analysis and attribution, which run the step outside the loop)."""
        global _ACTIVE
        saved = _ACTIVE
        if saved is self:
            _ACTIVE = None
        try:
            yield
        finally:
            if saved is self:
                _ACTIVE = saved

    def close_open_spans(self) -> list[str]:
        """Finalize every still-open span at the current clock.

        Normally a no-op (span()'s finally pops the stack); after an
        abnormal unwind it records each orphan as a complete event ending
        now and returns the closed names (also kept in ``interrupted``).
        """
        now = self.now_ns()
        closed = []
        while self._open:
            name, t0, args = self._open.pop()
            self._record(name, t0, now - t0, args)
            closed.append(name)
        self.interrupted.extend(closed)
        return closed

    @contextmanager
    def session(self, export_path: str | None = None,
                profiler_dir: str | None = None):
        """Exception-safe tracing scope around a whole run.

        Enter: optionally starts a torch profile into ``profiler_dir``;
        an enabled Tracer becomes the one ``phase`` reports to and hooks
        the collector. Exit, always, crash included: closes open spans,
        unhooks the collector, resolves the device pairs, stops the
        profiler (exporting its trace) and, given ``export_path``, writes
        the Chrome trace of the spans. Export errors are swallowed on the
        exception path only: telemetry must not mask the real traceback.
        """
        global _ACTIVE
        if profiler_dir:
            self.profiler_start(profiler_dir)
        saved = _ACTIVE
        if self.enabled:
            _ACTIVE = self
            gc.callbacks.append(self._gc_hook)
        ok = False
        try:
            yield self
            ok = True
        finally:
            if self.enabled:
                _ACTIVE = saved
                if self._gc_hook in gc.callbacks:
                    gc.callbacks.remove(self._gc_hook)
                self._gc = None
            self.close_open_spans()
            try:
                self.resolve()
                self.profiler_stop()
                if self.enabled and export_path:
                    self.export_chrome_trace(export_path)
            except Exception:
                if ok:
                    raise

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """{phase: {count, total_s, mean_s}} over all recorded spans."""
        out: dict[str, dict] = {}
        for name, _t, dur in self.events:
            s = out.setdefault(name, {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += dur
        for s in out.values():
            s["mean_s"] = s["total_s"] / s["count"]
        return out

    def export_chrome_trace(self, path: str) -> str:
        """Write spans as Chrome-trace JSON (load in chrome://tracing or
        https://ui.perfetto.dev): ``ts`` in microseconds after
        ``baseTimeNanoseconds`` (the base of the torch trace this Tracer
        exported, else 0: epoch microseconds), as
        ``torch.profiler`` writes its own. Host spans on thread 1, device
        spans on thread 2, the parent, step and counters in ``args``."""
        base = self._base_ns
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        pid = os.getpid()
        events = [
            {
                "name": name,
                "ph": "X",  # complete event: begin + duration
                "ts": (t0 * 1e9 - base) / 1e3,
                "dur": dur * 1e6,
                "pid": pid,
                "tid": 2 if name.endswith(DEVICE_SUFFIX) else 1,
                "cat": "repro.obs",
                "args": {k: v for k, v in args.items() if v is not None},
            }
            for (name, t0, dur), args in zip(self.events, self.args)
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base}, f)
        return path

    # ------------------------------------------------------------------
    def profiler_start(self, trace_dir: str) -> None:
        """Start a ``torch.profiler`` trace of the CPU and, when a card is
        visible, its kernels; ``profiler_stop`` writes it into
        ``trace_dir``. Unlike JAX's best-effort start, a profiler that
        cannot start raises: a run asked to profile does not go on
        without it."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._profiler, self._profiler_dir = prof, trace_dir

    def profiler_stop(self) -> str | None:
        """Stop a live profile and export its Chrome trace to
        ``<trace_dir>/trace.json``; returns that path (None when no
        profile was running). Its time base becomes this Tracer's."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        os.makedirs(self._profiler_dir, exist_ok=True)
        path = os.path.join(self._profiler_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            m = _BASE_RE.search(f.read(1 << 16))
        if m:
            self._base_ns = int(m.group(1))
        return path
