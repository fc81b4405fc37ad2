"""Phase tracing: config-gated span timers with Chrome-trace export (the JAX
package's ``obs/trace.py``).

The training loop has four host-visible phases worth timing: step
dispatch (``obs.dispatch``: the local phase and the meta mix enqueued),
the host flush (``obs.host_flush``: the one read per ``log_every``
window), checkpoint I/O (``obs.checkpoint_io``) and sink writes
(``obs.sink_append``). ``Tracer.span`` wraps each in a wall-clock timer
(``time.perf_counter``) and a ``torch.profiler.record_function`` of the
same name, so the spans also land in a torch trace beside the meta step's
own ``obs.local_phase`` and ``obs.meta_mix`` ranges (``core/meta.py``).
``profiler_start``/``profiler_stop`` run ``torch.profiler.profile`` over
the CPU and, where there is one, the card, and export its Chrome trace
(JAX drives ``jax.profiler`` into ``jax_trace/``; the Trainer points the
port's at ``torch_trace/``).

A disabled tracer costs one predicate per span. ``export_chrome_trace``
writes the collected spans in the Chrome ``chrome://tracing`` / Perfetto
JSON event format.

Tracing is exception-safe: ``session`` is the context manager the Trainer
wraps its whole run in. On any exit (normal, KeyboardInterrupt, a crash
mid-span) it closes still-open spans (recorded as ``interrupted``), stops
a live profile and writes the Chrome-trace file, so a crashed run still
yields a loadable trace of everything up to the failure.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

import torch


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: list[tuple[str, float, float]] = []  # (name, t0, dur) s
        self._t0 = time.perf_counter()
        self._profiler = None  # the live torch.profiler.profile
        self._profiler_dir = None
        # spans entered but not yet exited, as (name, t0), for
        # close_open_spans to finalize after an abnormal unwind
        self._open: list[tuple[str, float]] = []
        self.interrupted: list[str] = []  # names closed abnormally

    @contextmanager
    def span(self, name: str):
        """Time a phase; no-op (one branch) when disabled."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        entry = (name, t0)
        self._open.append(entry)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if entry in self._open:
                self._open.remove(entry)
            self.events.append((name, t0 - self._t0, time.perf_counter() - t0))

    def close_open_spans(self) -> list[str]:
        """Finalize every still-open span at the current wall clock.

        Normally a no-op (span()'s finally pops the stack); after an
        abnormal unwind it records each orphan as a complete event ending
        now and returns the closed names (also kept in ``interrupted``).
        """
        now = time.perf_counter()
        closed = []
        while self._open:
            name, t0 = self._open.pop()
            self.events.append((name, t0 - self._t0, now - t0))
            closed.append(name)
        self.interrupted.extend(closed)
        return closed

    @contextmanager
    def session(self, export_path: str | None = None,
                profiler_dir: str | None = None):
        """Exception-safe tracing scope around a whole run.

        Enter: optionally starts a torch profile into ``profiler_dir``.
        Exit, always, crash included: closes open spans, stops the
        profiler (exporting its trace) and, given ``export_path``, writes
        the Chrome trace of the spans. Export errors are swallowed on the
        exception path only: telemetry must not mask the real traceback.
        """
        if profiler_dir:
            self.profiler_start(profiler_dir)
        ok = False
        try:
            yield self
            ok = True
        finally:
            self.close_open_spans()
            try:
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
        https://ui.perfetto.dev). Timestamps in microseconds since the
        tracer was created."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events = [
            {
                "name": name,
                "ph": "X",  # complete event: begin + duration
                "ts": t0 * 1e6,
                "dur": dur * 1e6,
                "pid": 0,
                "tid": 0,
                "cat": "repro.obs",
            }
            for name, t0, dur in self.events
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
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
        profile was running)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        os.makedirs(self._profiler_dir, exist_ok=True)
        path = os.path.join(self._profiler_dir, "trace.json")
        prof.export_chrome_trace(path)
        return path
