"""Structured run sinks: one record schema for every trainer run and bench
(the JAX package's ``obs/sink.py``).

A run log is a stream of flat JSON-able records with a ``kind`` tag:

    {"kind": "manifest", ...}   run environment + config (manifest.py)
    {"kind": "step", ...}       one per-meta-step telemetry record
    {"kind": "row", ...}        one benchmark result row (benchmarks/)

Sinks are dumb and synchronous by design — all batching happens upstream
in the device-side ``MetricsBuffer`` (metrics.py), so a sink append is a
handful of host floats, never a device sync. ``JsonlSink`` is the
canonical on-disk format (append-only, resume-friendly: a resumed run
reopens the same file in append mode and writes a fresh manifest line —
``tools/check_telemetry.py`` validates the stream); ``CsvSink`` is for
spreadsheet ergonomics; ``MemorySink`` for tests and in-process readers
(the K_g/mu autotuner consumes it).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Optional

from repro_torch.utils.retry import retry_io


class Sink:
    """Protocol: open_run(manifest) once per (re)open, append(record) per
    step/row, flush() at sync boundaries, close() when done."""

    def open_run(self, manifest: dict) -> None:
        raise NotImplementedError

    def append(self, record: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """In-memory record list — tests, notebooks, and online consumers."""

    def __init__(self):
        self.manifests: list[dict] = []
        self.records: list[dict] = []

    def open_run(self, manifest: dict) -> None:
        self.manifests.append(dict(manifest))

    def append(self, record: dict) -> None:
        self.records.append(dict(record))


class JsonlSink(Sink):
    """Append-only JSONL file; one JSON object per line.

    ``resume=True`` appends to an existing file (the same run log across
    restarts — meta_step stays monotone across the manifest boundary);
    ``resume=False`` truncates. The manifest is written as the first line
    of every (re)open so a reader can always recover the config that
    produced the records that follow it.

    A killed run can leave a torn final line (a partial ``write`` that
    never reached its newline). Appending after one would glue the
    resumed run's manifest onto the fragment and corrupt the whole
    stream, so resume first repairs the tail: if the last line is not a
    complete JSON object, the file is truncated back to the last good
    newline (``repaired_bytes`` records how much was dropped — at most
    one record, which had no durable effect anyway since the run died
    before checkpointing past it).
    """

    def __init__(self, path: str, *, resume: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.repaired_bytes = 0
        if resume and os.path.exists(path):
            self.repaired_bytes = _repair_torn_tail(path)
        self._f = open(path, "a" if resume else "w")

    def open_run(self, manifest: dict) -> None:
        self._write({"kind": "manifest", **manifest})

    def append(self, record: dict) -> None:
        rec = record if record.get("kind") else {"kind": "step", **record}
        self._write(rec)

    def _write(self, obj: dict) -> None:
        # transient OSErrors (NFS hiccup, disk-pressure EAGAIN) get the
        # shared bounded retry/backoff treatment — the same helper the
        # checkpoint writer's atomic rename uses (repro_torch.utils.retry)
        line = json.dumps(obj, sort_keys=True, default=_jsonify) + "\n"
        retry_io(lambda: self._f.write(line))

    def flush(self) -> None:
        retry_io(self._f.flush)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class CsvSink(Sink):
    """CSV of the step records; the manifest goes to a JSON sidecar
    (``<path>.manifest.json``) since it is nested. The header is fixed by
    the FIRST record's keys; later records must agree (one schema per
    run is the whole point)."""

    def __init__(self, path: str, *, resume: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        existing = resume and os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "a" if resume else "w", newline="")
        self._writer: Optional[csv.DictWriter] = None
        if existing:
            with open(path) as f:
                header = f.readline().strip()
            if header:
                self._writer = csv.DictWriter(
                    self._f, fieldnames=header.split(",")
                )

    def open_run(self, manifest: dict) -> None:
        with open(self.path + ".manifest.json", "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True, default=_jsonify)

    def append(self, record: dict) -> None:
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=sorted(record))
            self._writer.writeheader()
        self._writer.writerow(record)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _repair_torn_tail(path: str) -> int:
    """Truncate a torn final line of a JSONL file; returns bytes dropped.

    A line is torn when it lacks its trailing newline or does not parse
    as a JSON object (a write cut mid-record). Scans backward from the
    end to the last newline-terminated line that parses; everything after
    it is truncated. An empty file (or one with no complete line at all)
    is truncated to zero — the resumed open rewrites the manifest anyway.
    """
    size = os.path.getsize(path)
    if size == 0:
        return 0
    with open(path, "rb") as f:
        data = f.read()
    good = len(data)
    # an unterminated tail fragment is torn by definition
    if not data.endswith(b"\n"):
        good = data.rfind(b"\n") + 1  # 0 when no newline at all
    # then walk back over newline-terminated lines that still don't parse
    # (json.dumps output never contains a raw newline, so any unparseable
    # complete line is corruption, not payload)
    while good > 0:
        prev = data.rfind(b"\n", 0, good - 1)
        line = data[prev + 1: good - 1]
        try:
            if isinstance(json.loads(line.decode("utf-8")), dict):
                break
        except (ValueError, UnicodeDecodeError):
            pass
        good = prev + 1
    dropped = size - good
    if dropped:
        with open(path, "rb+") as f:
            f.truncate(good)
    return dropped


def _jsonify(x):
    """numpy scalars and 0-d torch tensors -> Python scalars at the
    serialization boundary; larger arrays -> lists."""
    if getattr(x, "ndim", None) == 0 and hasattr(x, "item"):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


SINKS = ("none", "jsonl", "csv", "memory")


def make_sink(kind: str, run_dir: Optional[str] = None, *,
              resume: bool = False) -> Optional[Sink]:
    """Build the sink named by ``ObsConfig.sink`` (None for 'none').

    File sinks write ``<run_dir>/run.jsonl`` / ``run.csv`` — one
    canonical filename per run directory so resume finds the same log.
    """
    if kind == "none":
        return None
    if kind == "memory":
        return MemorySink()
    if run_dir is None:
        raise ValueError(f"sink {kind!r} needs a run_dir (ObsConfig.run_dir)")
    if kind == "jsonl":
        return JsonlSink(os.path.join(run_dir, "run.jsonl"), resume=resume)
    if kind == "csv":
        return CsvSink(os.path.join(run_dir, "run.csv"), resume=resume)
    raise ValueError(f"unknown sink {kind!r}; choose from {SINKS}")
