"""repro_torch.obs — training telemetry, phase tracing and structured run
sinks (the JAX package's ``repro.obs``, DESIGN.md §11), under the same
names and the same record schema (``tools/telemetry_schema.json``).

* ``MetricsBuffer`` (metrics.py): a fixed-size ring of per-step metric
  rows on the state's device, written in place each meta step and brought
  to the host with one read per ``log_every`` window.
* ``Sink`` (sink.py): where flushed records and the run manifest go:
  JSONL (canonical, append-on-resume), CSV, or in memory.
* ``Tracer`` (trace.py): config-gated phase spans with Chrome-trace export
  and ``torch.profiler`` hooks.
* ``run_manifest`` (manifest.py): the run-identity record (config,
  PackSpec hash, topology and reducer settings, torch and device info).
* ``profile`` (profile.py): the steady-state timing harness and the
  phase attribution rows; ``baseline`` (baseline.py): the bench
  trajectory stores and baseline comparison; ``health`` (health.py):
  declarative run-health rules over flushed windows, with fatal rules
  halting the Trainer on a resumable checkpoint (``HealthHalt``).
"""
from repro_torch.obs.baseline import (
    append_trajectory,
    compare,
    latest_rows,
    load_trajectory,
    trajectory_path,
)
from repro_torch.obs.health import (
    DEFAULT_RULES,
    HealthHalt,
    HealthMonitor,
    HealthRule,
    make_monitor,
)
from repro_torch.obs.manifest import (
    SCHEMA_VERSION,
    device_env,
    packspec_hash,
    run_manifest,
)
from repro_torch.obs.metrics import MetricsBuffer, metric_keys, write_row
from repro_torch.obs.profile import (
    Timing,
    attribution_row,
    measured_peak_gbps,
    profile_fn,
    profile_phases,
    steady_timeit,
)
from repro_torch.obs.sink import (
    SINKS,
    CsvSink,
    JsonlSink,
    MemorySink,
    Sink,
    make_sink,
)
from repro_torch.obs.trace import Tracer

__all__ = [
    "DEFAULT_RULES",
    "SCHEMA_VERSION",
    "SINKS",
    "CsvSink",
    "HealthHalt",
    "HealthMonitor",
    "HealthRule",
    "JsonlSink",
    "MemorySink",
    "MetricsBuffer",
    "Sink",
    "Timing",
    "Tracer",
    "append_trajectory",
    "attribution_row",
    "compare",
    "device_env",
    "latest_rows",
    "load_trajectory",
    "make_monitor",
    "make_sink",
    "measured_peak_gbps",
    "metric_keys",
    "packspec_hash",
    "profile_fn",
    "profile_phases",
    "run_manifest",
    "steady_timeit",
    "trajectory_path",
    "write_row",
]
