"""Finds a cell's files by name and plans a run.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. A cell ``<name>`` is ``workloads/<name>.json``; it names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``). A metric ``<name>`` is read by
``metrics/<name>.py``. Adding a cell, a configuration, a traffic mix or a
metric is adding its file and its entry in ``BENCHMARK.json``: nothing
here names one.

This module imports only the standard library.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """A cell, file or entry that does not exist or breaks a rule."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"{path} does not exist") from e


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Plan:
    """What one run of a cell does: its files, parsed, and the metrics it
    reports with ``--trace 0`` (end to end) and ``--trace 1`` (per
    layer)."""

    cell: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan(cell: str, bench: dict | None = None,
         bench_dir: Path = BENCH_DIR) -> Plan:
    """The plan of cell ``cell``: its workload, configuration and traffic
    files and the metrics ``BENCHMARK.json`` gives it."""
    check_name(cell, "workload")
    if bench is None:
        bench = load_benchmark(bench_dir.parent)
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise SpecError(f"no workload {cell!r} in BENCHMARK.json")
    workload = load_json(bench_dir / "workloads" / f"{cell}.json")
    entry = entries[cell]
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SpecError(f"{cell}: {key} {workload[key]!r} in its file, "
                            f"{entry[key]!r} in BENCHMARK.json")
    config = load_json(bench_dir / "configs"
                       / f"{check_name(workload['config'], 'config')}.json")
    traffic = load_json(bench_dir / "traffic"
                        / f"{check_name(workload['traffic'], 'traffic')}.json")
    return Plan(
        cell=cell, workload=workload, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell)],
        bench_dir=bench_dir,
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``. A metric split
    by cells (``<base>.<part>``: the same quantity under another name,
    moved or bounded apart) without a file of its own is read by
    ``metrics/<base>.py``."""
    path = bench_dir / "metrics" / f"{check_name(name, 'metric')}.py"
    if not path.exists() and "." in name:
        path = path.with_name(name.rsplit(".", 1)[0] + ".py")
    if not path.exists():
        raise SpecError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
