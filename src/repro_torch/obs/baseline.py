"""Bench trajectory stores + baseline comparison (the regression sentinel;
the JAX package's ``obs/baseline.py``).

Every ``benchmarks/run.py`` suite appends its JSONL-envelope rows to a
persistent per-suite trajectory file, ``BENCH_<suite>.json`` — one JSON
object per line, each a *trajectory point*: ``{"kind": "trajectory",
"suite", "manifest", "rows"}``. The manifest carries the device/config
identity so a trajectory mixing CPU-smoke and card points stays
interpretable; the rows are the suite's own result records, unmodified.
Append-only by design: the file IS the cross-run history the perf
claims of PRs 4–5 get measured against.

``compare`` turns the latest point against a committed *baseline spec*
(``benchmarks/expected/<suite>.json``) into pass/fail. A spec lists
metrics, each selecting rows by field equality and bounding one field:

    {"suite": "pack", "metrics": [
      {"name": "peak ratio",               # human label
       "select": {"row_kind": "hbm_peak_state"},
       "field": "ratio",
       "max": 0.6},                        # absolute bound, or:
      {"name": "meta step time",
       "select": {"row_kind": "pack_timing_xla_cpu"},
       "field": "meta_step_us_packed",
       "baseline": 1234.5, "tol_rel": 0.10, "direction": "min"}]}

``direction: "min"`` means lower-is-better (times, bytes, loss): the
metric fails when value > baseline * (1 + tol_rel). ``"max"`` means
higher-is-better (accuracy, reduction factors): fails when value <
baseline * (1 - tol_rel). A metric whose selector matches no row fails
too — a silently vanished measurement is the stealthiest regression.

Module level stays stdlib, as in JAX (``tools/bench_compare.py`` reads
these stores without the package on the path); ``run_manifest`` is pulled
lazily only when a caller asks for one.
"""
from __future__ import annotations

import json
import os
import time


def trajectory_path(bench_dir: str, suite: str) -> str:
    """``<bench_dir>/BENCH_<suite>.json`` — the per-suite trajectory."""
    return os.path.join(bench_dir, f"BENCH_{suite}.json")


def _jsonify(x):
    if hasattr(x, "item"):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


def append_trajectory(path: str, suite: str, rows, manifest=None,
                      created_unix=None) -> dict:
    """Append one trajectory point; returns the point written.

    ``manifest=None`` builds a fresh ``run_manifest`` (lazy import, needs
    torch; pass an explicit dict from stdlib-only callers).
    """
    if manifest is None:
        from repro_torch.obs.manifest import run_manifest

        manifest = run_manifest(suite=suite)
    point = {
        "kind": "trajectory",
        "suite": suite,
        "created_unix": (
            time.time() if created_unix is None else created_unix
        ),
        "manifest": manifest,
        "rows": [dict(r) for r in rows],
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(point, sort_keys=True, default=_jsonify) + "\n")
    return point


def load_trajectory(path: str) -> list[dict]:
    """All trajectory points of a store, oldest first. Tolerates a torn
    final line (a killed bench run) by dropping it — same policy as the
    JSONL run-sink repair."""
    points = []
    if not os.path.exists(path):
        return points
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue  # torn tail / corruption: skip, don't die
            if isinstance(obj, dict):
                points.append(obj)
    return points


def latest_rows(path: str, suite=None) -> list[dict]:
    """Rows of the newest trajectory point (optionally filtered to one
    suite); [] when the store is empty."""
    points = load_trajectory(path)
    if suite is not None:
        points = [p for p in points if p.get("suite") == suite]
    return list(points[-1].get("rows", ())) if points else []


# ---------------------------------------------------------------------------
# baseline comparison
# ---------------------------------------------------------------------------


def _select(rows, selector) -> list[dict]:
    out = []
    for r in rows:
        if all(r.get(k) == v for k, v in (selector or {}).items()):
            out.append(r)
    return out


def _bound(metric) -> tuple[float | None, float | None]:
    """(lo, hi) acceptance interval of one metric spec."""
    lo = hi = None
    if "max" in metric:
        hi = float(metric["max"])
    if "min" in metric:
        lo = float(metric["min"])
    if "baseline" in metric:
        base = float(metric["baseline"])
        tol = float(metric.get("tol_rel", 0.1))
        if metric.get("direction", "min") == "min":  # lower is better
            hi = base * (1.0 + tol) if hi is None else min(hi, base * (1 + tol))
        else:  # higher is better
            lo = base * (1.0 - tol) if lo is None else max(lo, base * (1 - tol))
    return lo, hi


def compare(rows, spec) -> list[str]:
    """Check rows against a baseline spec; returns violation strings
    (empty = pass). Every metric must match at least one row, and every
    matched value must land inside the metric's acceptance interval."""
    violations = []
    for metric in spec.get("metrics", ()):
        name = metric.get("name") or metric.get("field", "?")
        fld = metric["field"]
        matched = _select(rows, metric.get("select"))
        values = [r[fld] for r in matched if fld in r]
        if not values:
            violations.append(
                f"{name}: no row matches select={metric.get('select')} "
                f"with field {fld!r} — measurement vanished"
            )
            continue
        lo, hi = _bound(metric)
        for v in values:
            try:
                fv = float(v)
            except (TypeError, ValueError):
                violations.append(f"{name}: non-numeric value {v!r}")
                continue
            if fv != fv:  # NaN
                violations.append(f"{name}: value is NaN")
            elif hi is not None and fv > hi:
                violations.append(
                    f"{name}: {fv:.6g} exceeds bound {hi:.6g}"
                    + (f" (baseline {metric['baseline']:.6g} "
                       f"+{100 * float(metric.get('tol_rel', 0.1)):.0f}%)"
                       if "baseline" in metric else "")
                )
            elif lo is not None and fv < lo:
                violations.append(
                    f"{name}: {fv:.6g} below bound {lo:.6g}"
                    + (f" (baseline {metric['baseline']:.6g} "
                       f"-{100 * float(metric.get('tol_rel', 0.1)):.0f}%)"
                       if "baseline" in metric else "")
                )
    return violations


def seed_spec(rows, spec) -> dict:
    """Fill the ``baseline`` value of every relative metric from measured
    rows (worst matched value per direction, so the seeded baseline is
    the loosest honest one). Absolute-bound metrics pass through."""
    out = dict(spec)
    metrics = []
    for metric in spec.get("metrics", ()):
        m = dict(metric)
        if "tol_rel" in m or "baseline" in m or "direction" in m:
            matched = _select(rows, m.get("select"))
            values = []
            for r in matched:
                try:
                    values.append(float(r[m["field"]]))
                except (KeyError, TypeError, ValueError):
                    pass
            if values:
                m["baseline"] = (
                    max(values) if m.get("direction", "min") == "min"
                    else min(values)
                )
        metrics.append(m)
    out["metrics"] = metrics
    return out
