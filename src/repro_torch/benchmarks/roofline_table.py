"""Aggregate the dry run's JSON rows (``build/dryrun/``, written by
``repro_torch.launch.dryrun``) into the roofline tables (the JAX
package's ``benchmarks/roofline_table.py``, the same columns and
formats). Every number in them is modeled on the meta device at the H100
data sheet's rates, none measured.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun_lib import RESULTS_DIR

RESULTS = RESULTS_DIR


def load_results(mesh=None, mode="faithful", algorithm="mavg",
                 results=None):
    rows = []
    for path in sorted(glob.glob(os.path.join(results or RESULTS,
                                              "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        if r.get("mode", "faithful") != mode:
            continue
        if r.get("algorithm", "mavg") != algorithm:
            continue
        rows.append(r)
    return rows


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def markdown_table(rows, *, include_memory=True) -> str:
    header = (
        "| arch | shape | mesh | per-dev args | temp | HLO FLOPs/dev |"
        " HBM bytes/dev | coll bytes/dev | compute s | memory s |"
        " collective s | bound | useful | comm | wire bytes | wire s |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
                f" SKIP: {r['reason']} |||||||||||||"
            )
            continue
        rf = r["roofline"]
        mem = r.get("memory", {})
        wire_b = rf.get("wire_bytes")
        wire_s = rf.get("wire_s")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {_fmt_bytes(mem.get('argument_size_in_bytes'))} |"
            f" {_fmt_bytes(mem.get('temp_size_in_bytes'))} |"
            f" {rf['hlo_flops']:.2e} | {rf['hlo_bytes']:.2e} |"
            f" {rf['collective_bytes']:.2e} |"
            f" {rf['compute_s']:.3g} | {rf['memory_s']:.3g} |"
            f" {rf['collective_s']:.3g} | **{rf['bottleneck']}** |"
            f" {rf['useful_ratio']:.2f} |"
            f" {rf.get('comm_scheme', '-')} |"
            f" {_fmt_bytes(wire_b) if wire_b else '-'} |"
            f" {f'{wire_s:.3g}' if wire_s else '-'} |"
        )
    return header + "\n".join(lines) + "\n"


def summarize(rows):
    out = []
    for r in rows:
        if r.get("skipped"):
            continue
        rf = r["roofline"]
        dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        frac = rf["compute_s"] / dom if dom else 0
        out.append(
            dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                 bottleneck=rf["bottleneck"], dominant_s=dom,
                 roofline_fraction=frac,
                 collective_ratio=rf["collective_s"] / max(dom, 1e-12))
        )
    return out


def main(results=None):
    """Print both meshes' tables (a table, no result rows, as JAX's)."""
    for mesh in ("single", "multi"):
        rows = load_results(mesh=mesh, results=results)
        print(f"\n===== {mesh} mesh ({len(rows)} combos, modeled) =====")
        print(markdown_table(rows))


if __name__ == "__main__":
    main()
