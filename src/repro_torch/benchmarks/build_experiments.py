"""Regenerate the data tables inside ``EXPERIMENTS.md`` (its Dry-run and
Roofline sections) from the dry run's JSON rows (the JAX package's
``benchmarks/build_experiments.py``). Hand-written sections stay as they
are; only the blocks between the AUTOGEN markers are rewritten.

The target file is ``EXPERIMENTS.md`` at the repository root, as JAX's;
this repository has none, so the script fails there, as the reference
does (``FileNotFoundError``). ``main(path)`` takes another target.
"""
from __future__ import annotations

import os
import re

from repro_torch.benchmarks.roofline_table import load_results

HERE = os.path.dirname(os.path.abspath(__file__))
EXP = os.path.normpath(os.path.join(HERE, "..", "..", "..",
                                    "EXPERIMENTS.md"))

LEVER = {
    # bottleneck -> generic lever sentence fragments, specialised by family
    ("memory", "ssm"): "chunkwise-parallel recurrence (done: 173x) and fused scan cells",
    ("memory", "hybrid"): "fused mamba-scan kernel; bf16 scan states",
    ("memory", "dense"): "Pallas flash attention (S^2 softmax chain is the bulk of HBM traffic)",
    ("memory", "vlm"): "Pallas flash attention; fewer remat passes",
    ("memory", "audio"): "Pallas flash attention (bidirectional)",
    ("memory", "moe"): "bf16 token exchange at MoE boundary; flash attention",
    ("collective", "dense"): "FSDP weight-gather instead of TP activation all-reduce (done for qwen3: 1.9x); DP learners where the model fits a chip",
    ("collective", "moe"): "shard_map all-to-all token dispatch instead of gather/scatter resharding",
    ("collective", "vlm"): "FSDP weight-gather; overlap meta all-reduce with local steps",
    ("collective", "ssm"): "decode state is tiny - batch the meta sync",
    ("compute", "dense"): "already near roofline; reduce remat recompute",
}


def lever(row):
    rf = row["roofline"]
    frag = LEVER.get((rf["bottleneck"], _family(row["arch"])))
    if frag is None:
        frag = "reduce %s term via sharding/fusion" % rf["bottleneck"]
    return frag


def _family(arch):
    from repro_torch.configs import get_config

    return get_config(arch).family


def _f(x):
    return f"{x:.3g}"


def dryrun_table(results=None):
    lines = [
        "| arch | shape | mesh | per-dev args | per-dev temp | collectives (by type, bytes/dev/step) |",
        "|---|---|---|---|---|---|",
    ]
    rows = (load_results(mesh="single", results=results)
            + load_results(mesh="multi", results=results))
    for r in rows:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — |"
                f" SKIP: {r['reason']} |"
            )
            continue
        mem = r.get("memory", {})
        args = mem.get("argument_size_in_bytes", 0) / 2**30
        temp = mem.get("temp_size_in_bytes", 0) / 2**30
        coll = ", ".join(
            f"{k}={v / 1e9:.1f}GB" for k, v in r["collectives"]["by_type"].items()
        ) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {args:.2f}GiB |"
            f" {temp:.2f}GiB | {coll} |"
        )
    return "\n".join(lines)


def roofline_table(results=None):
    lines = [
        "| arch | shape | mesh | HLO FLOPs/dev | HBM B/dev | coll B/dev |"
        " compute s | memory s | collective s | bound | MODEL/HLO | lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = (load_results(mesh="single", results=results)
            + load_results(mesh="multi", results=results))
    for r in rows:
        if r.get("skipped"):
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {rf['hlo_flops']:.2e} | {rf['hlo_bytes']:.2e} |"
            f" {rf['collective_bytes']:.2e} |"
            f" {_f(rf['compute_s'])} | {_f(rf['memory_s'])} |"
            f" {_f(rf['collective_s'])} | **{rf['bottleneck']}** |"
            f" {rf['useful_ratio']:.2f} | {lever(r)} |"
        )
    return "\n".join(lines)


def replace_block(text, marker, content):
    pattern = re.compile(
        rf"(<!-- AUTOGEN:{marker} -->).*?(<!-- /AUTOGEN:{marker} -->)",
        re.DOTALL,
    )
    return pattern.sub(rf"\1\n{content}\n\2", text)


def main(path=None, results=None):
    path = path or EXP
    with open(path) as f:
        text = f.read()
    text = replace_block(text, "dryrun", dryrun_table(results))
    text = replace_block(text, "roofline", roofline_table(results))
    with open(path, "w") as f:
        f.write(text)
    print(f"{os.path.basename(path)} tables regenerated")


if __name__ == "__main__":
    main()
