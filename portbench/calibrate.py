"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 portbench/calibrate.py --workload qwen3-1.7b.mavg-k4 \\
        --seeds 11,12,13,14,15,16 --faults 3

For each seed it reads the program's first meta steps as a run does
(``benchlib/program.py``; no window) and the reference's, and prints the
compared numbers as one JSON line. For the first ``--faults`` seeds it
also reads the control (the reference with bfloat16 learner planes in the
program's place) and the program with half of each batch left out, each
against the same reference. A meta step that returns its state unchanged
reads 1 on ``first_gap`` and ``change_gap`` by construction and needs no
run. The benchmark's runs do not run this.
"""
import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]

import torch  # noqa: E402

from benchlib import compare, program, ref_mavg, spec  # noqa: E402


def program_readings(plan, seed: int, variant: str, device) -> dict:
    cfg, traffic = plan.config["model"], plan.traffic
    trainer = program.build(cfg, traffic, seed, device, variant=variant)
    prog = {"losses": []}
    for step in range(int(plan.workload["ref_steps"])):
        program.run_steps(trainer, 1)
        prog["losses"].append(float(trainer.history[-1]["loss"]))
        if step == 0:
            prog["first"] = program.first_reading(trainer)
    prog["change"] = program.change_reading(trainer, cfg, seed)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return prog


def worst_leaves(side: dict, ref: dict) -> dict:
    """The leaf that sets each norm gap, for the record."""
    out = {}
    for key in ("first", "change"):
        floor = statistics.median(ref[key].values())
        out[key] = max(ref[key], key=lambda n: abs(side[key][n] - ref[key][n])
                       / max(ref[key][n], floor, 1e-30))
    return out


def emit(seed, variant, side, ref, seconds):
    line = {"seed": seed, "variant": variant, **compare.numbers(side, ref),
            "worst": worst_leaves(side, ref), "losses": side["losses"],
            "ref_losses": ref["losses"], "seconds": round(seconds, 1)}
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    plan = spec.plan(args.workload)
    cfg, traffic = plan.config["model"], plan.traffic
    steps = int(plan.workload["ref_steps"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = program_readings(plan, seed, "program", "cuda")
        t1 = time.perf_counter()
        ref = ref_mavg.readings(cfg, traffic, seed, steps, "cuda")
        t2 = time.perf_counter()
        emit(seed, "program", prog, ref, t1 - t0)
        print(f"reference {t2 - t1:.1f} s", file=sys.stderr)
        if i < args.faults:
            t0 = time.perf_counter()
            control = ref_mavg.readings(cfg, traffic, seed, steps, "cuda",
                                        learner_dtype=torch.bfloat16)
            emit(seed, "control", control, ref, time.perf_counter() - t0)
            t0 = time.perf_counter()
            half = program_readings(plan, seed, "half_batch", "cuda")
            emit(seed, "half_batch", half, ref, time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
