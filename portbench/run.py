"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell on the card.

    python3 portbench/run.py --workload qwen3-1.7b.mavg-k4 --seed 7 \\
        --seconds 30 --trace 0

A run builds the port's ``Trainer`` from the seed (``benchlib/program.py``),
drives its first meta steps as set-up (they compile, warm up and give the
readings the comparison needs), times one ``trainer.run(n)`` of whole meta
steps lasting about ``--seconds``, and then checks the first steps
against the plain reference (``benchlib/ref_mavg.py``) once the program's
state is freed. ``--trace 1`` times the same window with the Trainer's
spans on, then profiles one more meta step, and reports the per-layer
metrics in place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's meta steps, those with a loss
that is not finite), ``metrics``, ``device``, with ``--trace 1`` the
``breakdown``, and last ``compared``: each compared number with its
limit. The same numbers are the last lines of standard error. Without a
card, or with fewer than the cell asks for, it exits 2 and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))
# every cache a library may keep lies at a fixed path in the checkout; the
# port's own kernel build is ``build/repro_torch/`` there
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

from benchlib import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(plan, seed: int, seconds: float, trace: bool, device,
             variant: str = "program", t_start: float = T_START) -> dict:
    """One run of ``plan`` on ``device``: the result object, without the
    checks of the process (card, modules) that ``main`` makes."""
    import torch

    from benchlib import compare, program, ref_mavg, yardstick
    from benchlib.profile import profile_step

    cfg, traffic, work = plan.config["model"], plan.traffic, plan.workload
    ref_steps = int(work["ref_steps"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trainer = program.build(cfg, traffic, seed, device, trace=trace,
                            variant=variant)
    # set-up: the first meta steps, which the reference follows
    prog = {"losses": []}
    step_s = None
    for step in range(ref_steps):
        _sync(device)
        t0 = time.perf_counter()
        program.run_steps(trainer, 1)
        _sync(device)
        step_s = time.perf_counter() - t0
        prog["losses"].append(float(trainer.history[-1]["loss"]))
        if step == 0:
            prog["first"] = program.first_reading(trainer)
    prog["change"] = program.change_reading(trainer, cfg, seed)
    n = max(1, round(seconds / step_s))
    print(f"set-up: {ref_steps} meta steps, the last {step_s:.3f} s; "
          f"window of {n}", file=sys.stderr)
    spans_before = len(trainer.tracer.events)
    # every window starts from the same collector state: no garbage of the
    # set-up left for the program's own collections to find in the window
    gc.collect()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    # the window
    w0 = time.perf_counter()
    program.run_steps(trainer, n)
    _sync(device)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_losses = [float(r["loss"]) for r in trainer.history[-n:]]
    L, K, B, S = (traffic["learners"], traffic["k_steps"], traffic["batch"],
                  traffic["seq_len"])
    ctx = SimpleNamespace(
        plan=plan, config=cfg, traffic=traffic, steps=n, window_s=window_s,
        setup_s=setup_s, peak_bytes=peak, tokens=n * L * K * B * S,
        flops_per_token=yardstick.model_flops_per_token(cfg, S),
        peaks=yardstick.H100_SXM, plane_bytes=program.plane_bytes(trainer),
        spans=trainer.tracer.events[spans_before:] if trace else None,
        trace=None)
    if trace and cuda:
        ctx.trace = profile_step(lambda: program.run_steps(trainer, 1))
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the check, once the program's state is freed
    r0 = time.perf_counter()
    ref = ref_mavg.readings(cfg, traffic, seed, ref_steps, device)
    print(f"window {window_s:.3f} s, peak {peak} B; reference "
          f"{time.perf_counter() - r0:.1f} s", file=sys.stderr)
    values = compare.numbers(prog, ref)
    limits = work["limits"]
    metrics = {}
    for m in plan.metrics(trace):
        value = spec.metric_reader(m["name"], plan.bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": compare.verdict(values, limits),
        "attempted": n,
        "failed": sum(not math.isfinite(x) for x in window_losses),
        "metrics": metrics,
        "device": {"memory_peak_bytes": peak},
    }
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.wall_s
        result["breakdown"] = ctx.trace.breakdown()
        print(f"profiled step: {len(ctx.trace.ops)} device operations, "
              f"{ctx.trace.launches_matched} matched to their launch",
              file=sys.stderr)
    result["compared"] = {k: {"value": values[k], "limit": limits[k]}
                          for k in compare.NUMBERS}
    result["lines"] = compare.report_lines(values, limits)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    plan = spec.plan(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < plan.chips:
        print(f"{args.workload} needs {plan.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda")
    # once the window has closed: nothing of the JAX side in this process
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX side loaded: {found}", file=sys.stderr)
        return 3
    lines = result.pop("lines")
    compared = result.pop("compared")
    limit_w = power_limit_w()
    result["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": plan.chips,
        **result["device"],
        "power_limit_w": limit_w,
    }
    result["compared"] = compared
    print(f"device {result['device']['kind']}, power limit {limit_w} W",
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
