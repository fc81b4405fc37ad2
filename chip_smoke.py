#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version at the main path's
   shapes, the full Qwen3-1.7B packed plane (13,441,992 x 128) with L=4:
   bitwise equality over the whole plane (in windows of rows, so the plain
   version's temporaries fit), then CUDA-event times of the kernel, the
   plain version and, where one exists, a single PyTorch library call,
   beside the least time the card could take (bytes over 3.35 TB/s or
   flops over 67 TFLOP/s, whichever is larger);
4. the main path: the port's Trainer on the full-width, full-depth
   Qwen3-1.7B, M-AVG with L=4, K=4, B=8, S=64, 3 meta steps from random
   weights on uniform random tokens, with the kernel launch counters
   zeroed just before and read just after; then one more meta step under
   torch.profiler for the kernel time by class and name and the device's
   idle share;
5. the card against the CPU on ``qwen3-1.7b.reduced()`` in float32, per-leaf
   (``packed=False``, the block-momentum path) and packed, 2 meta steps.

The second-to-last line is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
L = 4  # learners on the main path
MU, ETA, LR = 0.7, 1.0, 0.01
WINDOW_ROWS = 1 << 19  # rows per window of the bitwise comparison
SOURCE = "src/repro_torch/kernels/csrc/meta_kernels.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> float:
    """Largest |got - want| (0.0 exactly when bitwise equal); raises on
    any bit difference."""
    err = float((got.to(torch.float32) - want.to(torch.float32))
                .abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel differs from plain version: max "
                             f"|diff| {err}")
    return err


def windows(rows: int):
    for r0 in range(0, rows, WINDOW_ROWS):
        yield slice(r0, min(r0 + WINDOW_ROWS, rows))


def free(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_fused(torch, fm, rows, plane) -> dict:
    n = rows * 128
    w, v, a = plane(), plane(), plane()
    w_out, v_out = torch.empty_like(w), torch.empty_like(v)
    err = 0.0
    # bf16 learners first, then the main path's f32 learners
    for ld in (torch.bfloat16, torch.float32):
        learners = torch.empty((L, rows, 128), dtype=ld, device=w.device)
        for nesterov in (True, False):
            fm.fused_momentum_broadcast_cuda(
                w, v, a, MU, ETA, L, ld, nesterov=nesterov, w_out=w_out,
                v_out=v_out, learners_out=learners)
            torch.cuda.synchronize()
            for sl in windows(rows):
                pw, pv, pl = fm.fused_momentum_broadcast_plain(
                    w[sl], v[sl], a[sl], MU, ETA, L, ld, nesterov=nesterov)
                err = max(err, max_err(torch, w_out[sl], pw),
                          max_err(torch, v_out[sl], pv),
                          max_err(torch, learners[:, sl], pl))
            print(f"  fused_momentum_broadcast ldtype={ld} "
                  f"nesterov={nesterov}: bitwise equal over {rows} rows")
        if ld == torch.bfloat16:
            del learners
            free(torch)
    # the main path's case: f32 learners, heavy-ball momentum
    launch = lambda: fm.fused_momentum_broadcast_cuda(  # noqa: E731
        w, v, a, MU, ETA, L, torch.float32, w_out=w_out, v_out=v_out,
        learners_out=learners)
    ms = cuda_ms(torch, launch)
    # in place, as the meta step runs it: same result as out of place
    fm.fused_momentum_broadcast_cuda(w, v, a, MU, ETA, L, torch.float32,
                                     w_out=w, v_out=v, learners_out=learners)
    err = max(err, max_err(torch, w, w_out), max_err(torch, v, v_out))
    print("  fused_momentum_broadcast in place: equal to out of place")
    del w_out, v_out
    free(torch)
    plain_ms = cuda_ms(torch, lambda: fm.fused_momentum_broadcast_plain(
        w, v, a, MU, ETA, L, torch.float32, w_out=w, v_out=v,
        learners_out=learners))
    del w, v, a, learners
    free(torch)
    b_ms, b_by = bound((5 + L) * n * 4, 5 * n)
    return dict(name="fused_momentum_broadcast",
                replaces="src/repro/kernels/fused_meta.py:57",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_block_momentum(torch, bm, rows, plane) -> dict:
    n = rows * 128
    w, v, a = plane(), plane(), plane()
    w_out, v_out = torch.empty_like(w), torch.empty_like(v)
    err = 0.0
    for nesterov in (True, False):
        bm.block_momentum_cuda(w, v, a, MU, ETA, nesterov=nesterov,
                               w_out=w_out, v_out=v_out)
        torch.cuda.synchronize()
        for sl in windows(rows):
            pw, pv = bm.block_momentum_plain(w[sl], v[sl], a[sl], MU, ETA,
                                             nesterov=nesterov)
            err = max(err, max_err(torch, w_out[sl], pw),
                      max_err(torch, v_out[sl], pv))
        print(f"  block_momentum nesterov={nesterov}: bitwise equal over "
              f"{rows} rows")
    ms = cuda_ms(torch, lambda: bm.block_momentum_cuda(
        w, v, a, MU, ETA, w_out=w_out, v_out=v_out))
    plain_ms = cuda_ms(torch, lambda: bm.block_momentum_plain(
        w, v, a, MU, ETA, w_out=w_out, v_out=v_out))
    del w, v, a, w_out, v_out
    free(torch)
    b_ms, b_by = bound(5 * n * 4, 5 * n)
    return dict(name="block_momentum",
                replaces="src/repro/kernels/block_momentum.py:47",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_sgd_apply(torch, sgd, rows, plane) -> dict:
    n = rows * 128
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        w, g = plane().to(dt), plane().to(dt)
        out = torch.empty_like(w)
        sgd.sgd_apply_cuda(w, g, LR, out=out)
        torch.cuda.synchronize()
        for sl in windows(rows):
            err = max(err, max_err(torch, out[sl],
                                   sgd.sgd_apply_plain(w[sl], g[sl], LR)))
        print(f"  sgd_apply dtype={dt}: bitwise equal over {rows} rows")
        if dt == torch.bfloat16:
            del w, g, out
            free(torch)
    # the main path's case: f32 learner plane
    ms = cuda_ms(torch, lambda: sgd.sgd_apply_cuda(w, g, LR, out=out))
    plain_ms = cuda_ms(torch, lambda: sgd.sgd_apply_plain(w, g, LR, out=out))
    sgd.sgd_apply_cuda(w, g, LR, out=w)  # in place, as the meta step runs it
    err = max(err, max_err(torch, w, out))
    print("  sgd_apply in place: equal to out of place")
    # the yardstick, never called by the port (it may contract to an FMA)
    library_ms = cuda_ms(torch, lambda: torch.add(w, g, alpha=-LR, out=out))
    del w, g, out
    free(torch)
    b_ms, b_by = bound(3 * n * 4, 2 * n)
    return dict(name="sgd_apply",
                replaces="src/repro/kernels/local_sgd.py:24",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer
# ---------------------------------------------------------------------------


def full_width_training(torch, ops) -> dict:
    from repro_torch.configs.base import MAvgConfig, TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine

    cfg = get_config("qwen3-1.7b")
    k, batch, seq, steps = 4, 8, 64, 3
    tcfg = TrainConfig(
        model=cfg, mavg=MAvgConfig(algorithm="mavg", num_learners=L,
                                   k_steps=k),
        batch_per_learner=batch, seq_len=seq, meta_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L, k, batch, seq),
        lr_schedule=warmup_cosine(LR, 5, steps), device="cuda",
    )
    spec = trainer.state.spec
    print(f"  state: {spec.rows} rows x 128, {L} learners, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run(log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  launches: {counts}")
    assert counts == {"fused_momentum_broadcast": steps,
                      "block_momentum": 0,
                      "sgd_apply": steps * k * L}, counts
    losses = [h["loss"] for h in history]
    assert all(math.isfinite(x) for x in losses), losses
    ln_v = math.log(cfg.vocab_size)
    assert abs(losses[0] - ln_v) <= 1.5, (losses[0], ln_v)
    state = trainer.state
    for j in range(L):  # every learner was reset to the new meta params
        assert torch.equal(state.learners[j], state.global_params), j
    tail = spec.offsets[-1] + spec.sizes[-1]
    assert torch.all(state.global_params.view(-1)[tail:] == 0)
    peak = torch.cuda.max_memory_allocated()
    print(f"  step-0 loss {losses[0]:.4f} (ln V = {ln_v:.4f}); losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB); {steps} meta steps in {seconds:.2f} s "
          f"({steps / seconds:.3f} meta steps/s; last step alone "
          f"{history[-1]['meta_steps_per_sec']:.3f} meta steps/s, "
          f"{history[-1]['samples_per_sec']:.1f} samples/s)")
    profile_meta_step(torch, trainer, 1e3 / history[-1]["meta_steps_per_sec"])
    del trainer, state
    free(torch)
    return counts


# kernel-name fragments -> the class a kernel's device time is booked to
KERNEL_CLASSES = (
    ("port kernels", ("momentum_kernel", "sgd_kernel")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copy/cast", ("copy", "Cat")),
)


def profile_meta_step(torch, trainer, step_ms: float) -> None:
    """One more meta step under torch.profiler (after the counters were
    read): kernel time by class and by name, the device span of each
    phase, and the device's idle share. The profiler slows the host, so
    the idle share divides the profiled kernel time by ``step_ms``, the
    wall time of the last unprofiled meta step. Reports "not measured" if
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(1, log=None)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    # the obs.* ranges also appear as device spans; they are not kernels
    kernels = sorted((e for e in on_device if not e.key.startswith("obs.")),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print(f"  profiled meta step: wall {wall_ms:.1f} ms; device time "
              f"not measured (the profiler saw no device activity)")
        return
    print(f"  profiled meta step: kernels busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} launches (profiled wall "
          f"{wall_ms:.1f} ms); unprofiled step {step_ms:.1f} ms -> device "
          f"idle share {1 - busy_ms / step_ms:.3f}")
    for e in on_device:
        if e.key.startswith("obs."):
            print(f"    {e.key} device span {e.device_time_total / 1e3:.1f} ms")
    booked = {name: [0.0, 0] for name, _ in KERNEL_CLASSES}
    booked["other elementwise/reduce"] = [0.0, 0]
    for e in kernels:
        cls = next((name for name, frags in KERNEL_CLASSES
                    if any(f in e.key for f in frags)),
                   "other elementwise/reduce")
        booked[cls][0] += e.self_device_time_total / 1e3
        booked[cls][1] += e.count
    for cls, (ms, count) in booked.items():
        print(f"    class {cls}: {ms:.1f} ms in {count} launches "
              f"({ms / busy_ms:.3f} of kernel time)")
    for e in kernels[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def card_vs_cpu(torch, ops) -> int:
    from repro_torch.configs.base import MAvgConfig, get_config
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves, tree_map

    # full float32 matmuls on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (2, 2, 2, 16), generator=gen)
        for _ in range(2))]
    loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731
    block_launches = 0
    for packed in (False, True):
        mcfg = MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                          learner_lr=0.1, momentum=0.7, packed=packed)
        finals = {}
        for device in ("cpu", "cuda"):
            state = init_state(tree_map(lambda x: x.to(device), params),
                               mcfg)
            step = make_meta_step(loss_fn, mcfg)
            ops.reset_launch_counts()
            for b in batches:
                state, _ = step(state, tree_map(lambda x: x.to(device), b))
            counts = ops.launch_counts()
            finals[device] = [x.cpu() for x in
                              tree_leaves(state.global_params)]
        n_leaves = len(tree_leaves(params))
        want = ({"fused_momentum_broadcast": 2, "block_momentum": 0,
                 "sgd_apply": 2 * 2 * 2} if packed else
                {"fused_momentum_broadcast": 0,
                 "block_momentum": 2 * n_leaves,
                 "sgd_apply": 2 * 2 * 2 * n_leaves})
        assert counts == want, (packed, counts, want)
        worst = 0.0
        for c, g in zip(finals["cpu"], finals["cuda"]):
            torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-6)
            worst = max(worst, float((g - c).abs().max()))
        print(f"  packed={packed}: card == CPU to rtol=1e-5, atol=1e-6 "
              f"(max |diff| {worst:.3e}); launches {counts}")
        if not packed:
            block_launches = counts["block_momentum"]
    return block_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import block_momentum as bm
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import fused_meta as fm
    from repro_torch.kernels import local_sgd as sgd
    from repro_torch.models import api
    from repro_torch.pack import make_pack_spec

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    t0 = time.perf_counter()
    lib = build.library()
    print(f"  {lib.path.name} ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_s:.2f} s)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    print("phase 3: kernels vs plain versions at the main path's shapes")
    rows = make_pack_spec(api.init_params(
        None, get_config("qwen3-1.7b"), "meta")).rows
    gen = torch.Generator(device="cuda").manual_seed(0)
    plane = lambda: torch.randn(rows, 128, generator=gen,  # noqa: E731
                                device="cuda")
    records = [check_fused(torch, fm, rows, plane),
               check_sgd_apply(torch, sgd, rows, plane),
               check_block_momentum(torch, bm, rows, plane)]
    for r in records:
        print(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
              f"ms by {r['bound_by']}), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']}")

    print("phase 4: full-width Qwen3-1.7B M-AVG trainer")
    main_counts = full_width_training(torch, ops)

    print("phase 5: card vs CPU, qwen3-1.7b.reduced() float32")
    block_launches = card_vs_cpu(torch, ops)

    launches = dict(main_counts, block_momentum=block_launches)
    for r in records:
        r.update(route="cuda", source=SOURCE, launches=launches[r["name"]])
        assert r["launches"] > 0, r
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
