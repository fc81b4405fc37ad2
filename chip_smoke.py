#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together);
3. each kernel against its plain PyTorch version at the main paths'
   shapes, the full Qwen3-1.7B packed plane (13,441,992 x 128): the meta
   kernels with L=4, the wire-compression kernels (quantize, dequantize at
   qmax 127 and 7; pack_update with L=2, with and without the residual,
   in place and out of place) at the chunk height b=8 the plane gets, and
   once at b=64 on its first 13,441,984 rows. Bitwise equality over the
   whole plane (in windows of rows, so the plain version's temporaries
   fit), then CUDA-event times of the kernel, the plain version and,
   where one exists, a single PyTorch library call, beside the least time
   the card could take (bytes over 3.35 TB/s or flops over 67 TFLOP/s,
   whichever is larger);
4. the dense main path: the port's Trainer on the full-width, full-depth
   Qwen3-1.7B, M-AVG with L=4, K=4, B=8, S=64, 3 meta steps from random
   weights on uniform random tokens, with the kernel launch counters
   zeroed just before and read just after; then one more meta step under
   torch.profiler for the kernel time by class and name and the device's
   idle share;
5. the compressed main path: the same trainer with int8 compression and
   error feedback (``CommConfig(scheme="int8")``), L=2 (the residual adds
   L planes, and L=4 would not fit), K=4, B=8, S=64, 3 meta steps, counted
   and profiled the same way;
6. the card against the CPU on ``qwen3-1.7b.reduced()`` in float32, 2 meta
   steps: dense per-leaf (``packed=False``, the block-momentum path) and
   packed, then int8+EF packed, int8+EF per-leaf and int8_topk+EF packed,
   with the same dither on both devices (drawn on the CPU).

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
L = 4  # learners on the dense main path
L_COMM = 2  # learners on the compressed main path
MU, ETA, LR = 0.7, 1.0, 0.01
WINDOW_ROWS = 1 << 19  # rows per window of the bitwise comparison
BLOCK = 8  # the scale-chunk height choose_block gives the full plane
SOURCE = "src/repro_torch/kernels/csrc/meta_kernels.cu"
COMM_SOURCE = "src/repro_torch/kernels/csrc/comm_kernels.cu"
# card vs CPU after compressed meta steps: values beyond rtol 1e-5 /
# atol 1e-6 are rounding decisions that flipped because the two devices'
# gradients differ in the last bits; at most this share of them, each
# within FLIP_QUANTA scale quanta (plus, for top-k, one kept value that
# crossed the threshold)
FLIP_SHARE = 5e-3
FLIP_QUANTA = 2.0


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


def window_values(torch, tag: int, k: int, nrows: int, uniform=False,
                  scale=1.0):
    """The values of window ``k`` (``nrows`` rows) of the plane ``tag``:
    made from a generator seeded by (tag, k), so any window can be made
    again on its own after its plane was overwritten in place."""
    gen = torch.Generator(device="cuda").manual_seed(tag * 4096 + k)
    make = torch.rand if uniform else torch.randn
    x = make(nrows, 128, generator=gen, device="cuda")
    return x if scale == 1.0 else x.mul_(scale)


def filled(torch, tag: int, rows: int, out=None, **kw):
    """A (rows, 128) f32 plane of ``window_values``."""
    out = torch.empty(rows, 128, device="cuda") if out is None else out
    for k, sl in enumerate(windows(rows)):
        out[sl] = window_values(torch, tag, k, sl.stop - sl.start, **kw)
    return out


def chunks(sl: slice, block: int = BLOCK) -> slice:
    return slice(sl.start // block, sl.stop // block)


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


def check_quantize(torch, qk, rows) -> list[dict]:
    """quantize and dequantize at qmax 127 and 7, b=8 over the full plane
    and b=64 over its first 64-divisible rows; a NaN chunk; times of the
    int8 (qmax 127, b=8) case."""
    n = rows * 128
    x = filled(torch, 1, rows, scale=0.03)
    u = filled(torch, 2, rows, uniform=True)
    rows64 = rows - rows % 64
    err = 0.0
    for block, nrows in ((BLOCK, rows), (64, rows64)):
        for qmax in (127, 7):
            q, sc = qk.quantize_cuda(x[:nrows], u[:nrows], qmax, block)
            dq = qk.dequantize_cuda(q, sc)
            torch.cuda.synchronize()
            for sl in windows(nrows):
                cs = chunks(sl, block)
                pq, ps = qk.quantize_plain(x[sl], u[sl], qmax, block)
                err = max(err, max_err(torch, q[sl], pq),
                          max_err(torch, sc[cs], ps),
                          max_err(torch, dq[sl],
                                  qk.dequantize_plain(q[sl], sc[cs])))
            print(f"  quantize/dequantize qmax={qmax} b={block}: bitwise "
                  f"equal over {nrows} rows")
            del q, sc, dq
    # a NaN makes its chunk's scale NaN and leaves the others alone
    xs, us = x[:64].clone(), u[:64]
    xs[3, 5] = float("nan")
    q, sc = qk.quantize_cuda(xs, us, 127, BLOCK)
    pq, ps = qk.quantize_plain(xs, us, 127, BLOCK)
    assert torch.isnan(sc[0, 0]) and torch.isnan(ps[0, 0])
    assert int(q[3, 5]) == 0 and torch.equal(sc[1:], ps[1:])
    assert torch.equal(q[8:], pq[8:])
    print("  quantize: a NaN value gives its chunk a NaN scale and q = 0; "
          "other chunks bitwise equal")
    q, sc = qk.quantize_cuda(x, u, 127, BLOCK)
    ms = cuda_ms(torch, lambda: qk.quantize_cuda(x, u, 127, BLOCK))
    plain_ms = cuda_ms(torch, lambda: qk.quantize_plain(x, u, 127, BLOCK))
    nchunks = rows // BLOCK
    b_ms, b_by = bound(9 * n + 4 * nchunks, 7 * n)
    records = [dict(name="quantize",
                    replaces="src/repro/kernels/quantize.py:57",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)]
    del x, u
    free(torch)
    ms = cuda_ms(torch, lambda: qk.dequantize_cuda(q, sc))
    plain_ms = cuda_ms(torch, lambda: qk.dequantize_plain(q, sc))
    # the yardstick, never called by the port
    library_ms = cuda_ms(torch, lambda: torch.mul(q.view(nchunks, -1), sc))
    b_ms, b_by = bound(5 * n + 4 * nchunks, n)
    records.append(dict(name="dequantize",
                        replaces="src/repro/kernels/quantize.py:82",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=library_ms))
    del q, sc
    free(torch)
    return records


def check_pack_update(torch, pu, rows) -> dict:
    """pack_update over the (2, rows, 128) f32 learner stack: out of place
    on learner 0 without and with the residual (and at b=64), then in
    place on both learners as the meta step runs it; times of that
    case. 48 GB of inputs, so the out-of-place checks take one learner
    and the plain version runs in windows."""
    n = rows * 128
    w, e, u = (torch.empty(L_COMM, rows, 128, device="cuda")
               for _ in range(3))
    for j in range(L_COMM):
        filled(torch, 10 + j, rows, out=w[j], scale=0.05)
        filled(torch, 20 + j, rows, out=e[j], scale=1e-3)
        filled(torch, 30 + j, rows, out=u[j], uniform=True)
    g = filled(torch, 3, rows, scale=0.05)
    rows64 = rows - rows % 64
    err = 0.0
    for block, nrows, ee in ((BLOCK, rows, None), (64, rows64, e),
                             (BLOCK, rows, e)):
        c, er, sc = pu.pack_update_cuda(
            w[:1, :nrows], g[:nrows], None if ee is None else ee[:1, :nrows],
            u[:1, :nrows], 127, block)
        torch.cuda.synchronize()
        for sl in windows(nrows):
            pc, pe, ps = pu.pack_update_plain(
                w[:1, sl], g[sl], None if ee is None else ee[:1, sl],
                u[:1, sl], 127, block)
            err = max(err, max_err(torch, c[:, sl], pc),
                      max_err(torch, er[:, sl], pe),
                      max_err(torch, sc[:, chunks(sl, block)], ps))
        print(f"  pack_update learner 0, residual={ee is not None}, "
              f"b={block}: bitwise equal over {nrows} rows")
        if block == 64 or ee is None:
            del c, er, sc
            free(torch)
    # in place on both learners, as the meta step runs it: c over u, err
    # over e; learner 0 against the out-of-place result, learner 1
    # against the plain version on its inputs made again
    _, _, sc2 = pu.pack_update_cuda(w, g, e, u, 127, BLOCK, c_out=u,
                                    err_out=e)
    for sl in windows(rows):
        err = max(err, max_err(torch, u[:1, sl], c[:, sl]),
                  max_err(torch, e[:1, sl], er[:, sl]))
    err = max(err, max_err(torch, sc2[:1], sc))
    del c, er, sc
    free(torch)
    for k, sl in enumerate(windows(rows)):
        nr = sl.stop - sl.start
        e1 = window_values(torch, 21, k, nr, scale=1e-3)
        u1 = window_values(torch, 31, k, nr, uniform=True)
        pc, pe, ps = pu.pack_update_plain(w[1:, sl], g[sl], e1[None],
                                          u1[None], 127, BLOCK)
        err = max(err, max_err(torch, u[1:, sl], pc),
                  max_err(torch, e[1:, sl], pe),
                  max_err(torch, sc2[1:, chunks(sl)], ps))
    print(f"  pack_update in place, {L_COMM} learners: equal to out of "
          f"place and to the plain version")
    for j in range(L_COMM):  # a fresh dither for the timing
        filled(torch, 30 + j, rows, out=u[j], uniform=True)
    c = torch.empty_like(u)
    # err over e, as on the main path; c into its own buffer so that the
    # dither stays a dither from one launch to the next
    ms = cuda_ms(torch, lambda: pu.pack_update_cuda(
        w, g, e, u, 127, BLOCK, c_out=c, err_out=e))
    del c
    free(torch)
    # the plain version's temporaries at full size do not fit beside its
    # 48 GB of inputs: its time is the sum over row windows
    plain_ms = sum(
        cuda_ms(torch, lambda sl=sl: pu.pack_update_plain(
            w[:, sl], g[sl], e[:, sl], u[:, sl], 127, BLOCK), warmup=1,
            iters=3)
        for sl in windows(rows))
    del w, e, u, g
    free(torch)
    nchunks = L_COMM * rows // BLOCK
    b_ms, b_by = bound(5 * 4 * L_COMM * n + 4 * n + 4 * nchunks,
                       11 * L_COMM * n)
    return dict(name="pack_update",
                replaces="src/repro/kernels/pack_update.py:62",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 4 to 6: the trainer
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
    assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=steps,
                          sgd_apply=steps * k * L), counts
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


NO_LAUNCHES = dict(fused_momentum_broadcast=0, block_momentum=0,
                   sgd_apply=0, pack_update=0, quantize=0, dequantize=0)


def compressed_full_width(torch, ops) -> dict:
    """Phase 5: full-width Qwen3-1.7B M-AVG with int8 + error feedback."""
    from repro_torch.configs.base import (
        CommConfig,
        MAvgConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine

    cfg = get_config("qwen3-1.7b")
    k, batch, seq, steps = 4, 8, 64, 3
    mcfg = MAvgConfig(algorithm="mavg", num_learners=L_COMM, k_steps=k,
                      comm=CommConfig(scheme="int8"))
    assert mcfg.comm.error_feedback
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=batch,
                       seq_len=seq, meta_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L_COMM, k, batch, seq),
        lr_schedule=warmup_cosine(LR, 5, steps), device="cuda",
    )
    spec = trainer.state.spec
    print(f"  state: {spec.rows} rows x 128, {L_COMM} learners + their EF "
          f"residual, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated")
    peaks = PhasePeaks(torch, trainer)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run(log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = peaks.stop()
    print(f"  launches: {counts}")
    # one pack_update launch per meta step, for the whole learner stack
    assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=steps,
                          sgd_apply=steps * k * L_COMM,
                          pack_update=steps), counts
    losses = [h["loss"] for h in history]
    assert all(math.isfinite(x) for x in losses), losses
    res = trainer.state.comm_residual
    assert tuple(res.shape) == (L_COMM, spec.rows, 128)
    assert bool(torch.isfinite(res).all()) and float(res.abs().max()) > 0
    tail = spec.offsets[-1] + spec.sizes[-1]
    assert not res.view(L_COMM, -1)[:, tail:].any()
    assert not trainer.state.global_params.view(-1)[tail:].any()
    last = history[-1]
    print(f"  losses {[round(x, 4) for x in losses]}; residual finite, "
          f"max |e| {float(res.abs().max()):.3e}, padding tail zero")
    print(f"  comm_compression {last['comm_compression']:.4f}, "
          f"comm_error_norm {last['comm_error_norm']:.4e}, comm_bytes "
          f"{last['comm_bytes']:.6e} of {last['comm_bytes_dense']:.6e}")
    print(f"  peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB); {steps} meta steps in {seconds:.2f} s "
          f"({steps / seconds:.3f} meta steps/s; last step alone "
          f"{last['meta_steps_per_sec']:.3f} meta steps/s, "
          f"{last['samples_per_sec']:.1f} samples/s)")
    print("  peak device memory by part: " + ", ".join(
        f"{name} {v / 1e9:.2f} GB" for name, v in peaks.parts))
    assert peak < 80e9, peak
    profile_meta_step(torch, trainer, 1e3 / last["meta_steps_per_sec"])
    del trainer, res
    free(torch)
    return counts


class PhasePeaks:
    """The peak device memory of a trainer's run taken apart: set-up, then
    for every meta step its local phase and its meta mix. The peak
    counter is read and reset as each part ends (the topology's ``mix`` is
    wrapped for that); the run's peak is the largest part."""

    def __init__(self, torch, trainer):
        self.torch, self.topology = torch, trainer._topology
        self.parts = [("set-up", torch.cuda.max_memory_allocated())]
        torch.cuda.reset_peak_memory_stats()
        self.mix = self.topology.mix
        self.topology.mix = self._mix

    def _end(self, name):
        cuda = self.torch.cuda
        self.parts.append((name, cuda.max_memory_allocated()))
        cuda.reset_peak_memory_stats()

    def _mix(self, *args, step, **kw):
        self._end(f"step {step} local phase")
        out = self.mix(*args, step=step, **kw)
        self._end(f"step {step} meta mix")
        return out

    def stop(self) -> int:
        self._end("after the run")
        self.topology.mix = self.mix
        return max(v for _, v in self.parts)


# kernel-name fragments -> the class a kernel's device time is booked to
KERNEL_CLASSES = (
    ("port kernels", ("momentum_kernel", "sgd_kernel", "chunk_quant_kernel",
                      "dequant_kernel")),
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


class MaxDisplacement:
    """A reducer wrapper that records the largest |w_j - gp (+ e_j)| its
    reduces saw: 1/127 of it is the largest scale quantum."""

    def __init__(self, inner):
        self.inner, self.value = inner, 0.0

    def init_residual(self, gp, num_learners):
        return self.inner.init_residual(gp, num_learners)

    def reduce(self, learners, gp, residual, *, step):
        from repro_torch.utils.tree import tree_leaves, tree_map

        d = tree_map(lambda w, g: (w.float() - g.float()[None]), learners,
                     gp)
        if residual is not None:
            d = tree_map(lambda x, e: x + e, d, residual)
        self.value = max([self.value] + [float(x.abs().max())
                                         for x in tree_leaves(d)])
        return self.inner.reduce(learners, gp, residual, step=step)


def card_vs_cpu(torch, ops) -> dict:
    """Phase 6. Returns the launch counts of the per-leaf runs."""
    from repro_torch.comm import make_reducer, seeded_dither
    from repro_torch.configs.base import CommConfig, MAvgConfig, get_config
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
    n_leaves = len(tree_leaves(params))
    cpu_dither = seeded_dither(7)

    def shared_dither(i, step, shape, device):
        # drawn on the CPU, so both devices round on the same uniforms
        return cpu_dither(i, step, shape, "cpu").to(device)

    per_leaf = {}
    runs = (  # (label, packed, comm scheme, launches per device)
        ("dense per-leaf", False, "dense",
         dict(block_momentum=2 * n_leaves, sgd_apply=8 * n_leaves)),
        ("dense packed", True, "dense",
         dict(fused_momentum_broadcast=2, sgd_apply=8)),
        ("int8+EF packed", True, "int8",
         dict(fused_momentum_broadcast=2, sgd_apply=8, pack_update=2)),
        ("int8+EF per-leaf", False, "int8",
         dict(block_momentum=2 * n_leaves, sgd_apply=8 * n_leaves,
              quantize=2 * n_leaves, dequantize=2 * n_leaves)),
        ("int8_topk+EF packed", True, "int8_topk",
         dict(fused_momentum_broadcast=2, sgd_apply=8, quantize=2,
              dequantize=2)),
    )
    for label, packed, scheme, launches in runs:
        mcfg = MAvgConfig(algorithm="mavg", num_learners=2, k_steps=2,
                          learner_lr=0.1, momentum=0.7, packed=packed,
                          comm=CommConfig(scheme=scheme))
        finals, spread = {}, 0.0
        for device in ("cpu", "cuda"):
            red = MaxDisplacement(make_reducer(mcfg,
                                               dither=shared_dither))
            state = init_state(tree_map(lambda x: x.to(device), params),
                               mcfg, reducer=red)
            step = make_meta_step(loss_fn, mcfg, reducer=red)
            ops.reset_launch_counts()
            for b in batches:
                state, _ = step(state, tree_map(lambda x: x.to(device), b))
            counts = ops.launch_counts()
            finals[device] = [
                x.cpu() for field in ("global_params", "comm_residual")
                for x in tree_leaves(getattr(state, field))
                if getattr(state, field) is not None]
            spread = max(spread, red.value)
        want = dict(NO_LAUNCHES, **launches)
        assert counts == want, (label, counts, want)
        if not packed:
            per_leaf = dict(per_leaf, **{k: v for k, v in counts.items()
                                         if v})
        pairs = list(zip(finals["cpu"], finals["cuda"]))
        if scheme == "dense":
            worst = 0.0
            for c, g in pairs:
                torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-6)
                worst = max(worst, float((g - c).abs().max()))
            print(f"  {label}: card == CPU to rtol=1e-5, atol=1e-6 (max "
                  f"|diff| {worst:.3e}); launches {counts}")
            continue
        quantum = spread / 127
        # a top-k selection flip moves one kept value (at most the
        # largest displacement) between the wire and the residual
        limit = FLIP_QUANTA * quantum + (spread if "topk" in scheme else 0)
        total = differ = off = 0
        worst = 0.0
        for c, g in pairs:
            diff = (g - c).abs()
            beyond = diff > 1e-6 + 1e-5 * c.abs()
            total += c.numel()
            differ += int((diff > 0).sum())
            off += int(beyond.sum())
            worst = max(worst, float(diff.max()))
        assert worst <= limit, (label, worst, limit)
        assert off <= FLIP_SHARE * total, (label, off, total)
        print(f"  {label}: card vs CPU over {total} values (meta params and "
              f"residual): {differ / total:.4%} not bitwise equal, "
              f"{off / total:.4%} beyond rtol=1e-5/atol=1e-6 (limit "
              f"{FLIP_SHARE:.1%}); max |diff| {worst:.3e} = "
              f"{worst / quantum:.3f} quanta (quantum {quantum:.3e}, limit "
              f"{limit / quantum:.1f}); launches {counts}")
    return per_leaf


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
    from repro_torch.kernels import pack_update as pu
    from repro_torch.kernels import quantize as qk
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
        r["source"] = SOURCE
    comm_records = (check_quantize(torch, qk, rows)
                    + [check_pack_update(torch, pu, rows)])
    for r in comm_records:
        r["source"] = COMM_SOURCE
    records += comm_records
    for r in records:
        print(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
              f"ms by {r['bound_by']}), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']}")

    print("phase 4: full-width Qwen3-1.7B M-AVG trainer, dense")
    dense_counts = full_width_training(torch, ops)

    print(f"phase 5: full-width Qwen3-1.7B M-AVG trainer, int8 + error "
          f"feedback, L={L_COMM}")
    comm_counts = compressed_full_width(torch, ops)

    print("phase 6: card vs CPU, qwen3-1.7b.reduced() float32")
    leaf_counts = card_vs_cpu(torch, ops)

    # each kernel's launches in the run of the path it serves: the dense
    # and compressed full-width runs, and the reduced per-leaf runs
    launches = dict(
        fused_momentum_broadcast=dense_counts["fused_momentum_broadcast"],
        sgd_apply=dense_counts["sgd_apply"],
        pack_update=comm_counts["pack_update"],
        block_momentum=leaf_counts["block_momentum"],
        quantize=leaf_counts["quantize"],
        dequantize=leaf_counts["dequantize"])
    for r in records:
        r.update(route="cuda", launches=launches[r["name"]])
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
