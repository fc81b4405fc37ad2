#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together); each kernel's registers and
   spills, and whether the flash-attention kernels' SASS holds HGMMA
   (wgmma) and UTMALDG (TMA) instructions (``cuobjdump -sass`` where the
   toolkit has it, else "not checked"): the f32 kernel's HGMMA all on
   TF32 operands, and no local memory (LDL/STL) nor spill in it;
3. each kernel against its plain PyTorch version at the main paths'
   shapes, the full Qwen3-1.7B packed plane (13,441,992 x 128): the meta
   kernels with L=4, the wire-compression kernels (quantize, dequantize at
   qmax 127 and 7; pack_update and pack_compress with L=2, with and
   without the residual or err plane, in place and out of place) at the
   chunk height b=8 the plane gets, and once at b=64 on its first
   13,441,984 rows; pack_compress again on the (4, 4,790,496, 128) stack
   of the 6-layer plane (the topology runs' shape before their depth was
   cut to DEPTH) at the b=32 that
   choose_block gives it (four chunks to a block of threads); neighbor_mix
   with L=4 in f32 and bf16, in place and out of place, and its stepped
   entry with the (2, 4, 4) one_peer_exponential stack; robust_reduce with
   L=4 at trims 0 and 1 on the full plane, L=8 at trims 0-3 and L=5 at the
   median on the 6-layer plane, a stack of NaN, +-inf and -0.0, and trim 0
   against torch.mean at L = 2, 3, 4 and 8. Bitwise equality over the
   whole plane (in windows of rows, so the plain version's temporaries
   fit), then
   CUDA-event times of the kernel, the plain version and, where one
   exists, a single PyTorch library call, beside the least time the card
   could take: the kernel's declared cost (``cost(...)`` beside each
   wrapper, the one the cost model charges: each input read and each
   output written once) at the H100 SXM data sheet's rates
   (``roofline.terms.H100_SXM``), bytes over 3.35 TB/s or flops over 67
   TFLOP/s, whichever is larger; sgd_apply's times interleaved with torch.add's (kernel, add,
   add, kernel). Then flash_attention, which is not bitwise (another
   summation order), bf16 through the bf16 Hopper kernel (TMA, wgmma) and
   f32 through the 3xTF32 one (TMA, TF32 wgmma): against the plain
   version's f32 result on the same inputs, to 1e-5 + 1e-4 |plain| in f32
   and one bf16 ulp in bf16, at the serving prefill's shape (Qwen3-1.7B
   heads, B=8, S=512, causal, bf16 and f32), a long prefill (B=4,
   S=4096, bf16 and f32), the 524k variant's window (B=1, S=16384,
   window 8192, compared in windows of queries) and the mask and shape
   cases; its bound counts the visible (q, k) pairs' matmul flops over
   the BF16 tensor-core rate, or three times them over the TF32 rate
   (the f32 CUDA cores' bound printed beside it), and its library call
   is scaled_dot_product_attention (timed only; with an explicit
   boolean mask for the window);
4. the dense main path: the port's Trainer on full-width Qwen3-1.7B at
   ``DEPTH`` (2) of its 28 layers (cut from 6, and earlier from 28, when
   the profiled full-depth step took most of the phase's 130 s), M-AVG with L=4, K=4, B=8, S=64, 3
   meta steps from random
   weights on uniform random tokens, with the kernel launch counters
   zeroed just before and read just after; then one more meta step under
   torch.profiler for the kernel time by class and name and the device's
   idle share;
5. the compressed main path: the same trainer with int8 compression and
   error feedback (``CommConfig(scheme="int8")``), its depth cut to DEPTH of
   28 layers (every width unchanged), L=2 (the residual adds L planes),
   K=4, B=8, S=64, 3 meta steps, counted and profiled the same way;
6. the card against the CPU on ``qwen3-1.7b.reduced()`` in float32, 2 meta
   steps: flat dense per-leaf (``packed=False``, the block-momentum path)
   and packed, then int8+EF packed, int8+EF per-leaf and int8_topk+EF
   packed; gossip ring dense per-leaf and packed, gossip exponential int8
   without EF, gossip one_peer_exponential int8+EF with elastic
   membership, and hierarchical elastic with an int8+EF inner level (L=4
   for the topologies), with the same dither on both devices (drawn on
   the CPU); then robust aggregation, L=4, 3 meta steps, learner 3 under
   sticky finite corruption: flat dense packed and per-leaf (trimmed mean,
   norm clip, scores, finite guard), hierarchical G=2 and gossip ring
   (clip and scores), and the inert robust config against robust off,
   bitwise on the card;
7. gossip at full width: Qwen3-1.7B with every width unchanged and the
   depth cut to DEPTH of 28 layers (four learners' private meta, momentum and
   residual planes do not fit one card at full depth), L=4, K=4, B=8,
   S=64, one_peer_exponential with momentum tracking, int8+EF, 3 meta
   steps, counted, split by memory part and profiled as in phase 5;
8. hierarchical at the same cut: G=2, H=2, mu_out=0.3, elastic
   membership (period 4, drop 0.25: one learner of four absent a step),
   an int8+EF inner level and a dense outer one, 4 meta steps (the outer
   level fires twice);
9. the robust main path at full width, depth cut to DEPTH of 28 layers:
   Qwen3-1.7B, flat dense, L=4, K=4, B=8, S=64, trimmed mean (trim 1), norm clip at 3x a 2-step
   trailing median, anomaly scores and the finite guard, learner 3
   bit-flipped every step and scaled x12 on steps 1-3, 4 meta steps
   (the clip fires on steps 2 and 3), counted, split by memory part and
   profiled as in phase 5;
10. serving: reduced Qwen3 and Qwen2 in f32 on the card against the CPU
   (prefill through the flash kernel, 8 decode steps, greedy generate),
   then full-width, full-depth Qwen3-1.7B with random weights, bf16
   compute, B=8, a 512-token prompt and 64 greedy tokens through
   ``launch/serve.py::generate`` with the flash kernel in prefill (28
   launches, counted), finite logits, flash against plain prefill and
   decode against one forward (teacher forcing) within a bf16 limit,
   prefill ms, decode steps/s and tokens/s, peak memory, and one decode
   step and one prefill profiled; then (10c) the same model and request
   in f32 compute (TF32 off for cuBLAS): one prefill launches the f32
   flash kernel exactly 28 times, finite logits, flash vs plain prefill
   logits within a relative RMS error of 1e-4, 64 greedy tokens through
   ``generate``, prefill ms, peak memory and one prefill profiled (the
   flash kernel's share, the idle share);
11. E1, the paper's acceptance, on the card: E1's CNN (hw=12) for 2 meta
   steps of M-AVG with L=4, K=4, B=8 on the card and on the CPU from the
   same params and CPU-drawn batches, packed and per-leaf, f32 with TF32
   off, every loss and plane within rtol 1e-5 / atol 1e-6
   (fused_momentum_broadcast, sgd_apply and block_momentum counted); then
   ``repro_torch.benchmarks.convergence.main(quick=True, device="cuda")``:
   the MLP, the CNN and the tiny transformer as K-AVG and M-AVG, samples
   to target, speedup and whether each arm reached its target, with E1
   (M-AVG needs at most 1.1x K-AVG's samples) asserted where the
   reference asserts it;
12. the checkpoint at full width: Qwen3-1.7B, widths unchanged, depth cut
   to 1 of 28 layers, flat dense M-AVG with L=2 (the .npz is serialised in
   host memory, so the host holds about twice the state), K=4, B=8, S=64,
   2 meta steps; ``save_state`` of the 5.78 GB state into a temporary
   directory under ``build/`` (removed afterwards), ``verify_checkpoint``,
   a restore in place into a fresh Trainer (every plane bitwise equal, the
   device memory allocated before, after and at its peak printed), one
   more step from the resumed and the uninterrupted trainer (losses
   within rtol 1e-5: ATen's embedding backward is not deterministic on
   the card), a corrupt save that verify refuses and a torn save that
   ``latest_verified_checkpoint`` skips; the save, verify and load
   seconds and GB/s;
13. telemetry (``repro_torch.obs``) and supervised recovery:
   (a) phase 4's configuration (full-width Qwen3-1.7B, flat dense M-AVG,
   L=4, K=4, B=8, S=64) at DEPTH of 28 layers (cut from 28 when the
   profiled full-depth steps took most of its 89 s) for 4 meta steps with the
   JSONL sink,
   the ``obs.*`` spans, the torch profiler and the health watchdogs on and
   log_every=2: the host reads the metric ring once per flush (2 flushes),
   ``tools/check_telemetry.py`` accepts the log (run as a subprocess),
   ``trace.json`` holds the dispatch and flush spans, the torch trace is
   written, no alert fires; 2 steps with the profiler off before and 2
   after give the unprofiled meta step with telemetry on, printed beside
   2 steps of the same configuration with telemetry off;
   (b) ``profile_phases`` on phase 12's configuration (CKPT_DEPTH layers, L=2;
   a clone of the full-depth L=4 state would not fit the card): the whole
   step, the local phase and the meta mix, median and IQR, and
   ``measured_peak_gbps``; (c) the Supervisor on phase 12's configuration
   at 1 of 28 layers (widths unchanged, L=2,
   K=4, B=8, S=64: the run saves two snapshots, verifies them and loads
   one on the host, and at 6 layers the phase took 262 s), with the finite
   guard, a checkpoint every 3 steps, log_every=1 and the watchdogs, a NaN
   batch on learner 0 at step 3 of 5 (the token batches carry a
   per-sequence loss weight of ones, the float leaf the NaN poisoner
   writes into): the run reaches step 5 with every plane finite, the
   first fault is ``nonfinite_loss`` on learner 0, the first recovery is
   attempt 1 with a rollback, the log passes the checker, the peak device
   memory stays under twice the state and at most 256 MB of the failed
   attempt is still allocated when the retry's trainer is built (no
   second state), and the seconds from the halt to the resumed step.
14. the async bounded-staleness server (``repro_torch.topology.
   async_server``): (a) on ``qwen3-1.7b.reduced()`` in f32, L=4, K=2,
   8 ticks, card against CPU within rtol/atol 1e-5 with the fired counts
   and staleness equal: the mavg server on (1, 1, 2, 4), tau 3, packed
   and per-leaf; eamsgd; downpour at tau 2; the server with the robust
   clip and the finite guard under learner 3's sticky corruption; with
   elastic membership; under a straggle fault; then the uniform profile
   against flat on the card, bitwise, packed and per-leaf; (b) Qwen3-1.7B
   at full width, DEPTH layers, L=4, K=4, B=8, S=64 through the Trainer: the
   mavg server on (1, 1, 2, 4), tau 3, for 12 ticks (staleness <= 3 and
   fired counts equal to the host replay on every tick, sgd_apply
   launched K times a completed block, no fused launch, every plane and
   anchor finite, peak < 80 GB; the median tick, completed blocks a
   second and one tick profiled with the mix's share), eamsgd for 4
   ticks with the same checks, and the uniform profile for 2 ticks
   bitwise equal to flat (one fused launch a tick); (c) E4, the async
   bench and the chaos bench in quick mode, with the reference's
   assertions.
15. the paper's E2 and E3, the ablations, the gated benches, the suite
   runner and the examples, each with its launches counted and checked
   against what its configuration implies: (a) E2, E3, the ablations and
   ``momentum_tuning`` in quick mode on the card's own streams with the
   reference's assertions; a sweep whose verdict fails there (a margin
   of a few evaluation examples) is run again on the card and on the CPU
   from the same CPU-drawn inputs, TF32 off, its tables equal within one
   evaluation example and its losses within rtol 1e-5 / atol 1e-6, and
   the failed verdict printed; (b) the robust (under the Supervisor),
   topology, elastic, async and chaos benches in quick mode, each through
   ``run.py --only <suite>`` with its trajectory store under ``build/``
   (removed afterwards), the robust, topology, async and chaos stores
   checked by the port's ``obs.baseline.compare`` against
   ``benchmarks/expected/*.json`` (read as data), then the comm bench,
   and ``--only roofline`` run; (c) ``train_100m --width full``
   (125,848,320 parameters) with L=4, K=4, B=8, S=128 for 10 meta steps
   (20 until the whole run neared its limit):
   the loss falls, every plane finite, the peak device memory and the
   rate printed; one more meta step at 2 of its 12 blocks timed and
   profiled (the device's idle share, the bigram draws' device span; all
   12 blocks until the whole run neared its limit), one draw timed alone;
   2 meta steps of
   the same widths at 1 of 12 layers (2 until the whole run neared its
   limit, 12 before that) in f32 (L=4, K=2,
   B=2), TF32 off, card against CPU on
   the same params and batches (dtheta within 5e-5 of its norm, losses
   within rtol 1e-5); then ``serve_batch`` on the reduced archs (dense,
   MoE, hybrid, SSM and the VLM's decode-only demo).
16. the MoE family and the audio and VLM inputs: (a) reduced DeepSeekMoE,
   Kimi-K2, HuBERT and InternVL2 in f32 (TF32 off), card against CPU on
   the same params and batch: logits, aux loss, loss and every gradient;
   for the decoders the prefill through the f32 flash kernel (one launch a
   layer; InternVL2 over its patches and text), 8 decode steps and greedy
   tokens; then 2 packed M-AVG meta steps of DeepSeekMoE (L=4, K=2), every
   plane; rtol 1e-5 with atol 1e-6 (losses, gradients, planes) or 1e-5
   (logits, caches), tokens equal; (b) phase 10b on
   DeepSeekMoE-16B at full width and depth (28 layers: 1 dense + 27 MoE,
   16,375,728,128 f32 parameters, 65.50 GB): the dropless dispatch in
   prefill and decode, 28 bf16 flash launches a prefill, the kernel
   against plain attention on each layer's own inputs, flash vs plain
   prefill and teacher forcing with the second run pinned to the first's
   experts (unpinned, bf16 rounding flips near-tied routes; printed), all
   within the bf16 limit, peak < 80 GB, and the profiles with the expert
   products (``aten::bmm``), the dispatch and combine gathers
   (``aten::index``) and the table scatters by input shape; (c) phase 4
   on DeepSeekMoE-16B at
   full width, depth cut to ``MOE_TRAIN_DEPTH`` layers (1 dense + 1 MoE;
   at 28 layers one plane is 65.5 GB): L=4, K=4, B=8, S=64, capacity
   dropping, 3 meta steps counted (one fused launch and 16 ``sgd_apply`` a
   step), finite, peak < 80 GB, one more profiled.
17. the hybrid and SSM families: (a) phase 16a on reduced Hymba and
   xLSTM (no flash launch in their prefills: JAX's call no Pallas
   kernel; every cache entry, xLSTM's tuples of recurrent states
   included, after the prefill and after 8 decode steps) and 2 packed
   M-AVG meta steps of each; (b) full-width, full-depth Hymba-1.5B (32
   layers, 1,662,366,464 parameters) and xLSTM-350M (24 layers,
   500,706,448) served with phase 10b's request in bf16 compute, no
   kernel launched, teacher forcing within the bf16 limit, prefill and
   decode timed and profiled, peak < 80 GB; (c) phase 4 on each at full
   width (depth in ``FAMILY_TRAIN_DEPTH``), L=4, K=4, B=8, S=64,
   ``FAMILY_TRAIN_STEPS`` meta steps counted (one fused launch and 16
   ``sgd_apply`` a step), peak < 80 GB, one more profiled. The training
   forward recomputes each Hymba block and xLSTM super-block in the
   backward pass, as JAX's remat.
18. the cost model (``repro_torch.roofline``) against the card: (a) the
   card's memory rate (the triad over 1 GiB, ``measured_peak_gbps``) and
   its bf16 and TF32 ``torch.matmul`` rates at 8192^3, beside the data
   sheet's; (b) ``jit_cost`` of phase 4's meta step (Qwen3-1.7B widths,
   DEPTH layers, L=4, K=4, B=8, S=64) on meta copies of the state, then
   the step on the card: the modeled kernel calls equal the launches (1
   fused_momentum_broadcast, 16 sgd_apply), the modeled matmul flops
   equal ``torch.profiler``'s (``with_flops``) exactly (with remat's
   early stop off: see phase 20c), and the modeled
   peak (``peak_state_bytes``) is within COST_PEAK_RTOL (5 %) of the
   step's ``max_memory_allocated`` above the allocation before the
   trainer was built; (c) ``launch/train.py --obs-cost`` for 2 meta steps
   of the reduced model with the JSONL sink, its manifest's ``jit_cost``
   and ``tools/check_telemetry.py`` accepting the log; (d) ``run.py
   --only kernel pack`` on the card, every row ok, the attribution rows
   timing the kernels.
19. the placement half (``repro_torch.sharding``, ``launch/mesh.py``,
   ``launch/specs.py``, the placed meta step, the dry run): (a) phase
   18b's step placed by ``specs.state_shardings`` on a (1, 1) DeviceMesh
   (a fake process group of one rank) and costed as the dry run costs a
   rank: flops, bytes and kernel calls equal 18b's unplaced ``jit_cost``
   exactly, no collective; (b) a real one-GPU DeviceMesh (NCCL, world size
   1) in a process of its own: phase 4's model in each of
   ``PLACED_CONFIGS`` (the dense ``mavg``; int8 + error feedback, L=2;
   hierarchical elastic with int8 + EF inner, G=2; robust aggregation,
   trim 1, with learner 3's payload scaled; the finite guard with a NaN
   learner; per-leaf planes; gossip on the ring with momentum tracking
   and int8 + EF; the async server on the profile (1, 1, 2, 4), tau 3),
   its state placed the same way and stepped 2 meta steps by
   the placed step: its planes, residual and topology buffers bitwise
   equal to the unplaced run's from the same start, every metric equal,
   with as many launches of each kernel (``pack_update``,
   ``pack_compress``, ``block_momentum``, ``robust_reduce``,
   ``neighbor_mix``, ``fused_momentum_broadcast``, ``sgd_apply``); and a
   Trainer with the
   cost analysis and the attribution rows, unplaced and on the mesh: the
   same records, launches, modeled kernel calls and flops; (c) the dry
   run's CLI for the rows of ``DRYRUN_ROWS`` (Qwen3-1.7B and
   DeepSeekMoE-16B train_4k and decode_32k among them) on the single
   (32, 8) mesh in processes of their own (modeled on the meta device, on
   the CPU): every row written, each train row's meta average an
   all-reduce over 'data' of at least the device's plane; then ``run.py
   --only roofline`` tabulates the rows. The dry run starts after phase
   3, in two processes on the host (DeepSeekMoE-16B's prefill_32k in one
   of its own), and runs beside the phases between: its rows are
   layer-scaled (``dryrun_lib.scaled_cost``) and add Hymba's and xLSTM's
   serving rows (decode_32k; xLSTM's prefill_32k), the 32k prefill rows
   of Qwen3-1.7B and DeepSeekMoE-16B and the train_4k rows of Hymba and
   xLSTM (xLSTM's scaled over its 4,096 steps too).
20. block remat, the placed ``mavg_mlocal`` step and costed robust and
   guarded steps: (a) full-width Qwen3-1.7B at all 28 layers, one local
   step's forward and backward (f32 planes, bf16 compute, B=8, S=512,
   uniform tokens) under ``set_remat_policy`` ``full``, ``dots`` and
   ``everything``: peak memory (``max_memory_allocated`` above the
   params) beside the cost model's, ms a step (CUDA-event median of 3),
   the losses equal and each gradient leaf within REMAT_RTOL of
   ``full``'s; ``full`` has the lowest peak; (b) phase 19b's program for
   ``mavg_mlocal`` (local momentum 0.5): the placed planes, the
   local-momentum plane included, bitwise the unplaced ones; (c)
   ``jit_cost`` of phase 9's robust step (trimmed mean, clip, scores,
   finite guard; no corruption) and of a guarded flat dense step, each
   then run on the card: the modeled kernel calls equal the launches,
   and the modeled flops equal ``torch.profiler``'s with the
   checkpoint's early stop off (with it on, the profiler also counts the
   down projection the early stop ends before its kernel).

Each phase's header carries the seconds since the start.

Phases 12 and 13c (side process ``store``) and 14a, 14c, 15a and 15b
(side process ``host``), which the host's copies, checksums and small
launches bound, run in processes of their own on the same card
(``chip_smoke.py --side NAME EPOCH``), started after phase 13b beside
phases 11, 14b, 15c and on. The main process joins ``store`` before
phase 16b, whose 71 GB peak leaves no room for its state, and ``host``
before the kernels record, and prints each one's output there, its
headers stamped from the same start. Phases 3-10c, 13a and 13b run alone;
the phases after 13b share the card and the host with a side process, so
their host-clock times and idle shares are those of a shared card.

The second-to-last line is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

L = 4  # learners on the dense main path
L_COMM = 2  # learners on the compressed main path
MU, ETA, LR = 0.7, 1.0, 0.01
WINDOW_ROWS = 1 << 19  # rows per window of the bitwise comparison
BLOCK = 8  # the scale-chunk height choose_block gives the full plane
SOURCE = "src/repro_torch/kernels/csrc/meta_kernels.cu"
COMM_SOURCE = "src/repro_torch/kernels/csrc/comm_kernels.cu"
TOPOLOGY_SOURCE = "src/repro_torch/kernels/csrc/topology_kernels.cu"
NM_REPLACES = "src/repro/kernels/neighbor_mix.py:39"
NM_STEPPED_REPLACES = "src/repro/kernels/neighbor_mix.py:85"
PC_REPLACES = "src/repro/kernels/pack_update.py:126"
ROBUST_SOURCE = "src/repro_torch/kernels/csrc/robust_kernels.cu"
RR_REPLACES = "src/repro/kernels/robust_reduce.py:57"
ATTENTION_SOURCE = "src/repro_torch/kernels/csrc/attention_hopper.cu"
ATTENTION_F32_SOURCE = "src/repro_torch/kernels/csrc/attention_hopper_f32.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:80"
# layers (of 28) of the full-width topology runs, of phases 4, 5 and 9
# (the dense, compressed and robust main paths), 13a (telemetry), and of
# phase 12 (the checkpoint; 13b takes its configuration): phases 5, 9
# and 12 were cut from 28, 28 and 6 layers when phase 15 joined, 4 and 13a
# from 28 when phase 16 did, and all of them from 6 to 2 when phase 17 did
# (the run took 1261.1 s with phase 17 at 6, measured on one H100),
# so that the whole run stays well inside its time limit; every width is
# unchanged. Phase 19b's placed and unplaced runs (and 20b's) take it too.
DEPTH = 2
CKPT_DEPTH = 1
# layers of phase 14b's async server at full width, a side path: 2 (DEPTH)
# until the whole run, with the main path at DEPTH, took 1107.6 s of the
# 1100 s it aims at on a card whose host-bound phases ran 20 % slower
ASYNC_DEPTH = 1
# layers of phase 3's cut plane (4,790,496 rows): the gossip and
# hierarchical runs took its chunk height, 32, at 6 layers; at DEPTH
# layers they take 8, as the full plane does, and phase 3 still holds the
# b=32 kernels there
CUT_PLANE_DEPTH = 6
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
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up. Each
    timing starts behind a spin kernel of about a millisecond, so the card
    is still busy while the host enqueues ``fn``: the events then measure
    the device's time alone, not the host's launch latency (tens of
    microseconds of Python, which a 0.05 ms kernel would otherwise carry)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sass_ops(path, fragment: str, ops) -> dict | None:
    """How many of each SASS opcode in ``ops`` the functions of the shared
    library ``path`` whose names hold ``fragment`` contain, through
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    counts, name = dict.fromkeys(ops, 0), ""
    counts["functions"] = 0
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line
            counts["functions"] += fragment in name
        elif fragment in name:
            for op in ops:
                counts[op] += op in line
    return counts


def bound(cost) -> tuple[float, str]:
    """The least time of one kernel call in ms, and what bounds it: the
    kernel's declared cost (``cost(...)`` beside its wrapper, the one the
    cost model charges) at the H100 SXM data sheet's rates
    (``roofline.terms.kernel_bound``)."""
    from repro_torch.roofline.terms import kernel_bound

    seconds, by = kernel_bound(cost)
    return seconds * 1e3, by


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


@contextlib.contextmanager
def full_f32(torch):
    """Full float32 matmuls and convolutions on the card, as on the CPU,
    for a card-vs-CPU parity check; the TF32 flags a user's run sees come
    back after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def free(torch):
    # a phase's trainer can sit in a reference cycle (a wrapped bound
    # method), so collect before the cache is emptied
    gc.collect()
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
    w, v, a = plane(), plane(), plane()
    cost = fm.cost(w, v, a, MU, ETA, L, torch.float32)
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
    b_ms, b_by = bound(cost)
    return dict(name="fused_momentum_broadcast",
                replaces="src/repro/kernels/fused_meta.py:57",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_block_momentum(torch, bm, rows, plane) -> dict:
    w, v, a = plane(), plane(), plane()
    cost = bm.cost(w, v, a, MU, ETA)
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
    b_ms, b_by = bound(cost)
    return dict(name="block_momentum",
                replaces="src/repro/kernels/block_momentum.py:47",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_sgd_apply(torch, sgd, rows, plane) -> dict:
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
    # the main path's case: f32 learner plane; the kernel and the yardstick
    # (torch.add, never called by the port; it may contract to an FMA) in
    # turns, kernel, add, add, kernel, each a median of 10
    cost = sgd.cost(w, g, LR, out=out)
    kernel = lambda: sgd.sgd_apply_cuda(w, g, LR, out=out)  # noqa: E731
    add = lambda: torch.add(w, g, alpha=-LR, out=out)  # noqa: E731
    turns = [cuda_ms(torch, fn) for fn in (kernel, add, add, kernel)]
    ms = statistics.median((turns[0], turns[3]))
    library_ms = statistics.median((turns[1], turns[2]))
    print(f"  sgd_apply in turns: kernel {turns[0]:.3f}, add {turns[1]:.3f}, "
          f"add {turns[2]:.3f}, kernel {turns[3]:.3f} ms")
    plain_ms = cuda_ms(torch, lambda: sgd.sgd_apply_plain(w, g, LR, out=out))
    sgd.sgd_apply_cuda(w, g, LR, out=out)
    sgd.sgd_apply_cuda(w, g, LR, out=w)  # in place, as the meta step runs it
    err = max(err, max_err(torch, w, out))
    print("  sgd_apply in place: equal to out of place")
    del w, g, out
    free(torch)
    b_ms, b_by = bound(cost)
    return dict(name="sgd_apply",
                replaces="src/repro/kernels/local_sgd.py:24",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def check_quantize(torch, qk, rows) -> list[dict]:
    """quantize and dequantize at qmax 127 and 7, b=8 over the full plane
    and b=64 over its first 64-divisible rows; a NaN chunk; times of the
    int8 (qmax 127, b=8) case."""
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
    q_cost = qk.quantize_cost(x, u, 127, BLOCK)
    ms = cuda_ms(torch, lambda: qk.quantize_cuda(x, u, 127, BLOCK))
    plain_ms = cuda_ms(torch, lambda: qk.quantize_plain(x, u, 127, BLOCK))
    nchunks = rows // BLOCK
    b_ms, b_by = bound(q_cost)
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
    b_ms, b_by = bound(qk.dequantize_cost(q, sc))
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
    cost = pu.pack_update_cost(w, g, e, u, 127, BLOCK)
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
    b_ms, b_by = bound(cost)
    return dict(name="pack_update",
                replaces="src/repro/kernels/pack_update.py:62",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_neighbor_mix(torch, nm, rows) -> list[dict]:
    """neighbor_mix over the (4, rows, 128) stack with the ring's matrix
    (weights 1/3, inexact in f32), bf16 then f32, out of place and in
    place; the stepped entry with the (2, 4, 4) one_peer_exponential stack
    at steps 0 and 1. Times of the f32 cases, the plain versions summed
    over row windows, and ``torch.einsum`` (the library's product) beside
    them."""
    from repro_torch.topology import mixing_matrix, mixing_matrix_stack

    W = mixing_matrix("ring", L)
    stack = mixing_matrix_stack("one_peer_exponential", L)
    assert stack.shape == (2, L, L)
    err = 0.0

    def check(got, x, w, step=None):
        nonlocal err
        for sl in windows(rows):
            want = (nm.neighbor_mix_plain(x[:, sl], w) if step is None else
                    nm.neighbor_mix_stepped_plain(x[:, sl], w, step))
            err = max(err, max_err(torch, got[:, sl], want))

    for dt in (torch.bfloat16, torch.float32):
        x = torch.empty(L, rows, 128, dtype=dt, device="cuda")
        for j in range(L):
            filled(torch, 40 + j, rows, out=x[j])
        out = torch.empty_like(x)
        nm.neighbor_mix_cuda(x, W, out=out)
        torch.cuda.synchronize()
        check(out, x, W)
        print(f"  neighbor_mix dtype={dt}: bitwise equal over {L} x {rows} "
              f"rows")
        if dt == torch.float32:
            for step in (0, 1):
                nm.neighbor_mix_stepped_cuda(x, stack, step, out=out)
                torch.cuda.synchronize()
                check(out, x, stack, step)
            print("  neighbor_mix_stepped steps 0, 1: bitwise equal")
            cost = nm.cost(x, W, out=out)
            ms = cuda_ms(torch, lambda: nm.neighbor_mix_cuda(x, W, out=out))
            stepped_ms = cuda_ms(torch, lambda: nm.neighbor_mix_stepped_cuda(
                x, stack, 1, out=out))
            plain_ms = sum(cuda_ms(
                torch, lambda sl=sl: nm.neighbor_mix_plain(x[:, sl], W),
                warmup=1, iters=3) for sl in windows(rows))
            stepped_plain_ms = sum(cuda_ms(
                torch, lambda sl=sl: nm.neighbor_mix_stepped_plain(
                    x[:, sl], stack, 1), warmup=1, iters=3)
                for sl in windows(rows))
            nm.neighbor_mix_cuda(x, W, out=out)

            def refill():
                for j in range(L):
                    filled(torch, 40 + j, rows, out=x[j])

            window = check_neighbor_mix_window(torch, nm, x, W, stack, out,
                                               refill)
            refill()
            nm.neighbor_mix_cuda(x, W, out=out)
        # in place, as the gossip step runs it
        nm.neighbor_mix_cuda(x, W, out=x)
        for sl in windows(rows):
            err = max(err, max_err(torch, x[:, sl], out[:, sl]))
        print(f"  neighbor_mix dtype={dt} in place: equal to out of place")
        del out
        if dt == torch.bfloat16:
            del x
        free(torch)
    # the yardstick, never called by the port: one product (L, L) x (L, n)
    Wd = torch.from_numpy(W).cuda()
    library_ms = cuda_ms(torch, lambda: torch.einsum("jk,kn->jn", Wd,
                                                     x.view(L, -1)))
    del x
    free(torch)
    b_ms, b_by = bound(cost)
    return [dict(name="neighbor_mix", replaces=NM_REPLACES,
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=library_ms),
            dict(name="neighbor_mix_stepped", replaces=NM_STEPPED_REPLACES,
                 max_abs_err=err, ms=stepped_ms, plain_ms=stepped_plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=library_ms),
            window]


def check_neighbor_mix_window(torch, nm, x, W, stack, out, refill) -> dict:
    """The output window (a rank of a mesh mixing its own learners of the
    stack gathered over the learner axes): outputs L/2 .. L - 1 of the
    f32 (L, rows, 128) stack ``x``, plain and stepped (steps 0 and 1).
    The window, written in place into x's rows L/2.., is bitwise the
    square call's rows in ``out``, and so is the plain window of the
    refilled x, summed over row windows. Then the CUDA-event time of the
    window into ``out``'s first rows beside its bound (L planes read, L/2
    written), its plain version's, and ``torch.einsum`` of the window's
    rows of W. ``x`` is refilled before each check and left as the last
    one wrote it."""
    rows = x.shape[1]
    j0, n = L // 2, L - L // 2
    err = 0.0
    for w, step in ((W, None), (stack, 0), (stack, 1)):
        refill()
        if step is None:
            nm.neighbor_mix_cuda(x, w, out=out)
            nm.neighbor_mix_cuda(x, w, out=x[j0:], window=(j0, n))
        else:
            nm.neighbor_mix_stepped_cuda(x, w, step, out=out)
            nm.neighbor_mix_stepped_cuda(x, w, step, out=x[j0:],
                                         window=(j0, n))
        torch.cuda.synchronize()
        for sl in windows(rows):
            err = max(err, max_err(torch, x[j0:, sl], out[j0:, sl]))
        refill()
        for sl in windows(rows):
            want = (nm.neighbor_mix_plain(x[:, sl], w, window=(j0, n))
                    if step is None else nm.neighbor_mix_stepped_plain(
                        x[:, sl], w, step, window=(j0, n)))
            err = max(err, max_err(torch, out[j0:, sl], want))
    print(f"  neighbor_mix window ({j0}, {n}) of {L}: bitwise equal to the "
          f"square call's rows {j0}..{L - 1} and to its plain version, "
          f"plain and stepped (steps 0, 1)")
    dst = out[:n]
    cost = nm.cost(x, W, out=dst, window=(j0, n))
    ms = cuda_ms(torch, lambda: nm.neighbor_mix_cuda(x, W, out=dst,
                                                     window=(j0, n)))
    plain_ms = sum(cuda_ms(
        torch, lambda sl=sl: nm.neighbor_mix_plain(x[:, sl], W,
                                                   window=(j0, n)),
        warmup=1, iters=3) for sl in windows(rows))
    Wd = torch.from_numpy(W[j0:]).cuda()
    library_ms = cuda_ms(torch, lambda: torch.einsum("jk,kn->jn", Wd,
                                                     x.view(L, -1)))
    b_ms, b_by = bound(cost)
    return dict(name="neighbor_mix_window", replaces=NM_REPLACES,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def check_pack_compress_main(torch, pu, rows) -> float:
    """pack_compress on the (4, rows, 128) stack of the CUT_PLANE_DEPTH-
    layer plane at the chunk height ``choose_block`` gives that plane
    (b=32: four chunks to a block of
    threads, each chunk's max reduced across its warps through shared
    memory). Without and with err, out of place against the plain version
    in row windows, then in place (c over u; err over d) against the
    out-of-place results; then CUDA-event times beside the bounds.
    Returns the largest difference (0.0)."""
    from repro_torch.kernels.quantize import choose_block

    b = choose_block(rows, None)
    d, u = (torch.empty(L, rows, 128, device="cuda") for _ in range(2))

    def fill():
        for j in range(L):
            filled(torch, 70 + j, rows, out=d[j], scale=0.05)
            filled(torch, 80 + j, rows, out=u[j], uniform=True)

    fill()
    c0, e0, s0 = pu.pack_compress_cuda(d, u, 127, b, with_err=False)
    c1, e1, s1 = pu.pack_compress_cuda(d, u, 127, b)
    assert e0 is None
    torch.cuda.synchronize()
    err = 0.0
    for sl in windows(rows):
        cs = chunks(sl, b)
        pc, _, ps = pu.pack_compress_plain(d[:, sl], u[:, sl], 127, b,
                                           with_err=False)
        err = max(err, max_err(torch, c0[:, sl], pc),
                  max_err(torch, s0[:, cs], ps))
        pc, pe, ps = pu.pack_compress_plain(d[:, sl], u[:, sl], 127, b)
        err = max(err, max_err(torch, c1[:, sl], pc),
                  max_err(torch, e1[:, sl], pe),
                  max_err(torch, s1[:, cs], ps))
    print(f"  pack_compress ({L}, {rows}, 128), b={b}, err=False and True: "
          f"bitwise equal to the plain version")
    uu = u.clone()
    _, _, s2 = pu.pack_compress_cuda(d, uu, 127, b, with_err=False,
                                     c_out=uu)
    err = max(err, max_err(torch, s2, s0))
    for sl in windows(rows):
        err = max(err, max_err(torch, uu[:, sl], c0[:, sl]))
    del uu
    _, _, s2 = pu.pack_compress_cuda(d, u, 127, b, c_out=u, err_out=d)
    err = max(err, max_err(torch, s2, s1))
    for sl in windows(rows):
        err = max(err, max_err(torch, u[:, sl], c1[:, sl]),
                  max_err(torch, d[:, sl], e1[:, sl]))
    print(f"  pack_compress ({L}, {rows}, 128), b={b}, in place (c over u, "
          f"err over d; and c over u without err): equal to out of place")
    fill()  # fresh inputs for the timing
    costs = [pu.pack_compress_cost(d, u, 127, b, with_err=we)
             for we in (True, False)]
    ms = cuda_ms(torch, lambda: pu.pack_compress_cuda(
        d, u, 127, b, c_out=c1, err_out=e1))
    no_err_ms = cuda_ms(torch, lambda: pu.pack_compress_cuda(
        d, u, 127, b, with_err=False, c_out=c0))
    del d, u, c0, c1, e1, s0, s1, s2
    free(torch)
    (b_ms, _), (nb_ms, _) = (bound(c) for c in costs)
    print(f"  pack_compress ({L}, {rows}, 128), b={b}: {ms:.3f} ms with err "
          f"(bound {b_ms:.3f} ms), {no_err_ms:.3f} ms without (bound "
          f"{nb_ms:.3f} ms)")
    return err


def check_pack_compress(torch, pu, rows) -> dict:
    """pack_compress over the (2, rows, 128) f32 displacement stack: out of
    place on learner 0 with and without err at b=8, with err at b=64,
    equal to pack_update with a zero meta plane; in place on both
    learners (c over u, err over d) as the gossip step runs it; times of
    the error-feedback case."""
    d, u = (torch.empty(L_COMM, rows, 128, device="cuda") for _ in range(2))
    for j in range(L_COMM):
        filled(torch, 50 + j, rows, out=d[j], scale=0.05)
        filled(torch, 60 + j, rows, out=u[j], uniform=True)
    rows64 = rows - rows % 64
    err = 0.0
    for block, nrows, with_err in ((BLOCK, rows, False), (64, rows64, True),
                                   (BLOCK, rows, True)):
        c, er, sc = pu.pack_compress_cuda(d[:1, :nrows], u[:1, :nrows], 127,
                                          block, with_err=with_err)
        assert (er is None) == (not with_err)
        torch.cuda.synchronize()
        for sl in windows(nrows):
            pc, pe, ps = pu.pack_compress_plain(d[:1, sl], u[:1, sl], 127,
                                                block, with_err=with_err)
            err = max(err, max_err(torch, c[:, sl], pc),
                      max_err(torch, sc[:, chunks(sl, block)], ps))
            if with_err:
                err = max(err, max_err(torch, er[:, sl], pe))
        print(f"  pack_compress learner 0, err={with_err}, b={block}: "
              f"bitwise equal over {nrows} rows")
        if block == 64 or not with_err:
            del c, er, sc
            free(torch)
    # the compress-only kernel is pack_update with a zero meta plane
    zeros = torch.zeros(rows, 128, device="cuda")
    pc, pe, ps = pu.pack_update_cuda(d[:1], zeros, None, u[:1], 127, BLOCK)
    err = max(err, max_err(torch, c, pc), max_err(torch, er, pe),
              max_err(torch, sc, ps))
    print("  pack_compress == pack_update(d, 0, None, u): bitwise")
    del zeros, pc, pe, ps
    free(torch)
    # in place on both learners: learner 0 against the out-of-place
    # result, learner 1 against the plain version on its inputs made again
    _, _, sc2 = pu.pack_compress_cuda(d, u, 127, BLOCK, c_out=u, err_out=d)
    for sl in windows(rows):
        err = max(err, max_err(torch, u[:1, sl], c[:, sl]),
                  max_err(torch, d[:1, sl], er[:, sl]))
    err = max(err, max_err(torch, sc2[:1], sc))
    del c, er, sc
    free(torch)
    for k, sl in enumerate(windows(rows)):
        nr = sl.stop - sl.start
        d1 = window_values(torch, 51, k, nr, scale=0.05)
        u1 = window_values(torch, 61, k, nr, uniform=True)
        pc, pe, ps = pu.pack_compress_plain(d1[None], u1[None], 127, BLOCK)
        err = max(err, max_err(torch, u[1:, sl], pc),
                  max_err(torch, d[1:, sl], pe),
                  max_err(torch, sc2[1:, chunks(sl)], ps))
    print(f"  pack_compress in place, {L_COMM} learners: equal to out of "
          f"place and to the plain version")
    for j in range(L_COMM):  # fresh inputs for the timing
        filled(torch, 50 + j, rows, out=d[j], scale=0.05)
        filled(torch, 60 + j, rows, out=u[j], uniform=True)
    c, e_out = torch.empty_like(u), torch.empty_like(d)
    costs = [pu.pack_compress_cost(d, u, 127, BLOCK, with_err=we)
             for we in (True, False)]
    ms = cuda_ms(torch, lambda: pu.pack_compress_cuda(
        d, u, 127, BLOCK, c_out=c, err_out=e_out))
    no_err_ms = cuda_ms(torch, lambda: pu.pack_compress_cuda(
        d, u, 127, BLOCK, with_err=False, c_out=c))
    del c, e_out
    free(torch)
    plain_ms = sum(
        cuda_ms(torch, lambda sl=sl: pu.pack_compress_plain(
            d[:, sl], u[:, sl], 127, BLOCK), warmup=1, iters=3)
        for sl in windows(rows))
    del d, u
    free(torch)
    (b_ms, b_by), (nb_ms, _) = (bound(c) for c in costs)
    print(f"  pack_compress without err: {no_err_ms:.3f} ms (bound "
          f"{nb_ms:.3f} ms)")
    return dict(name="pack_compress", replaces=PC_REPLACES, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def same_bits(torch, got, want) -> float:
    """Raise unless ``got`` and ``want`` are NaN at the same places and
    bitwise equal elsewhere (sign bits of zeros included); the largest
    |difference| over the non-NaN values (0.0)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError("kernel and plain version differ in NaNs")
    ok = ~nan
    if not torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32)):
        raise AssertionError(
            f"kernel differs from plain version: max |diff| "
            f"{float((got[ok] - want[ok]).abs().max())}")
    return 0.0


def check_robust_reduce(torch, rr, rows, rows_cut) -> dict:
    """robust_reduce: bitwise against its plain version in row windows on
    the full (4, rows, 128) plane at trim 0 and 1 (the main path's L and
    trim), on the CUT_PLANE_DEPTH-layer (8, rows_cut, 128) plane at trims 0-3 and its
    first five learners at trim 2 (the median), and on a small stack of
    NaN, +-inf and -0.0; trim 0 against torch.mean for L = 2, 3, 4 and 8;
    CUDA-event times of the kernel, the plain version and the library
    calls (torch.mean at trim 0, torch.quantile's midpoint for the even-L
    median, L=4 trim 1, torch.median for odd L at the median)."""
    err = 0.0

    def check(x, trim, nrows):
        nonlocal err
        got = rr.robust_reduce_cuda(x, trim)
        torch.cuda.synchronize()
        for sl in windows(nrows):
            err = max(err, same_bits(torch, got[sl],
                                     rr.robust_reduce_plain(x[:, sl], trim)))
        return got

    x = torch.empty(L, rows, 128, device="cuda")
    for j in range(L):
        filled(torch, 90 + j, rows, out=x[j])
    for trim in (0, 1):
        check(x, trim, rows)
        print(f"  robust_reduce ({L}, {rows}, 128) trim={trim}: bitwise "
              f"equal to the plain version")
        free(torch)
    out = torch.empty(rows, 128, device="cuda")
    costs = [rr.cost(x, trim) for trim in (1, 0)]
    ms = cuda_ms(torch, lambda: rr.robust_reduce_cuda(x, 1, out=out))
    ms0 = cuda_ms(torch, lambda: rr.robust_reduce_cuda(x, 0, out=out))
    mean_ms = cuda_ms(torch, lambda: torch.mean(x, dim=0, out=out))
    # the plain trimmed mean takes ~5 s and the quantile ~1.3 s a plane:
    # one timed call each (no warm-up) keeps the run inside its limit
    plain_ms = sum(cuda_ms(
        torch, lambda sl=sl: rr.robust_reduce_plain(x[:, sl], 1), warmup=0,
        iters=1) for sl in windows(rows))
    plain0_ms = sum(cuda_ms(
        torch, lambda sl=sl: rr.robust_reduce_plain(x[:, sl], 0), warmup=1,
        iters=3) for sl in windows(rows))
    # at L=4, trim 1 is median_trim(4): the even-L median, the mean of the
    # two middle values, which torch.quantile's midpoint computes in one
    # call (as lerp(a, b, 0.5), so within an ulp, not bitwise); it takes
    # at most 2^24 values a call, so it is timed in such windows and summed
    assert rr.median_trim(L) == 1
    q_rows = (1 << 24) // (L * 128)

    def quantile(sl):
        return torch.quantile(x[:, sl], 0.5, dim=0, interpolation="midpoint")

    head = slice(0, q_rows)
    rr.robust_reduce_cuda(x, 1, out=out)
    q_err = float((quantile(head) - out[head]).abs().max())
    # two roundings of lerp against one of the kernel's sum: a few ulps
    # of the largest |value| of the window
    q_tol = 4 * 2.0 ** -23 * float(x[:, head].abs().max())
    library_ms = sum(cuda_ms(torch, lambda sl=sl: quantile(sl), warmup=0,
                             iters=1)
                     for sl in (slice(r0, min(r0 + q_rows, rows))
                                for r0 in range(0, rows, q_rows)))
    del x, out
    free(torch)
    (b_ms, b_by), (b0_ms, _) = (bound(c) for c in costs)
    print(f"  robust_reduce ({L}, {rows}, 128): trim=1 {ms:.3f} ms (bound "
          f"{b_ms:.3f} ms, {b_ms / ms:.1%}), plain {plain_ms:.3f} ms, "
          f"torch.quantile(midpoint) {library_ms:.3f} ms in "
          f"{-(-rows // q_rows)} calls of {q_rows} rows (max |diff| from "
          f"the kernel {q_err:.3e}); trim=0 {ms0:.3f} ms (bound "
          f"{b0_ms:.3f} ms), plain {plain0_ms:.3f} ms, torch.mean "
          f"{mean_ms:.3f} ms")
    assert q_err <= q_tol, (q_err, q_tol)

    n8 = 8
    x = torch.empty(n8, rows_cut, 128, device="cuda")
    for j in range(n8):
        filled(torch, 100 + j, rows_cut, out=x[j])
    for trim in range(rr.median_trim(n8) + 1):
        check(x, trim, rows_cut)
    print(f"  robust_reduce ({n8}, {rows_cut}, 128) trims 0-3: bitwise "
          f"equal to the plain version")
    x5 = x[:5]
    check(x5, 2, rows_cut)
    print(f"  robust_reduce (5, {rows_cut}, 128) trim=2 (the median): "
          f"bitwise equal to the plain version")
    med_ms = cuda_ms(torch, lambda: rr.robust_reduce_cuda(x5, 2))
    median_ms = cuda_ms(torch, lambda: torch.median(x5, dim=0).values)
    m_ms, _ = bound(rr.cost(x5, 2))
    print(f"  robust_reduce (5, {rows_cut}, 128) median: {med_ms:.3f} ms "
          f"(bound {m_ms:.3f} ms), torch.median {median_ms:.3f} ms")
    for nl in (2, 3, 4, 8):
        got = rr.robust_reduce_cuda(x[:nl], 0)
        want = torch.mean(x[:nl], dim=0)
        bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
        share = float((got != want).float().mean())
        print(f"  robust_reduce trim=0 vs torch.mean, L={nl}: "
              f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} "
              f"({share:.4%} of values differ, max |diff| "
              f"{float((got - want).abs().max()):.3e})")
        del got, want
    del x, x5
    free(torch)

    gen = torch.Generator(device="cuda").manual_seed(5)
    s = torch.randn(4, 64, 128, generator=gen, device="cuda")
    f = s.view(4, -1)
    f[:, :4] = -0.0
    f[0, 8:12] = float("nan")
    f[1, 12:16] = float("inf")
    f[3, 16:20] = float("-inf")
    f[0, 20:24], f[3, 20:24] = float("nan"), float("-inf")
    f[:, 24] = torch.tensor([-0.0, 0.0, -0.0, 0.0])
    for trim in (0, 1):
        got = check(s, trim, 64)
        assert bool(torch.isfinite(got.view(-1)[8:24]).all()) == (trim == 1)
    print("  robust_reduce with NaN, +-inf and -0.0: bitwise equal (NaN "
          "where NaN, signs of zeros); trim=1 trims them to finite values")
    return dict(name="robust_reduce", replaces=RR_REPLACES,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def bhsd(x):
    """(B, S, h, D) -> a (B h, S, D) copy, the plain version's layout."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])


def flash_limit(torch, got, plain32) -> tuple[bool, float, float, float]:
    """The kernel's output against the plain version's f32 result on the
    same inputs. f32: |d| <= 1e-5 + 1e-4 |p|. bf16: within one bf16 ulp of
    p, or within the f32 limit where that is wider (|p| below about
    1.5e-3, where the f32 summation order and not the output rounding
    decides). Returns (ok, max |d|, share of values that differ from p
    rounded to bf16, share more than one ulp from p); both shares 0 in
    f32."""
    p = plain32.to(torch.float32)
    d = (got.to(torch.float32) - p).abs()
    limit = 1e-5 + 1e-4 * p.abs()
    differ = beyond = 0.0
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(p)
        ulp = torch.where(p == 0, torch.zeros_like(p),
                          torch.ldexp(torch.ones_like(p), e - 8))
        differ = float((got != p.to(torch.bfloat16)).float().mean())
        beyond = float((d > ulp).float().mean())
        limit = torch.maximum(limit, ulp)
    return bool((d <= limit).all()), float(d.max()), differ, beyond


def flash_bound(torch, fa, q, k, v, **kw):
    """The least time of one call (``bound`` of the kernel's declared
    cost, ``flash_attention.cost``): the bytes (q, k, v read once, the
    output written once) over the memory rate, or the matmul flops of the
    visible (q, k) pairs of this call's mask (4 D per pair and head) over
    the tensor cores' rate for the input type, whichever is larger: dense
    BF16, or for f32 three TF32 products per matmul (the 3xTF32 split that
    keeps f32's precision). Returns (ms, "bytes" or "operations", and for
    f32 the bound on the f32 CUDA cores, else None)."""
    cost = fa.cost(q, k, v, **kw)
    ms, by = bound(cost)
    cores = None
    if q.dtype != torch.bfloat16:
        cores = bound(dataclasses.replace(cost, unit="f32"))[0]
    return ms, by, cores


def flash_case(torch, fa, B, Sq, Sk, H, KV, D, dtype, *, rows=None,
               timed=False, **kw) -> dict:
    """One flash-attention case: the kernel on (B, S, H, D) projections
    (the model's entry, read through strides) against the plain version's
    f32 result on the same inputs, in windows of ``rows`` queries (through
    its q_offset) so that its (B H, rows, Sk) f32 scores fit; with
    ``timed``, CUDA-event medians of the kernel, the plain version (its
    windows in turn), SDPA where the mask is plain causal, and the
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(Sq * 7 + D)
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dtype)
    got = fa.flash_attention_bshd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    got3 = bhsd(got)
    q3, k3, v3 = (bhsd(x).to(torch.float32) for x in (q, k, v))
    rows = rows or Sq
    ok, err, n = True, 0.0, 0
    differ = beyond = 0.0
    for lo in range(0, Sq, rows):
        want = fa.flash_attention_plain(q3[:, lo:lo + rows], k3, v3,
                                        q_offset=lo, **kw)
        w_ok, w_err, w_differ, w_beyond = flash_limit(
            torch, got3[:, lo:lo + rows], want)
        share = want.shape[1] / Sq
        ok, err = ok and w_ok, max(err, w_err)
        differ, beyond = differ + share * w_differ, beyond + share * w_beyond
        del want
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    label = (f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} {name} "
             f"{' '.join(f'{a}={b}' for a, b in kw.items())}")
    shares = (f", {differ:.4%} differ from the plain result in bf16, "
              f"{beyond:.4%} beyond one ulp" if dtype == torch.bfloat16
              else "")
    print(f"  flash_attention {label}: max |diff| {err:.3g}{shares}")
    assert ok, f"flash_attention {label}: beyond the limit ({err})"
    rec = dict(max_abs_err=err)
    if timed:
        rec["ms"] = cuda_ms(torch, lambda: fa.flash_attention_bshd_cuda(
            q, k, v, **kw))
        del q3, k3, v3, got3
        free(torch)

        def plain():
            for lo in range(0, Sq, rows):
                fa.flash_attention_plain(
                    bhsd(q[:, lo:lo + rows]), bhsd(k), bhsd(v), q_offset=lo,
                    **kw)

        rec["plain_ms"] = cuda_ms(torch, plain, warmup=1, iters=3)
        rec["library_ms"] = None
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if kw == dict(causal=True):
            rec["library_ms"] = cuda_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        elif set(kw) == {"causal", "sliding_window"}:
            # the window as an explicit (Sq, Sk) boolean mask (268 MB at
            # S=16384): no fused backend takes a window
            mask = fa.visible(torch.arange(Sq, device="cuda"),
                              torch.arange(Sk, device="cuda"), kv_len=Sk,
                              prefix_global=0, **kw)
            rec["library_ms"] = cuda_ms(torch, lambda: sdpa(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), warmup=1,
                iters=3)
            del mask
        rec["bound_ms"], rec["bound_by"], cores = flash_bound(
            torch, fa, q, k, v, **kw)
        on_cores = ("" if cores is None else
                    f" (3xTF32; {cores:.3f} ms on the f32 CUDA cores)")
        print(f"    kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
              f"ms, SDPA {rec['library_ms']} ms, bound "
              f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}{on_cores}")
        del qt, kt, vt
    del q, k, v, got
    free(torch)
    return rec


def check_flash_attention(torch, fa) -> list[dict]:
    """flash_attention against its plain version: the serving prefill's
    shape (Qwen3-1.7B heads, B=8, S=512, causal, bf16: the bf16 record's
    times; and f32, timed), a long prefill (B=4, S=4096, causal, bf16, and
    f32: the f32 record's times), the 524k variant's window (B=1,
    S=16384, window 8192, bf16, compared in windows of 2048 queries), and
    the mask and shape cases (non-causal, window + prefix, kv_len < Sk
    down to 0, D = 64, 80, 112 and 256, causal D = 256, a D = 80 window,
    n_rep 1, 2, 4 and 5/5 heads, S = 96 and 1, Sq != Sk), in f32 and
    bf16. Returns the records of the bf16 and the f32 (3xTF32) Hopper
    kernel."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = flash_case(torch, fa, 8, 512, 512, 16, 8, 128, bf16, timed=True,
                      causal=True)
    serve32 = flash_case(torch, fa, 8, 512, 512, 16, 8, 128, f32,
                         timed=True, causal=True)
    errs = {bf16: [main["max_abs_err"]], f32: [serve32["max_abs_err"]]}
    long = {dt: flash_case(torch, fa, 4, 4096, 4096, 16, 8, 128, dt,
                           rows=1024, timed=True, causal=True)
            for dt in (bf16, f32)}
    for dt, rec in long.items():
        errs[dt].append(rec["max_abs_err"])
    errs[bf16].append(flash_case(
        torch, fa, 1, 16384, 16384, 16, 8, 128, bf16, rows=2048, timed=True,
        causal=True, sliding_window=8192)["max_abs_err"])
    small = [  # (B, Sq, Sk, H, KV, D, kwargs)
        (2, 96, 96, 4, 2, 64, dict(causal=False)),
        (2, 128, 128, 4, 2, 64, dict(causal=True, sliding_window=32,
                                     prefix_global=8)),
        (2, 128, 128, 4, 2, 64, dict(causal=True, sliding_window=16,
                                     prefix_global=4)),
        (2, 128, 128, 8, 2, 64, dict(causal=True, kv_len=77)),
        (2, 64, 64, 4, 2, 64, dict(causal=True, kv_len=0)),
        (1, 64, 64, 4, 2, 64, dict(causal=True, sliding_window=16,
                                   kv_len=10)),
        (2, 64, 64, 4, 1, 80, dict(causal=True)),
        (1, 200, 200, 4, 2, 80, dict(causal=True, sliding_window=50)),
        (1, 96, 96, 5, 5, 64, dict(causal=True)),
        (1, 128, 128, 4, 4, 256, dict(causal=False)),
        (1, 300, 300, 4, 4, 256, dict(causal=True)),
        (2, 1, 1, 16, 8, 128, dict(causal=True)),
        (1, 33, 70, 4, 2, 112, dict(causal=False)),
        (1, 100, 60, 4, 2, 128, dict(causal=True, sliding_window=8)),
    ]
    for B, Sq, Sk, H, KV, D, kw in small:
        for dt in (f32, bf16):
            errs[dt].append(flash_case(torch, fa, B, Sq, Sk, H, KV, D, dt,
                                       **kw)["max_abs_err"])
    records = []
    for name, dt, rec, src in (
            ("flash_attention", bf16, main, ATTENTION_SOURCE),
            ("flash_attention_f32", f32, long[f32], ATTENTION_F32_SOURCE)):
        records.append(dict(
            name=name, source=src, replaces=FA_REPLACES,
            max_abs_err=max(errs[dt]), ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    return records


# ---------------------------------------------------------------------------
# phases 4 to 9: the trainer
# ---------------------------------------------------------------------------


def full_width_training(torch, ops, cfg=None, ops_by_shape=(),
                        steps: int = 3,
                        local_profile: bool = False) -> tuple[dict, float]:
    """Phase 4 (Qwen3-1.7B at DEPTH layers; 16c and 17c with ``cfg``):
    flat dense M-AVG, L=4, K=4, B=8, S=64, ``steps`` meta steps on uniform
    tokens, then one more profiled, or with ``local_profile`` one local
    step of it (where a meta step makes too many launches for the
    profiler to take in a few seconds). Returns the launch counts and the
    last unprofiled meta step's wall time in ms."""
    from repro_torch.configs.base import MAvgConfig, TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine

    cfg = cfg or dataclasses.replace(get_config("qwen3-1.7b"),
                                     num_layers=DEPTH)
    k, batch, seq = 4, 8, 64
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
    print(f"  state: {sum(spec.sizes):,} parameters, {spec.rows} rows x 128 "
          f"({spec.plane_bytes() / 1e9:.2f} GB a plane), {L} learners, "
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
    for name in ("global_params", "momentum", "learners"):
        # in row windows: torch.isfinite forms |x| over its whole input
        x = getattr(state, name).view(-1, 128)
        assert all(bool(torch.isfinite(x[sl]).all())
                   for sl in windows(x.shape[0])), name
    assert peak < 80e9, peak
    step_ms = 1e3 / history[-1]["meta_steps_per_sec"]
    if local_profile:
        profile_local_step(torch, trainer, cfg, tcfg)
    else:
        profile_meta_step(torch, trainer, step_ms, ops_by_shape)
    del trainer, state
    free(torch)
    return counts, step_ms


NO_LAUNCHES = dict(fused_momentum_broadcast=0, block_momentum=0,
                   sgd_apply=0, pack_update=0, quantize=0, dequantize=0,
                   pack_compress=0, neighbor_mix=0, neighbor_mix_stepped=0,
                   robust_reduce=0, flash_attention=0,
                   flash_attention_f32=0)


def compressed_full_width(torch, ops) -> dict:
    """Phase 5: Qwen3-1.7B at full width, DEPTH layers, M-AVG with
    int8 + error feedback."""
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

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=DEPTH)
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


def topology_full_width(torch, ops, label, mcfg, steps, expect) -> dict:
    """Phases 7-8: Qwen3-1.7B at full width, depth cut to DEPTH layers,
    through the Trainer with a non-flat topology (``mcfg``), counted,
    checked, split by memory part and profiled. ``expect(steps)`` gives
    the launches the run must make."""
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine

    full = get_config("qwen3-1.7b")
    cfg = dataclasses.replace(full, num_layers=DEPTH)
    print(f"  config: {full.name} widths unchanged (d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, V {cfg.vocab_size}, tied embeddings); depth cut "
          f"{full.num_layers} -> {cfg.num_layers} layers")
    L_, k, batch, seq = mcfg.num_learners, mcfg.k_steps, 8, 64
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=batch,
                       seq_len=seq, meta_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L_, k, batch, seq),
        lr_schedule=warmup_cosine(LR, 5, steps), device="cuda",
    )
    state = trainer.state
    spec = state.spec
    planes = sum(x.numel() for x in [state.global_params, state.momentum,
                                     state.learners] + [
        v for v in state.topo.values()
        if v is not None and v.is_cuda]) // spec.total
    print(f"  state: {spec.rows} rows x 128 ({spec.plane_bytes() / 1e9:.2f} "
          f"GB a plane), {planes} planes, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    peaks = PhasePeaks(torch, trainer)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run(log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = peaks.stop()
    print(f"  launches: {counts}")
    want = dict(NO_LAUNCHES, **expect(steps))
    assert counts == want, (label, counts, want)
    losses = [h["loss"] for h in history]
    assert all(math.isfinite(x) for x in losses), losses
    ln_v = math.log(cfg.vocab_size)
    assert abs(losses[0] - ln_v) <= 1.5, (losses[0], ln_v)
    state = trainer.state
    tail = spec.offsets[-1] + spec.sizes[-1]
    assert not state.global_params.view(-1)[tail:].any()
    assert bool(torch.isfinite(state.global_params).all())
    last = history[-1]
    print(f"  losses {[round(x, 4) for x in losses]} (ln V = {ln_v:.4f}); "
          f"padding tail zero, meta params finite")
    for key in ("comm_compression", "mixing_spectral_gap",
                "consensus_dist", "displacement_norm", "present_count"):
        if key in last:
            print(f"  {key} " + ", ".join(f"{h[key]:.6g}" for h in history))
    if "outer_fired" in last:
        print("  outer_fired " + ", ".join(f"{h['outer_fired']:.0f}"
                                           for h in history))
    print(f"  peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB); {steps} meta steps in {seconds:.2f} s "
          f"({steps / seconds:.3f} meta steps/s; last step alone "
          f"{last['meta_steps_per_sec']:.3f} meta steps/s, "
          f"{last['samples_per_sec']:.1f} samples/s)")
    print("  peak device memory by part: " + ", ".join(
        f"{name} {v / 1e9:.2f} GB" for name, v in peaks.parts))
    assert peak < 80e9, peak
    profile_meta_step(torch, trainer, 1e3 / last["meta_steps_per_sec"])
    del trainer, state
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
                      "dequant_kernel", "neighbor_mix_kernel",
                      "robust_reduce_kernel", "flash_hopper_kernel",
                      "flash_hopper_f32_kernel")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copy/cast", ("copy", "Cat")),
)


def profile_meta_step(torch, trainer, step_ms: float,
                      ops_by_shape=()) -> None:
    """One more meta step under torch.profiler (after the counters were
    read), against ``step_ms``, the wall time of the last unprofiled meta
    step: kernel time by class and name, the device span of each phase,
    and the device's idle share."""
    profile_call(torch, "meta step", lambda: trainer.run(1, log=None),
                 step_ms, ops_by_shape=ops_by_shape)


def profile_local_step(torch, trainer, cfg, tcfg) -> None:
    """One local step of learner 0 as the local phase runs it (the loss
    and its backward into the gradient plane, then the gradient's
    telemetry norm and ``sgd_apply`` on the learner's plane;
    ``core/meta.py``), timed unprofiled and then under
    torch.profiler. It moves learner 0 off the meta params: the trainer
    is not stepped again."""
    from repro_torch.core import meta
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api

    mcfg, state = tcfg.mavg, trainer.state
    batch = uniform_batch_fn(cfg, mcfg.num_learners, mcfg.k_steps,
                             tcfg.batch_per_learner, tcfg.seq_len)(
        torch.Generator(device="cuda").manual_seed(9), 0)
    batch = {k: v[0, 0] for k, v in batch.items()}
    w = state.learners[0]
    g = torch.zeros_like(w)
    w_tree, grads = state.spec.unpack(w), state.spec.unpack(g)

    def step():
        meta._grad_into(lambda p, b: api.loss_fn(p, cfg, b), w_tree, batch,
                        grads)
        meta._update(w, None, g, grads, mcfg, LR)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    profile_call(torch, "local step (learner 0)", step,
                 (time.perf_counter() - t0) * 1e3)


class Spread:
    """Records the largest |displacement| the port's quantizers see while
    it is on (``ops.pack_update``, ``pack_compress`` and ``quant_dequant``
    wrapped): 1/127 of it is the largest int8 scale quantum."""

    NAMES = ("pack_update", "pack_compress", "quant_dequant")

    def __init__(self, ops):
        self.ops, self.value = ops, 0.0
        self.real = {n: getattr(ops, n) for n in self.NAMES}

    def _see(self, x):
        self.value = max(self.value, float(x.abs().max()))

    def __enter__(self):
        real = self.real

        def pack_update(w, g, e, u, **kw):
            d = w.float() - g.float()[None]
            self._see(d if e is None else d + e)
            return real["pack_update"](w, g, e, u, **kw)

        def pack_compress(d, u, **kw):
            self._see(d)
            return real["pack_compress"](d, u, **kw)

        def quant_dequant(x, dither, **kw):
            self._see(x)
            return real["quant_dequant"](x, dither, **kw)

        for name, fn in zip(self.NAMES, (pack_update, pack_compress,
                                         quant_dequant)):
            setattr(self.ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)


def card_vs_cpu(torch, ops) -> tuple[dict, dict]:
    """Phase 6. Returns the card's launch counts of the per-leaf flat runs,
    and their sums over the topology runs."""
    from repro_torch.comm import seeded_dither
    from repro_torch.configs.base import (
        CommConfig,
        ElasticConfig,
        MAvgConfig,
        TopologyConfig,
        get_config,
    )
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.topology import make_topology
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    batches = {n: [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (n, 2, 2, 16), generator=gen)
        for _ in range(2))] for n in (2, 4)}
    loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731
    n_leaves = len(tree_leaves(params))
    cpu_dither = seeded_dither(7)

    def shared_dither(i, step, shape, device):
        # drawn on the CPU, so both devices round on the same uniforms
        return cpu_dither(i, step, shape, "cpu").to(device)

    int8_ef = CommConfig(scheme="int8")
    churn = ElasticConfig(period=4, drop_frac=0.25, seed=1)
    per_leaf, topo_sum = {}, dict(NO_LAUNCHES)
    runs = (  # (label, packed, comm, topology, learners, launches a device)
        ("dense per-leaf", False, "dense", None, 2,
         dict(block_momentum=2 * n_leaves, sgd_apply=8 * n_leaves)),
        ("dense packed", True, "dense", None, 2,
         dict(fused_momentum_broadcast=2, sgd_apply=8)),
        ("int8+EF packed", True, "int8", None, 2,
         dict(fused_momentum_broadcast=2, sgd_apply=8, pack_update=2)),
        ("int8+EF per-leaf", False, "int8", None, 2,
         dict(block_momentum=2 * n_leaves, sgd_apply=8 * n_leaves,
              quantize=2 * n_leaves, dequantize=2 * n_leaves)),
        ("int8_topk+EF packed", True, "int8_topk", None, 2,
         dict(fused_momentum_broadcast=2, sgd_apply=8, quantize=2,
              dequantize=2)),
        ("gossip ring dense per-leaf", False, "dense",
         TopologyConfig(kind="gossip", graph="ring"), 4,
         dict(block_momentum=2 * n_leaves, sgd_apply=16 * n_leaves,
              neighbor_mix=2 * n_leaves)),
        ("gossip ring dense packed", True, "dense",
         TopologyConfig(kind="gossip", graph="ring"), 4,
         dict(block_momentum=2, sgd_apply=16, neighbor_mix=2)),
        ("gossip exponential int8 packed", True,
         CommConfig(scheme="int8", error_feedback=False),
         TopologyConfig(kind="gossip", graph="exponential"), 4,
         dict(block_momentum=2, sgd_apply=16, neighbor_mix=2,
              pack_compress=2)),
        # one of four learners absent per step: 3 x K local steps
        ("gossip one_peer int8+EF elastic packed", True, int8_ef,
         TopologyConfig(kind="gossip", graph="one_peer_exponential",
                        momentum_tracking=True, elastic=churn), 4,
         dict(block_momentum=2, sgd_apply=12, neighbor_mix=4,
              pack_compress=2)),
        ("hierarchical elastic int8+EF inner packed", True, "dense",
         TopologyConfig(kind="hierarchical", groups=2, outer_every=2,
                        outer_momentum=0.3, inner_comm=int8_ef,
                        elastic=churn), 4,
         dict(block_momentum=2, sgd_apply=12, pack_compress=4,
              fused_momentum_broadcast=1)),
    )
    for label, packed, comm, topo, n, launches in runs:
        comm = CommConfig(scheme=comm) if isinstance(comm, str) else comm
        mcfg = MAvgConfig(algorithm="mavg", num_learners=n, k_steps=2,
                          learner_lr=0.1, momentum=0.7, packed=packed,
                          comm=comm,
                          topology=topo or TopologyConfig(kind="flat"))
        schemes = {c.scheme for c in (comm, mcfg.topology.inner_comm,
                                      mcfg.topology.outer_comm) if c}
        compressed = schemes != {"dense"}
        finals = {}
        with Spread(ops) as spread:
            for device in ("cpu", "cuda"):
                topology = make_topology(mcfg, dither=shared_dither)
                state = init_state(tree_map(lambda x: x.to(device), params),
                                   mcfg, topology=topology)
                step = make_meta_step(loss_fn, mcfg, topology=topology)
                ops.reset_launch_counts()
                for b in batches[n]:
                    state, _ = step(state,
                                    tree_map(lambda x: x.to(device), b))
                counts = ops.launch_counts()
                planes = [state.global_params, state.comm_residual] + [
                    v for k, v in sorted((state.topo or {}).items())
                    if k != "membership"]
                finals[device] = [x.cpu() for t in planes if t is not None
                                  for x in tree_leaves(t)]
        want = dict(NO_LAUNCHES, **launches)
        assert counts == want, (label, counts, want)
        if not packed and topo is None:
            per_leaf = dict(per_leaf, **{k: v for k, v in counts.items()
                                         if v})
        if topo is not None:
            topo_sum = {k: v + counts[k] for k, v in topo_sum.items()}
        pairs = list(zip(finals["cpu"], finals["cuda"]))
        if not compressed:
            worst = 0.0
            for c, g in pairs:
                torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-6)
                worst = max(worst, float((g - c).abs().max()))
            print(f"  {label}: card == CPU to rtol=1e-5, atol=1e-6 (max "
                  f"|diff| {worst:.3e}); launches {counts}")
            continue
        quantum = spread.value / 127
        # a top-k selection flip moves one kept value (at most the
        # largest displacement) between the wire and the residual
        limit = FLIP_QUANTA * quantum + (
            spread.value if any("topk" in x for x in schemes) else 0)
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
        print(f"  {label}: card vs CPU over {total} values (meta params, "
              f"topology planes, residual): {differ / total:.4%} not "
              f"bitwise equal, {off / total:.4%} beyond rtol=1e-5/atol=1e-6 "
              f"(limit {FLIP_SHARE:.1%}); max |diff| {worst:.3e} = "
              f"{worst / quantum:.3f} quanta (quantum {quantum:.3e}, limit "
              f"{limit / quantum:.1f}); launches {counts}")
    return per_leaf, topo_sum


# the robust configuration of phases 6 and 9: trimmed mean (trim 1), the
# norm clip at 3x the trailing median of a 2-step ring, anomaly scores
ROBUST = dict(estimator="trimmed", trim=1, clip_mult=3.0, clip_window=2,
              score=True)


def sticky_chaos(steps: int, scale_from: int):
    """The robust bench's sticky corruption of learner L-1: bit 29 of one
    element flipped on every step, and its plane scaled x12 from step
    ``scale_from`` on (benchmarks/robust_bench.py:57-82). Both finite."""
    from repro_torch.chaos import ChaosConfig, FaultSpec

    return ChaosConfig(seed=0, horizon=steps, faults=(
        FaultSpec("finite_bitflip", step=0, learner=L - 1, duration=steps,
                  bit=29, sticky=True),
        FaultSpec("finite_scale", step=scale_from, learner=L - 1,
                  duration=steps - scale_from, magnitude=12.0,
                  sticky=True)))


def robust_card_vs_cpu(torch, ops) -> dict:
    """Phase 6, robust: qwen3-1.7b.reduced() in f32, L=4, K=2, 3 meta
    steps on the same CPU-drawn dither, card against CPU: flat dense
    packed and per-leaf with ROBUST and the finite guard under the sticky
    corruption (x12 on all three steps), hierarchical G=2 (estimator
    mean: a group of 2 cannot trim) and gossip ring with the clip and
    scores (x12 on the clip step only: before the ring fills nothing
    clips, and a mean-based level would spread the scaled plane to every
    learner). Then the inert config against robust=None, bitwise on the
    card. Returns the card's launches summed over the runs."""
    from repro_torch.chaos import FaultSchedule, PayloadCorruptor
    from repro_torch.comm import seeded_dither
    from repro_torch.configs.base import (
        MAvgConfig,
        RobustConfig,
        TopologyConfig,
        get_config,
    )
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.topology import make_topology
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = api.init_params(gen, cfg, "cpu")
    steps = 3
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (L, 2, 2, 16), generator=gen)
        for _ in range(steps))]
    loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731
    n_leaves = len(tree_leaves(params))
    cpu_dither = seeded_dither(7)

    def shared_dither(i, step, shape, device):
        return cpu_dither(i, step, shape, "cpu").to(device)

    def run(mcfg, device, chaos):
        topology = make_topology(mcfg, dither=shared_dither)
        state = init_state(tree_map(lambda x: x.to(device), params), mcfg,
                           topology=topology)
        cor = (None if chaos is None else
               PayloadCorruptor(FaultSchedule(chaos, mcfg.num_learners)))
        step = make_meta_step(loss_fn, mcfg, topology=topology, chaos=cor)
        ops.reset_launch_counts()
        metrics = []
        for b in batches:
            state, m = step(state, tree_map(lambda x: x.to(device), b))
            metrics.append({k: float(v) for k, v in m.items()})
        planes = [state.global_params, state.momentum, state.learners] + [
            v for k, v in sorted((state.topo or {}).items())
            if k != "membership"]
        return ([x.cpu() for t in planes if t is not None
                 for x in tree_leaves(t)], metrics, ops.launch_counts())

    hier = TopologyConfig(kind="hierarchical", groups=2)
    gossip = TopologyConfig(kind="gossip", graph="ring")
    runs = (  # (label, packed, topology, robust, guard, x12 from, launches)
        ("flat dense packed", True, None, ROBUST, True, 0,
         dict(fused_momentum_broadcast=3, sgd_apply=24, robust_reduce=3)),
        ("flat dense per-leaf", False, None, ROBUST, True, 0,
         dict(block_momentum=3 * n_leaves, sgd_apply=24 * n_leaves,
              robust_reduce=3 * n_leaves)),
        ("hierarchical G=2", True, hier, dict(ROBUST, estimator="mean"),
         False, 2, dict(block_momentum=3, sgd_apply=24,
                        fused_momentum_broadcast=3)),
        ("gossip ring", True, gossip, ROBUST, False, 2,
         dict(block_momentum=3, sgd_apply=24, neighbor_mix=3)),
    )
    total = dict(NO_LAUNCHES)
    for label, packed, topo, rcfg, guard, scale_from, launches in runs:
        mcfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=2,
                          learner_lr=0.1, momentum=0.7, packed=packed,
                          finite_guard=guard, robust=RobustConfig(**rcfg),
                          topology=topo or TopologyConfig(kind="flat"))
        chaos = sticky_chaos(steps, scale_from)
        cpu, cpu_m, _ = run(mcfg, "cpu", chaos)
        card, card_m, counts = run(mcfg, "cuda", chaos)
        want = dict(NO_LAUNCHES, **launches)
        assert counts == want, (label, counts, want)
        total = {k: v + counts[k] for k, v in total.items()}
        worst = 0.0
        for c, g in zip(cpu, card):
            torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)
            ok = torch.isfinite(c)
            worst = max(worst, float((g[ok] - c[ok]).abs().max())
                        if bool(ok.any()) else 0.0)
            assert bool(ok.all()), label
        clipped = [m["robust_clipped_learners"] for m in card_m]
        assert clipped == [m["robust_clipped_learners"] for m in cpu_m]
        assert clipped == [0.0, 0.0, 1.0], (label, clipped)
        scores = [m[f"robust_score_{j}"] for m in card_m[-1:]
                  for j in range(L)]
        assert max(range(L), key=lambda j: scores[j]) == L - 1, scores
        for m, mc in zip(card_m, cpu_m):
            for k in ("robust_clip_budget", "robust_anomaly_score"):
                torch.testing.assert_close(m[k], mc[k], rtol=1e-4,
                                           atol=1e-6, equal_nan=True)
        print(f"  {label} robust (x12 from step {scale_from}): card == CPU "
              f"to rtol=1e-5, atol=1e-6 (max |diff| {worst:.3e}); clipped "
              f"{clipped}; scores at step 2 "
              f"{[round(x, 3) for x in scores]}; launches {counts}")
    mcfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=2,
                      learner_lr=0.1, momentum=0.7)
    off, _, _ = run(mcfg, "cuda", None)
    inert, _, _ = run(dataclasses.replace(mcfg, robust=RobustConfig(
        estimator="mean", clip_mult=0.0, score=False)), "cuda", None)
    for a, b in zip(off, inert):
        assert torch.equal(a, b)
    print("  inert RobustConfig(mean, no clip, no score) == robust=None on "
          "the card: bitwise")
    return total


def robust_full_width(torch, ops) -> dict:
    """Phase 9: the robust main path at full width, DEPTH layers:
    Qwen3-1.7B, flat dense, L=4, K=4, B=8, S=64, ROBUST with the finite
    guard, learner 3 under the sticky corruption (x12 on steps 1-3), 4
    meta steps through the Trainer: the 2-step ring fills on steps 0-1
    and the clip fires on steps 2 and 3."""
    from repro_torch.configs.base import (
        MAvgConfig,
        RobustConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine
    from repro_torch.robust.aggregator import RobustAggregator

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=DEPTH)
    k, batch, seq, steps = 4, 8, 64, 4
    mcfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=k,
                      finite_guard=True, robust=RobustConfig(**ROBUST))
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=batch,
                       seq_len=seq, meta_steps=steps,
                       chaos=sticky_chaos(steps, 1))
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L, k, batch, seq),
        lr_schedule=warmup_cosine(LR, 5, steps), device="cuda",
    )
    spec = trainer.state.spec
    print(f"  state: {sum(spec.sizes):,} parameters, {spec.rows} rows x 128 "
          f"({spec.plane_bytes() / 1e9:.2f} GB a plane), {L} learners, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    peaks = PhasePeaks(torch, trainer)
    # the records count the clipped learners; to see which, the guard's
    # per-learner clip factors are read as it returns them (it computes
    # them on the host), and the guard is put back before the profile
    factors, guard = [], RobustAggregator.guard

    def read_factors(self, *args, **kw):
        scale, topo, metrics = guard(self, *args, **kw)
        factors.append(scale.tolist())
        return scale, topo, metrics

    RobustAggregator.guard = read_factors
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        history = trainer.run(log=lambda s: print("  " + s))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        RobustAggregator.guard = guard
    peak = peaks.stop()
    print(f"  launches: {counts}")
    assert counts == dict(NO_LAUNCHES, robust_reduce=steps,
                          sgd_apply=steps * k * L,
                          fused_momentum_broadcast=steps), counts
    losses = [h["loss"] for h in history]
    assert all(math.isfinite(x) for x in losses), losses
    rows = trainer.robust_records
    clipped = [rb["clipped_learners"] for rb in rows]
    print(f"  robust_clipped_learners by step {clipped} (clip budget "
          f"{[round(rb['clip_budget'], 4) for rb in rows]})")
    print(f"  clip factors by step and learner {factors}")
    # the clip fires once the ring is full, and only on the corrupt learner
    assert clipped == [0.0, 0.0, 1.0, 1.0], clipped
    assert len(factors) == steps, factors
    assert all(f == [1.0] * L for f in factors[:2]), factors
    assert all(f[:L - 1] == [1.0] * (L - 1) and f[L - 1] < 1.0
               for f in factors[2:]), factors
    for rb in rows:
        print(f"  step {rb['meta_step']} anomaly scores "
              f"{[f'{x:.4g}' for x in rb['scores']]}")
    assert all(max(range(L), key=lambda j: rb["scores"][j]) == L - 1
               for rb in rows[1:]), rows
    print("  nonfinite_learners by step "
          f"{[h['nonfinite_learners'] for h in history]}")
    state = trainer.state
    for name in ("global_params", "momentum", "learners"):
        # in row windows: torch.isfinite forms |x| over its whole input
        x = getattr(state, name).view(-1, 128)
        assert all(bool(torch.isfinite(x[sl]).all())
                   for sl in windows(x.shape[0])), name
    print("  global params, momentum and learner planes all finite; "
          f"losses {[round(x, 4) for x in losses]}")
    last = history[-1]
    print(f"  peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB); {steps} meta steps in {seconds:.2f} s "
          f"({steps / seconds:.3f} meta steps/s; last step alone "
          f"{last['meta_steps_per_sec']:.3f} meta steps/s, "
          f"{last['samples_per_sec']:.1f} samples/s)")
    print("  peak device memory by part: " + ", ".join(
        f"{name} {v / 1e9:.2f} GB" for name, v in peaks.parts))
    assert peak < 80e9, peak
    profile_meta_step(torch, trainer, 1e3 / last["meta_steps_per_sec"])
    del trainer, state
    free(torch)
    return counts


# ---------------------------------------------------------------------------
# phase 10: serving (prefill through the flash kernel, KV-cache decode)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 512, 64
# bf16 compute at full depth, two routes to the same logits (flash vs the
# plain softmax, or batched forward vs one-token decode): a relative RMS
# error of at most 5 % and no logit further than a quarter of the largest
# |logit|; a wrong cache row or position gives logits unrelated to the
# reference, a relative RMS error near 1.4
BF16_RMS, BF16_MAX = 0.05, 0.25


def bf16_close(torch, label, got, want, hold: bool = True) -> None:
    """Prints the relative RMS error and max |diff|; with ``hold``, asserts
    them within the bf16 serving limits."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    rms = float((got - want).norm() / want.norm())
    mx = float((got - want).abs().max())
    top = float(want.abs().max())
    print(f"  {label}: relative RMS error {rms:.3e}, max |diff| {mx:.4f} "
          f"(largest |logit| {top:.3f}; limits {BF16_RMS}, "
          f"{BF16_MAX} x {top:.3f})")
    assert not hold or (rms <= BF16_RMS and mx <= BF16_MAX * top), label


def serving_card_vs_cpu(torch, ops) -> int:
    """Phase 10a: reduced Qwen3 (qk-norm, n_rep 2) and Qwen2 (QKV bias,
    n_rep 4) in f32, the same params and prompt on both devices: prefill
    through the f32 flash kernel (its plain version on the CPU), 8 decode
    steps, greedy generate. Returns the f32 flash kernel's launches in the
    two prefills."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_map

    tol = dict(rtol=1e-5, atol=1e-5)
    launches = 0
    for arch in ("qwen3-1.7b", "qwen2-7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        gparams = tree_map(lambda t: t.to("cuda"), params)
        toks = torch.randint(0, cfg.vocab_size, (4, 16),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        errs = []
        with torch.no_grad():
            ops.reset_launch_counts()
            lg, cg = api.prefill(gparams, cfg, {"tokens": toks.cuda()}, 32,
                                 use_pallas=True)
            torch.cuda.synchronize()
            assert ops.launch_counts() == dict(
                NO_LAUNCHES, flash_attention_f32=cfg.num_layers)
            launches += cfg.num_layers
            lc, cc = api.prefill(params, cfg, {"tokens": toks}, 32,
                                 use_pallas=True)
            for g, c in ((lg, lc), (cg["k"], cc["k"]), (cg["v"], cc["v"])):
                torch.testing.assert_close(g.cpu(), c, **tol)
                errs.append(float((g.cpu() - c).abs().max()))
            assert int(cg["pos"]) == int(cc["pos"]) == 16
            nxt = torch.argmax(lc, -1).to(torch.int32)
            for _ in range(8):
                lg, cg = api.decode_step(gparams, cfg, cg, nxt.cuda())
                lc, cc = api.decode_step(params, cfg, cc, nxt)
                torch.testing.assert_close(lg.cpu(), lc, **tol)
                errs.append(float((lg.cpu() - lc).abs().max()))
                nxt = torch.argmax(lc, -1).to(torch.int32)
            got = serve.generate(gparams, cfg, toks.cuda(), 8, 32,
                                 use_pallas=True)
            want = serve.generate(params, cfg, toks, 8, 32, use_pallas=True)
        assert torch.equal(got.cpu(), want), (got, want)
        print(f"  {arch} reduced f32: prefill (flash) logits and cache, 8 "
              f"decode steps' logits card == CPU within rtol 1e-5 / atol "
              f"1e-5 (max |diff| {max(errs):.3g}); greedy generate equal "
              f"({want[0].tolist()})")
    return launches


# name prefixes of profiler ranges: the port's obs.* spans and this
# script's own smoke.* ranges
RANGES = ("obs.", "smoke.")


def profile_call(torch, label, fn, wall_ms: float, focus=None,
                 ops_by_shape=()) -> None:
    """One call of ``fn`` under torch.profiler: kernel time by class and by
    name, and the device's idle share against ``wall_ms``, the wall time
    of the same call unprofiled (the profiler slows the host), and with
    ``focus`` the share of the kernels whose names hold it. Reports "not
    measured" if the profiler saw no device time. ``ops_by_shape`` names
    ATen ops (``aten::bmm``) whose device time is printed by input shape,
    so that one op's calls at one site are told apart from its others."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(ops_by_shape)) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    # the obs.* and smoke.* ranges also appear as device spans; they are
    # not kernels
    kernels = sorted((e for e in on_device
                      if not e.key.startswith(RANGES)),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print(f"  profiled {label}: wall {prof_ms:.1f} ms; device time "
              f"not measured (the profiler saw no device activity)")
        return
    print(f"  profiled {label}: kernels busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} launches (profiled wall "
          f"{prof_ms:.1f} ms); unprofiled {wall_ms:.1f} ms -> device "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    for e in on_device:
        if e.key.startswith(RANGES):
            print(f"    {e.key} device span {e.device_time_total / 1e3:.1f} ms "
                  f"({e.device_time_total / 1e3 / wall_ms:.3f} of the "
                  f"unprofiled call)")
    for e in events:
        if e.key.startswith("smoke.") and e.cpu_time_total > 0:
            print(f"    {e.key} host time {e.cpu_time_total / 1e3:.1f} ms "
                  f"in {e.count} calls ({e.cpu_time_total / 1e3 / prof_ms:.3f}"
                  f" of the profiled call)")
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
    if focus is not None:
        hit = [e for e in kernels if focus in e.key]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        print(f"    {focus}: {ms:.2f} ms in {sum(e.count for e in hit)} "
              f"launches, {ms / busy_ms:.3f} of kernel time, "
              f"{ms / wall_ms:.3f} of the unprofiled call")
    if not ops_by_shape:  # a second pass over the events costs minutes
        return
    shaped = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                     if e.key in ops_by_shape and e.device_time_total > 0),
                    key=lambda e: -e.device_time_total)
    for e in shaped:
        ms = e.device_time_total / 1e3
        print(f"    op {e.key} {e.input_shapes}: {ms:.2f} ms in {e.count} "
              f"calls ({ms / busy_ms:.3f} of kernel time)")


class RouteLog:
    """While on, keeps each MoE routing call's slot experts
    (``models/moe.py::_route``; a reference, no extra work on the card),
    so that two runs' expert choices can be compared token by token. With
    ``pinned`` (a run's kept calls) the experts of call i are those of
    ``pinned[i]``, their gates and capacity from this run's own router
    (``moe._assign``): the second run follows the first's discrete
    choices, so the two differ only by the arithmetic compared."""

    def __init__(self, pinned=None):
        from repro_torch.models import moe

        self.moe, self.real, self.calls = moe, moe._route, []
        self.pinned = pinned

    def __enter__(self):
        import torch

        real, moe = self.real, self.moe

        def route(xt, p, cfg, dropless=False):
            if self.pinned is None:
                out = real(xt, p, cfg, dropless)
            else:
                logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
                out = moe._assign(torch.softmax(logits, dim=-1),
                                  self.pinned[len(self.calls)], cfg,
                                  dropless)
            self.calls.append(out[1].view(xt.shape[0], -1))
            return out

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def print_flips(torch, label, calls_a, calls_b) -> None:
    """The share of (token, MoE layer) pairs, and of tokens, whose expert
    sets differ between two runs' routing calls."""
    flips = torch.stack([(a.sort(-1).values != b.sort(-1).values).any(-1)
                         for a, b in zip(calls_a, calls_b)])
    print(f"  expert sets differing, {label}: "
          f"{float(flips.float().mean()):.4f} of token-layers, "
          f"{float(flips.any(0).float().mean()):.4f} of tokens")


class FlashVsPlain:
    """While on, each ``ops.flash_attention`` call is also computed by the
    plain attention (``layers.full_attention``) on the same q, k and v:
    the kernel held on the main path's own inputs, layer by layer, with no
    earlier layer's rounding (or an MoE router's choice) in between."""

    def __init__(self, ops):
        self.ops, self.real, self.errs = ops, ops.flash_attention, []

    def __enter__(self):
        from repro_torch.models import layers

        real = self.real

        def flash(q, k, v, **kw):
            out = real(q, k, v, **kw)
            plain = layers.full_attention(
                q, k, v, causal=kw.get("causal", True),
                sliding_window=kw.get("sliding_window", 0)).float()
            d = out.float() - plain
            self.errs.append((float(d.norm() / plain.norm()),
                              float(d.abs().max()),
                              float(plain.abs().max())))
            return out

        self.ops.flash_attention = flash
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def serving_full_width(torch, ops, arch="qwen3-1.7b",
                       ops_by_shape=()) -> dict:
    """Phase 10b (and 16b with ``arch``): the full-width, full-depth model
    (28 layers), f32 params from a seeded generator, bf16 compute, batch
    8, a 512-token prompt of uniform random tokens, 64 greedy tokens
    through ``generate`` with the flash kernel in prefill, cache_len 512 +
    64 + 8. Checked: exactly one flash launch a layer, finite logits,
    prefill with and without the kernel within the bf16 limit, teacher
    forcing (one forward over prompt and generated tokens against the
    decode logits), peak < 80 GB. Returns the launch counts of the
    generate run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch)
    B, S0, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    cache_len = S0 + new + 8
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    prompt = torch.randint(
        0, cfg.vocab_size, (B, S0), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": prompt}
    print(f"  params {sum(t.numel() for t in tree_leaves(params)):,}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB f32, "
          f"{cfg.num_layers} layers, compute {cfg.dtype}")
    moe = cfg.num_experts > 0
    with torch.no_grad():
        # warm-up, and the prefill logits with and without the kernel. The
        # kernel is also held layer by layer on its own inputs. Under MoE
        # routing, the bf16 rounding that differs between the two
        # attentions flips near-tied expert choices, and a flip changes a
        # token's output as much as a wrong kernel would: the plain run is
        # held pinned to the flash run's experts, and its unpinned run's
        # flips and logits are printed
        with FlashVsPlain(ops) as check, RouteLog() as flash_routes:
            flash_logits, _ = api.prefill(params, cfg, batch, cache_len,
                                          use_pallas=True)
        rms, mx = max(e[0] for e in check.errs), max(e[1] for e in check.errs)
        print(f"  flash vs plain attention on each layer's own inputs "
              f"({len(check.errs)} layers): relative RMS error up to "
              f"{rms:.3e}, max |diff| up to {mx:.4f}")
        assert len(check.errs) == cfg.num_layers
        assert all(r <= BF16_RMS and m <= BF16_MAX * top
                   for r, m, top in check.errs), check.errs
        label = "prefill logits, flash vs plain attention"
        if moe:
            with RouteLog() as plain_routes:
                plain_logits, _ = api.prefill(params, cfg, batch, cache_len)
            print_flips(torch, "flash vs plain prefill", flash_routes.calls,
                        plain_routes.calls)
            bf16_close(torch, f"{label}, unpinned (not held)", flash_logits,
                       plain_logits, hold=False)
            label += ", the plain run pinned to the flash run's experts"
        with RouteLog(flash_routes.calls if moe else None):
            plain_logits, _ = api.prefill(params, cfg, batch, cache_len)
        bf16_close(torch, label, flash_logits, plain_logits)
        del plain_logits, flash_routes
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = serve.generate(params, cfg, prompt, new, cache_len,
                                use_pallas=True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  launches: {counts}")
        assert counts == dict(NO_LAUNCHES, flash_attention=cfg.num_layers)
        assert tokens.shape == (B, new) and tokens.dtype == torch.int32

        prefill_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits0, cache = api.prefill(params, cfg, batch, cache_len,
                                         use_pallas=True)
            torch.cuda.synchronize()
            prefill_times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms = statistics.median(prefill_times)
        # teacher forcing: prefill, then decode the generated tokens again,
        # timed, their MoE routing kept
        with RouteLog() as replay_routes:
            logits0, cache = api.prefill(params, cfg, batch, cache_len,
                                         use_pallas=True)
            torch.cuda.synchronize()
            decoded = []
            t0 = time.perf_counter()
            for i in range(new):
                logits, cache = api.decode_step(params, cfg, cache,
                                                tokens[:, i])
                decoded.append(logits)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        step_ms = decode_s / new * 1e3
        served = torch.cat([logits0[:, None], torch.stack(decoded, 1)], 1)
        del decoded
        assert bool(torch.isfinite(served).all()), "non-finite logits"
        # the replay is the same computation: the same greedy tokens
        assert torch.equal(torch.argmax(served[:, :-1], -1).to(torch.int32),
                           tokens)
        print(f"  {served.numel()} logits of prefill and {new} decode "
              f"steps finite; the replay's greedy tokens equal generate's")
        full = torch.cat([prompt, tokens], 1)
        label = (f"teacher forcing, forward over {S0 + new} tokens vs "
                 f"prefill + {new} decode steps")
        want = lambda fwd: fwd[:, S0 - 1:]  # noqa: E731
        pinned = None
        if moe:
            # the replay's experts token by token: the prefill's S0
            # tokens, then decode step i's token at S0 + i
            calls, n_moe = replay_routes.calls, len(replay_routes.calls) // (
                1 + new)
            pinned = [torch.cat([calls[layer].view(B, S0, -1)] + [
                calls[n_moe * (1 + i) + layer].view(B, 1, -1)
                for i in range(new)], 1).flatten(0, 1)
                for layer in range(n_moe)]
            with RouteLog() as fwd_routes:
                fwd, _ = api.forward(params, cfg, {"tokens": full})
            print_flips(torch, "forward vs prefill + decode", pinned,
                        fwd_routes.calls)
            bf16_close(torch, f"{label}, unpinned (not held)", served,
                       want(fwd), hold=False)
            del fwd, fwd_routes
            free(torch)
            label += ", the forward pinned to the replay's experts"
        with RouteLog(pinned):
            fwd, _ = api.forward(params, cfg, {"tokens": full})
        bf16_close(torch, label, served, want(fwd))
        del fwd, served, pinned, replay_routes
        free(torch)
        print(f"  prefill {prefill_ms:.1f} ms ({B * S0 / prefill_ms * 1e3:.0f}"
              f" prompt tokens/s); decode {step_ms:.2f} ms a step, "
              f"{1e3 / step_ms:.2f} steps/s, {B * 1e3 / step_ms:.1f} "
              f"tokens/s; generate {gen_s:.2f} s "
              f"({B * new / gen_s:.1f} tokens/s); peak device memory "
              f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)")
        assert peak < 80e9, peak
        _, cache = api.prefill(params, cfg, batch, cache_len,
                               use_pallas=True)
        tok = tokens[:, 0]
        profile_call(torch, "decode step",
                     lambda: api.decode_step(params, cfg, cache, tok),
                     step_ms, ops_by_shape=ops_by_shape)
        profile_call(torch, "prefill (flash)",
                     lambda: api.prefill(params, cfg, batch, cache_len,
                                         use_pallas=True), prefill_ms,
                     ops_by_shape=ops_by_shape)
    del params, cache
    free(torch)
    return counts


# f32 compute at full depth, flash vs plain attention in the prefill: the
# kernel's 3xTF32 products against cuBLAS's f32 ones (TF32 off), the same
# function in another summation order; a relative RMS error of the logits
# of at most 1e-4 (PERF.md section 2)
F32_RMS = 1e-4


def serving_full_width_f32(torch, ops) -> dict:
    """Phase 10c: phase 10b's model and request in f32 compute: full-width,
    full-depth Qwen3-1.7B (``dtype="float32"``), params from a seeded
    generator on the card, B=8, a 512-token prompt, TF32 off for cuBLAS.
    Checked: one prefill launches the f32 flash kernel exactly 28 times and
    nothing else of the port, finite logits, flash vs plain-attention
    prefill logits within F32_RMS, 64 greedy tokens through ``generate``
    (28 launches). Timed: the median of 3 prefills, the peak device
    memory of the generate run, one prefill profiled (the flash kernel's
    share, the idle share). Returns the launch counts of one prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="float32")
    B, S0, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    cache_len = S0 + new + 8
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    prompt = torch.randint(
        0, cfg.vocab_size, (B, S0), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": prompt}
    print(f"  params {sum(t.numel() for t in tree_leaves(params)):,}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB f32, "
          f"{cfg.num_layers} layers, compute {cfg.dtype}")
    with torch.no_grad(), full_f32(torch):
        plain_logits, _ = api.prefill(params, cfg, batch, cache_len)
        ops.reset_launch_counts()
        flash_logits, _ = api.prefill(params, cfg, batch, cache_len,
                                      use_pallas=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"  one prefill's launches: {counts}")
        assert counts == dict(NO_LAUNCHES,
                              flash_attention_f32=cfg.num_layers), counts
        assert bool(torch.isfinite(flash_logits).all()), "non-finite logits"
        rms = float((flash_logits - plain_logits).norm()
                    / plain_logits.norm())
        mx = float((flash_logits - plain_logits).abs().max())
        print(f"  prefill logits, flash vs plain attention: relative RMS "
              f"error {rms:.3e} (limit {F32_RMS}), max |diff| {mx:.3e} "
              f"(largest |logit| {float(plain_logits.abs().max()):.3f})")
        assert rms <= F32_RMS, rms
        del plain_logits, flash_logits
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = serve.generate(params, cfg, prompt, new, cache_len,
                                use_pallas=True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert gen_counts == dict(NO_LAUNCHES,
                                  flash_attention_f32=cfg.num_layers)
        assert tokens.shape == (B, new) and tokens.dtype == torch.int32
        prefill_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, cfg, batch, cache_len, use_pallas=True)
            torch.cuda.synchronize()
            prefill_times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms = statistics.median(prefill_times)
        print(f"  prefill {prefill_ms:.1f} ms ({B * S0 / prefill_ms * 1e3:.0f}"
              f" prompt tokens/s; runs {[round(t, 1) for t in prefill_times]})"
              f"; generate {new} tokens {gen_s:.2f} s ({B * new / gen_s:.1f} "
              f"tokens/s); peak device memory {peak / 1e9:.2f} GB "
              f"({peak / 2**30:.2f} GiB)")
        assert peak < 80e9, peak
        profile_call(torch, "prefill (f32 flash)",
                     lambda: api.prefill(params, cfg, batch, cache_len,
                                         use_pallas=True), prefill_ms,
                     focus="flash_hopper_f32_kernel")
    del params
    free(torch)
    return counts


# ---------------------------------------------------------------------------
# phase 11: E1, the paper's acceptance, on the card
# ---------------------------------------------------------------------------

E1_TOL = dict(rtol=1e-5, atol=1e-6)


def cnn_card_vs_cpu(torch, ops, packed: bool) -> dict:
    """E1's CNN (hw=12), M-AVG, L=4, K=4, B=8, 2 meta steps on the card
    and on the CPU from the same params and CPU-drawn batches, TF32 off;
    per-step losses and every plane within E1_TOL. Returns the card run's
    launch counts."""
    from repro_torch.benchmarks.convergence import CNN_HW as hw
    from repro_torch.configs.base import MAvgConfig
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.data import classif_batch_fn
    from repro_torch.models.simple import cnn_init, cnn_loss
    from repro_torch.utils.tree import tree_leaves, tree_map

    P, K, B = 4, 4, 8
    params = cnn_init(torch.Generator().manual_seed(0), hw=hw, device="cpu")
    bf = classif_batch_fn(hw * hw * 3, 10, P, K, B, device="cpu")
    batches = []
    for i in range(2):
        b = bf(torch.Generator().manual_seed(1 + i), i)
        batches.append({"x": b["x"].reshape(P, K, B, hw, hw, 3),
                        "y": b["y"]})
    cfg = MAvgConfig(algorithm="mavg", num_learners=P, k_steps=K,
                     learner_lr=0.1, momentum=0.7, packed=packed)
    runs = {}
    for dev in ("cpu", "cuda"):
        state = init_state(tree_map(lambda x: x.to(dev), params), cfg)
        step = make_meta_step(cnn_loss, cfg)
        ops.reset_launch_counts()
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        runs[dev] = (losses, state, ops.launch_counts())
    (cl, cs, cc), (gl, gs, gc) = runs["cpu"], runs["cuda"]
    assert sum(cc.values()) == 0, cc
    torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl), **E1_TOL)
    worst = 0.0
    for field in ("global_params", "momentum", "learners"):
        for a, b in zip(tree_leaves(getattr(gs, field)),
                        tree_leaves(getattr(cs, field))):
            torch.testing.assert_close(a.cpu(), b, **E1_TOL)
            worst = max(worst, float((a.cpu() - b).abs().max()))
    n_leaves = len(tree_leaves(params))
    want = (dict(NO_LAUNCHES, fused_momentum_broadcast=2, sgd_apply=2 * K * P)
            if packed else
            dict(NO_LAUNCHES, block_momentum=2 * n_leaves,
                 sgd_apply=2 * K * P * n_leaves))
    assert gc == want, (gc, want)
    print(f"  CNN {'packed' if packed else 'per-leaf'}: losses card "
          f"{[round(x, 6) for x in gl]} cpu {[round(x, 6) for x in cl]}; "
          f"max |card - cpu| over the planes {worst:.3e} (limit rtol 1e-5, "
          f"atol 1e-6); card launches "
          f"{ {k: v for k, v in gc.items() if v} }")
    return gc


def e1_on_the_card(torch, ops) -> dict:
    """Phase 11. The CNN card vs CPU (packed and per-leaf), then
    ``convergence.main(quick=True, device="cuda")``, counted. Returns the
    launch counts summed over the phase."""
    from repro_torch.benchmarks import convergence

    total = dict(NO_LAUNCHES)
    with full_f32(torch):
        for packed in (True, False):
            for k, v in cnn_card_vs_cpu(torch, ops, packed).items():
                total[k] += v
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows, summaries = convergence.main(
        quick=True, device="cuda", log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  E1 quick on the card in {seconds:.2f} s; launches {counts}")
    # every arm runs packed flat M-AVG / K-AVG: one fused meta update a
    # meta step and one SGD apply a local step of a learner
    meta = sum(kw["steps"] for _, _, kw, _ in convergence.cases(True)) * 2
    local = sum(kw["steps"] * kw["P"] * kw["K"]
                for _, _, kw, _ in convergence.cases(True)) * 2
    assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=meta,
                          sgd_apply=local), counts
    for r in rows:
        assert math.isfinite(r[3]) and math.isfinite(r[4]), r
    for s in summaries:
        print(f"  E1 {s['model']}: samples to {s['target']}: K-AVG "
              f"{s['k_stt']}, M-AVG {s['m_stt']}, speedup "
              f"{s['speedup']}, reached K-AVG {s['kavg_reached']} M-AVG "
              f"{s['mavg_reached']}, asserted {s['asserted']}")
    for k, v in counts.items():
        total[k] += v
    return total


# ---------------------------------------------------------------------------
# phase 12: the checkpoint at full width
# ---------------------------------------------------------------------------

CKPT_L, CKPT_STEPS = 2, 2


def checkpoint_full_width(torch, ops) -> dict:
    """Phase 12. Qwen3-1.7B, every width unchanged, depth cut to CKPT_DEPTH
    layers, flat dense M-AVG, L=2, K=4, B=8, S=64, 2 meta steps; then save,
    verify, restore in place into a fresh Trainer (bitwise, no second
    state on the card), one more step from both, and the corrupt and torn
    save faults (on the reduced model's state). Returns the training run's
    launch counts."""
    import tempfile

    from repro_torch.checkpoint import (
        CheckpointVerifyError,
        latest_verified_checkpoint,
        save_state,
        verify_checkpoint,
    )
    from repro_torch.checkpoint.npz import (
        CRC_SUFFIX,
        _entries,
        _entry_crc,
        _host,
    )
    from repro_torch.configs.base import MAvgConfig, TrainConfig, get_config
    from repro_torch.core.meta import init_state
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine
    from repro_torch.utils.rng import seeded_generator

    full = get_config("qwen3-1.7b")
    cfg = dataclasses.replace(full, num_layers=CKPT_DEPTH)
    k, batch, seq = 4, 8, 64
    print(f"  config: {full.name} widths unchanged, depth cut "
          f"{full.num_layers} -> {cfg.num_layers} layers; flat dense M-AVG, "
          f"L={CKPT_L}, K={k}, B={batch}, S={seq}")
    tcfg = TrainConfig(
        model=cfg, mavg=MAvgConfig(algorithm="mavg", num_learners=CKPT_L,
                                   k_steps=k),
        batch_per_learner=batch, seq_len=seq, meta_steps=CKPT_STEPS)

    def trainer():
        return Trainer(
            tcfg, lambda p, b: api.loss_fn(p, cfg, b),
            init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
            batch_fn=uniform_batch_fn(cfg, CKPT_L, k, batch, seq),
            lr_schedule=warmup_cosine(LR, 5, CKPT_STEPS + 1), device="cuda",
        )

    def planes(state):
        return [(key, x) for key, x in _entries(state)
                if isinstance(x, torch.Tensor)]

    live = trainer()
    spec = live.state.spec
    ops.reset_launch_counts()
    live.run(log=lambda s: print("  " + s))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=CKPT_STEPS,
                          sgd_apply=CKPT_STEPS * k * CKPT_L), counts
    state_bytes = sum(x.numel() * x.element_size()
                      for _, x in planes(live.state))
    print(f"  state: {spec.rows} rows x 128, {len(planes(live.state))} "
          f"entries, {state_bytes / 1e9:.2f} GB; launches "
          f"{ {key: v for key, v in counts.items() if v} }")
    work = Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        path = save_state(str(work), live.state, CKPT_STEPS)
        save_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        t0 = time.perf_counter()
        verify_checkpoint(path)
        verify_s = time.perf_counter() - t0

        resumed = trainer()
        before = planes(resumed.state)
        assert not torch.equal(before[0][1], planes(live.state)[0][1])
        ptrs = [x.data_ptr() for _, x in before]
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resumed.restore(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        alloc1 = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        assert [x.data_ptr() for _, x in planes(resumed.state)] == ptrs
        assert peak - alloc0 < 64 << 20, (alloc0, alloc1, peak)
        assert resumed.state.step == live.state.step == CKPT_STEPS
        for (key, a), (_, b) in zip(planes(live.state),
                                    planes(resumed.state)):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        print(f"  save {save_s:.2f} s ({nbytes / 1e9:.3f} GB on disk, "
              f"{nbytes / 1e9 / save_s:.3f} GB/s); verify {verify_s:.2f} s "
              f"({nbytes / 1e9 / verify_s:.3f} GB/s); load {load_s:.2f} s "
              f"({nbytes / 1e9 / load_s:.3f} GB/s)")
        # where a save's time goes: the device-to-host copies, and one
        # CRC32 pass (the sidecar's; zipfile makes a second one)
        t0 = time.perf_counter()
        host = [_host(key, x)[0] for key, x in _entries(live.state)]
        d2h_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for arr in host:
            _entry_crc(arr)
        crc_s = time.perf_counter() - t0
        del host
        print(f"  of a save: device-to-host copies {d2h_s:.2f} s "
              f"({state_bytes / 1e9 / d2h_s:.3f} GB/s), one CRC32 pass "
              f"{crc_s:.2f} s ({state_bytes / 1e9 / crc_s:.3f} GB/s)")
        print(f"  restore in place: device memory allocated {alloc0 / 1e9:.3f} "
              f"GB before, {alloc1 / 1e9:.3f} GB after, peak during the load "
              f"{peak / 1e9:.3f} GB; every plane bitwise equal to the saved "
              f"state")
        a = live.run(1, log=None)[-1]["loss"]
        b = resumed.run(1, log=None)[-1]["loss"]
        assert math.isclose(a, b, rel_tol=1e-5), (a, b)
        print(f"  one more step: uninterrupted loss {a:.6f}, resumed "
              f"{b:.6f} (|rel diff| {abs(a - b) / abs(a):.2e}, limit 1e-5)")
        del resumed
        free(torch)

        # the save faults on the reduced model's state, in a directory of
        # their own: the writer and the verifier do not depend on the
        # state's size, and at full width the faults wrote and read ~20 GB
        # more on the host (~45 s)
        faults = work / "faults"
        small = init_state(api.init_params(
            seeded_generator("cuda", 12, 0), full.reduced(), "cuda"),
            MAvgConfig(algorithm="mavg", num_learners=CKPT_L, k_steps=k))
        good = save_state(str(faults), small, CKPT_STEPS)
        bad = save_state(str(faults), small, CKPT_STEPS + 2, fault="corrupt")
        try:
            verify_checkpoint(bad)
        except CheckpointVerifyError as e:
            print(f"  corrupt save refused: {str(e).split(': ', 1)[1]}")
        else:
            raise AssertionError("a corrupt save passed verify_checkpoint")
        Path(bad).unlink()
        Path(bad + CRC_SUFFIX).unlink()
        torn = save_state(str(faults), small, CKPT_STEPS + 3, fault="torn")
        assert not Path(torn + CRC_SUFFIX).exists()
        got = latest_verified_checkpoint(str(faults))
        assert got == good, (got, good)
        print(f"  torn save ({Path(torn).stat().st_size / 1e6:.3f} MB of the "
              f"reduced model's state, no sidecar) skipped: latest verified "
              f"is {Path(got).name}")
        del small
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del live
    free(torch)
    return counts


# ---------------------------------------------------------------------------
# phase 13: telemetry on the dense main path, attribution, supervised
# recovery
# ---------------------------------------------------------------------------

OBS_STEPS, OBS_MORE = 4, 2
# 13c's depth: every width of Qwen3-1.7B, 1 of its 28 layers. The
# supervised run saves two snapshots (step 3 and the halt's; a third, of
# step 4 after the rollback to 2, until a checkpoint every 2 steps became
# every 3), verifies them and loads one, all on the host at ~0.3 GB/s; at phase 12's
# 6 layers (9.81 GB) the phase took 262 s on the card, at 1 layer the
# state is 5.78 GB; 5 target steps (6, and a fourth snapshot, until the
# whole run neared its time limit)
SUP_DEPTH, SUP_STEPS = 1, 5


def check_telemetry(path: Path) -> str:
    """``tools/check_telemetry.py`` on a run log, as a subprocess; raises
    unless it exits 0."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_telemetry.py"),
         str(path)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.strip()


def telemetry_full_width(torch, ops) -> dict:
    """Phase 13a. Phase 4's configuration (full-width Qwen3-1.7B, flat
    dense M-AVG, L=4, K=4, B=8, S=64) at DEPTH layers with the JSONL
    sink, the spans, the torch profiler and the health watchdogs on,
    log_every=2: OBS_MORE steps with the profiler off, OBS_STEPS profiled
    steps, OBS_MORE more with the profiler off (the unprofiled step time
    before and after a profile), beside OBS_MORE steps of the same
    configuration with telemetry off. Returns the launch counts of the
    profiled run."""
    import tempfile

    from repro_torch.configs.base import (
        MAvgConfig,
        ObsConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=DEPTH)
    k, batch, seq = 4, 8, 64
    mavg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=k)
    # the same configuration with telemetry off, for the step time
    plain = Trainer(
        TrainConfig(model=cfg, mavg=mavg, batch_per_learner=batch,
                    seq_len=seq, meta_steps=OBS_MORE),
        lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L, k, batch, seq), device="cuda")
    off_ms = 1e3 / plain.run(log=None)[-1]["meta_steps_per_sec"]
    del plain
    free(torch)
    work = Path(tempfile.mkdtemp(prefix="obs_", dir=ROOT / "build"))
    run_dir = work / "run"
    try:
        tcfg = TrainConfig(
            model=cfg, mavg=mavg,
            batch_per_learner=batch, seq_len=seq, meta_steps=OBS_STEPS,
            log_every=2,
            obs=ObsConfig(sink="jsonl", run_dir=str(run_dir), trace=True,
                          profiler=True, health=True))
        trainer = Trainer(
            tcfg, lambda p, b: api.loss_fn(p, cfg, b),
            init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
            batch_fn=uniform_batch_fn(cfg, L, k, batch, seq),
            lr_schedule=warmup_cosine(LR, 5, OBS_STEPS + 2 * OBS_MORE),
            device="cuda")
        profiled = trainer.obs_cfg
        unprofiled = dataclasses.replace(profiled, profiler=False)

        def window(label):
            # OBS_MORE unprofiled steps with the sink, spans and watchdogs
            # on: one flush window, so its rate is the steps' mean
            trainer.obs_cfg = unprofiled
            first = len(trainer.history)
            out = trainer.run(OBS_MORE, log=None)[first:]
            trainer.obs_cfg = profiled
            ms = 1e3 / out[-1]["meta_steps_per_sec"]
            print(f"  unprofiled meta step with telemetry on, {label}: "
                  f"{ms:.1f} ms (mean of steps {out[0]['meta_step']}-"
                  f"{out[-1]['meta_step']})")
            return ms

        before_ms = window("before the profiled run")
        syncs = trainer._mb.host_syncs
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        history = trainer.run(log=None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=OBS_STEPS,
                              sgd_apply=OBS_STEPS * k * L), counts
        # log_every=2 sizes the ring to 2 rows: a flush when it fills
        # after 2 steps, and the final one
        assert trainer._mb.buf.is_cuda
        assert trainer._mb.host_syncs - syncs == 2, trainer._mb.host_syncs
        history = history[OBS_MORE:]
        assert [h["meta_step"] for h in history] == list(
            range(OBS_MORE, OBS_MORE + OBS_STEPS))
        losses = [h["loss"] for h in history]
        assert all(math.isfinite(x) for x in losses), losses
        assert trainer._monitor.alerts == [], trainer._monitor.alerts
        names = {e["name"] for e in json.load(
            open(run_dir / "trace.json"))["traceEvents"]}
        assert {"obs.dispatch", "obs.host_flush", "obs.sink_append"} <= \
            names, names
        tt = [p for p in (run_dir / "torch_trace").iterdir()
              if p.stat().st_size > 0]
        assert tt, "the torch trace directory is empty"
        spans = trainer.tracer.summary()
        print(f"  {OBS_STEPS} profiled meta steps in {seconds:.2f} s; "
              f"host reads of the metric ring "
              f"{trainer._mb.host_syncs - syncs} (flushes 2); alerts none; "
              f"losses "
              f"{[round(x, 4) for x in losses]}")
        print("  spans: " + ", ".join(
            f"{n} {v['count']}x {v['mean_s'] * 1e3:.2f} ms"
            for n, v in sorted(spans.items())))
        print(f"  torch trace: {', '.join(p.name for p in tt)} "
              f"({sum(p.stat().st_size for p in tt) / 1e6:.1f} MB)")
        after_ms = window("after the profiled run")
        trainer.close()
        print("  " + check_telemetry(run_dir / "run.jsonl"))
        print(f"  unprofiled meta step with telemetry on {before_ms:.1f} ms "
              f"before the profiled run, {after_ms:.1f} ms after it; "
              f"telemetry off: {off_ms:.1f} ms (the last of {OBS_MORE} "
              f"steps of the same configuration)")
        del trainer
        free(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def attribution_on_the_card(torch) -> None:
    """Phase 13b. ``profile_phases`` on phase 12's configuration (Qwen3-1.7B
    widths, CKPT_DEPTH layers, flat dense M-AVG, L=2, K=4, B=8, S=64): the
    whole step, the local phase and the meta mix, each timed on one clone
    of the state (a full-depth L=4 state would not fit twice)."""
    from repro_torch.configs.base import MAvgConfig, get_config
    from repro_torch.core.meta import init_state
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.obs import measured_peak_gbps, profile_phases
    from repro_torch.utils.rng import seeded_generator

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=CKPT_DEPTH)
    k = 4
    mcfg = MAvgConfig(algorithm="mavg", num_learners=CKPT_L, k_steps=k)
    state = init_state(api.init_params(seeded_generator("cuda", 0, 0), cfg,
                                       "cuda"), mcfg)
    batches = uniform_batch_fn(cfg, CKPT_L, k, 8, 64)(
        seeded_generator("cuda", 0, 1, 0), 0)
    peak = measured_peak_gbps()
    peak_1g = measured_peak_gbps(1 << 30)
    rows = profile_phases(lambda p, b: api.loss_fn(p, cfg, b), mcfg, state,
                          batches, iters=5, warmup=2, peak_gbps=peak)
    assert [r["op"] for r in rows] == ["phase:step", "phase:local",
                                       "phase:meta_mix"], rows
    for r in rows:
        assert r["backend"] == "cuda", r
        assert math.isfinite(r["median_us"]) and r["median_us"] > 0, r
        print(f"  {r['op']}: median {r['median_us']:.1f} us, IQR "
              f"{r['iqr_us']:.1f} us ({r['iters']} timed, {r['warmup']} "
              f"warm-up); modeled {r['modeled_hbm_bytes'] / 1e9:.3f} GB, "
              f"{r['modeled_flops']:.4e} matmul flops, "
              f"{r['achieved_gbps']:.1f} GB/s, {r['pct_of_bound']:.1f} % "
              f"of the measured peak")
    print(f"  measured_peak_gbps: {peak:.1f} GB/s (triad over 64 MiB), "
          f"{peak_1g:.1f} GB/s (over 1 GiB)")
    assert state.step == 0  # the live state was not stepped
    del state, batches
    free(torch)


def supervised_recovery(torch, ops) -> dict:
    """Phase 13c. Qwen3-1.7B widths, depth cut to SUP_DEPTH layers, flat
    dense M-AVG, L=2, K=4, B=8, S=64, the finite guard, a checkpoint every
    3 steps, log_every=1, the health watchdogs; a NaN batch on learner 0 at
    step 3 of SUP_STEPS, under the Supervisor. The token batches carry a
    per-sequence loss weight (ones, f32): the float leaf the NaN poisoner
    writes into. Returns the launch counts of the whole supervised run."""
    import tempfile

    from repro_torch.chaos import ChaosConfig, FaultSpec
    from repro_torch.configs.base import (
        MAvgConfig,
        ObsConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.obs import HealthHalt
    from repro_torch.optim import warmup_cosine

    full = get_config("qwen3-1.7b")
    cfg = dataclasses.replace(full, num_layers=SUP_DEPTH)
    k, batch, seq = 4, 8, 64
    tokens = uniform_batch_fn(cfg, CKPT_L, k, batch, seq)

    def batch_fn(gen, step):
        b = tokens(gen, step)
        b["weight"] = torch.ones(CKPT_L, k, batch, device="cuda")
        return b

    def loss_fn(p, b):
        loss, aux = api.loss_fn(p, cfg, b)
        return loss * b["weight"].mean(), aux

    chaos = ChaosConfig(seed=0, horizon=SUP_STEPS, faults=(
        FaultSpec("nan_batch", step=3, learner=0),))
    work = Path(tempfile.mkdtemp(prefix="sup_", dir=ROOT / "build"))
    marks: dict[str, float] = {}
    attempts = []

    def make_trainer(plan):
        attempts.append(plan.attempt)
        if plan.attempt:  # the failed attempt's state must be gone by now
            marks["retry_entry"] = torch.cuda.memory_allocated() - marks[
                "alloc0"]
        tr = Trainer(
            TrainConfig(
                model=cfg,
                mavg=MAvgConfig(algorithm="mavg", num_learners=CKPT_L,
                                k_steps=k, finite_guard=True),
                batch_per_learner=batch, seq_len=seq, meta_steps=SUP_STEPS,
                log_every=1, checkpoint_dir=str(work / "ckpt"),
                checkpoint_every=3, chaos=chaos, data_salt=plan.data_salt,
                obs=ObsConfig(sink="jsonl", run_dir=str(work / "run"),
                              health=True)),
            loss_fn,
            init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
            batch_fn=batch_fn,
            lr_schedule=warmup_cosine(LR * plan.lr_scale, 5, SUP_STEPS),
            device="cuda")
        run = tr.run

        def timed_run(*a, **kw):
            try:
                return run(*a, **kw)
            except HealthHalt:
                marks["halt"] = time.perf_counter()
                marks["peak0"] = (torch.cuda.max_memory_allocated()
                                  - marks["alloc0"])
                torch.cuda.reset_peak_memory_stats()
                raise

        tr.run = timed_run
        return tr

    def log(line):
        if "halt" in marks and "resumed" not in marks and \
                not line.startswith("[supervisor]"):
            marks["resumed"] = time.perf_counter()
        print("  " + line)

    try:
        free(torch)
        marks["alloc0"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sup = Supervisor(make_trainer, target_steps=SUP_STEPS,
                         checkpoint_dir=str(work / "ckpt"))
        trainer, history = sup.run(log=log)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak1 = torch.cuda.max_memory_allocated() - marks["alloc0"]
        peak = max(marks["peak0"], peak1)
        state = trainer.state
        state_bytes = sum(x.numel() * x.element_size() for x in (
            state.global_params, state.momentum, state.learners))
        trainer.close()
        assert state.step == SUP_STEPS, state.step
        for name in ("global_params", "momentum", "learners"):
            assert bool(torch.isfinite(getattr(state, name)).all()), name
        faults = [r for r in sup.records if r["kind"] == "fault"]
        recoveries = [r for r in sup.records if r["kind"] == "recovery"]
        assert faults and faults[0]["fault"] == "nonfinite_loss", faults
        assert faults[0]["learner"] == 0, faults
        assert recoveries and recoveries[0]["attempt"] == 1, recoveries
        assert "rollback" in recoveries[0]["policy"], recoveries
        assert attempts == [0, 1], attempts
        assert peak < 2 * state_bytes, (peak, state_bytes)
        assert marks["retry_entry"] < 256 << 20, marks
        print("  " + check_telemetry(work / "run" / "run.jsonl"))
        f, r = faults[0], recoveries[0]
        print(f"  fault {f['fault']} on learner {f['learner']} at meta_step "
              f"{f['meta_step']}; recovery attempt {r['attempt']}, "
              f"{r['policy']}, resumed at meta_step {r['meta_step']} from "
              f"{Path(r['resume_path']).name}")
        print(f"  halt to resumed step {marks['resumed'] - marks['halt']:.2f}"
              f" s; the supervised run {seconds:.2f} s for {SUP_STEPS} "
              f"target steps ({len(history)} step records)")
        print(f"  device memory above the start: peak {marks['peak0'] / 1e9:.3f}"
              f" GB in attempt 0, {peak1 / 1e9:.3f} GB in attempt 1, against "
              f"a state of {state_bytes / 1e9:.3f} GB (limit twice the "
              f"state); {marks['retry_entry'] / 1e6:.1f} MB still allocated "
              f"when the retry's trainer was built (limit 256 MB)")
        del trainer, state
        free(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# phase 14: the async bounded-staleness server, its aliases, the straggle
# fault and the paper's E4 baseline comparison
# ---------------------------------------------------------------------------

ASYNC_PROFILE = (1, 1, 2, 4)  # ticks per K-step block, learners 0-3
ASYNC_TAU = 3
ASYNC_TICKS = 12  # learner 3 (start clock -3) fires at ticks 6 and 10


def blocks_per_tick(topology, ticks: int) -> list[int]:
    """The blocks each tick completes, from the server's host replay."""
    done = [topology.work_completed(i) for i in range(ticks)]
    return [b - a for a, b in zip([0] + done, done)]


def async_card_vs_cpu(torch, ops) -> dict:
    """Phase 14a: qwen3-1.7b.reduced() in f32, L=4, K=2, card against CPU
    over 2 x max(profile) ticks: the async mavg server on (1, 1, 2, 4),
    tau 3, packed and per-leaf; eamsgd; downpour at tau 2; the server
    under the sticky corruption of learner 3 with the robust clip and the
    finite guard; with elastic membership; under a straggle fault. Planes
    within rtol 1e-5 / atol 1e-5, fired counts and staleness equal. Then
    the uniform profile against the flat topology on the card, bitwise,
    packed and per-leaf. Returns the card's launches summed."""
    from repro_torch.chaos import (
        ChaosConfig,
        FaultSchedule,
        FaultSpec,
        PayloadCorruptor,
        apply_chaos,
    )
    from repro_torch.configs.base import (
        AsyncConfig,
        ElasticConfig,
        MAvgConfig,
        RobustConfig,
        TopologyConfig,
        get_config,
    )
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.topology import make_topology
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(2)
    params = api.init_params(gen, cfg, "cpu")
    K, ticks = 2, 2 * max(ASYNC_PROFILE)
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (L, K, 2, 16), generator=gen)
        for _ in range(ticks))]
    loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731
    n_leaves = len(tree_leaves(params))

    def run(mcfg, device, chaos, n=ticks):
        topology = make_topology(mcfg)
        state = init_state(tree_map(lambda x: x.to(device), params), mcfg,
                           topology=topology)
        cor = (None if chaos is None else
               PayloadCorruptor(FaultSchedule(chaos, mcfg.num_learners)))
        step = make_meta_step(loss_fn, mcfg, topology=topology, chaos=cor)
        ops.reset_launch_counts()
        metrics = []
        for b in batches[:n]:
            state, m = step(state, tree_map(lambda x: x.to(device), b))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = ops.launch_counts()
        planes = [state.global_params, state.momentum, state.learners] + [
            v for k, v in sorted((state.topo or {}).items())
            if k != "membership"]
        return ([x.cpu() for t in planes if t is not None
                 for x in tree_leaves(t)], metrics, counts, topology)

    base = dict(algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.1,
                momentum=0.7)
    skew = TopologyConfig(kind="async", server=AsyncConfig(
        staleness=ASYNC_TAU, step_time=ASYNC_PROFILE))
    straggle = apply_chaos(
        MAvgConfig(**base, topology=TopologyConfig(
            kind="async", server=AsyncConfig(staleness=1))),
        ChaosConfig(seed=0, horizon=ticks, faults=(
            FaultSpec("straggle", step=0, learner=1, magnitude=3.0),)))
    assert straggle.topology.server.step_time == (1, 4, 1, 1)
    runs = (  # (label, MAvgConfig, payload chaos)
        ("async mavg (1,1,2,4) tau 3 packed", MAvgConfig(**base,
                                                         topology=skew),
         None),
        ("async mavg (1,1,2,4) tau 3 per-leaf",
         MAvgConfig(**base, topology=skew, packed=False), None),
        ("eamsgd", MAvgConfig(**dict(base, algorithm="eamsgd")), None),
        ("downpour tau 2", MAvgConfig(**dict(base, algorithm="downpour"),
                                      staleness=2), None),
        ("async robust clip + finite guard, learner 3 sticky corruption",
         MAvgConfig(**base, topology=skew, finite_guard=True,
                    robust=RobustConfig(**ROBUST)), sticky_chaos(ticks, 2)),
        ("async (1,1,2,2) tau 2, elastic membership",
         MAvgConfig(**base, topology=TopologyConfig(
             kind="async", server=AsyncConfig(staleness=2,
                                              step_time=(1, 1, 2, 2)),
             elastic=ElasticConfig(period=4, drop_frac=0.25, seed=1))),
         None),
        ("async straggle fault (learner 1 +3 ticks, tau raised to 3)",
         straggle, None),
    )
    total = dict(NO_LAUNCHES)
    keys = ("fired_count", "staleness_max", "staleness_mean",
            "staleness_p99")
    for label, mcfg, chaos in runs:
        cpu, cpu_m, _, topology = run(mcfg, "cpu", chaos)
        card, card_m, counts, _ = run(mcfg, "cuda", chaos)
        fired = blocks_per_tick(topology, ticks)
        per_block = K * (1 if mcfg.packed else n_leaves)
        want = dict(NO_LAUNCHES, sgd_apply=per_block * sum(fired))
        assert counts == want, (label, counts, want)
        total = {k: v + counts[k] for k, v in total.items()}
        for k in keys:
            assert [m[k] for m in card_m] == [m[k] for m in cpu_m], (label,
                                                                     k)
        assert [m["fired_count"] for m in card_m] == fired, label
        # the bound holds for the step-time profile; an absent learner
        # lags without one (drop is unbounded lag)
        bound = mcfg.topology.server.staleness if (
            mcfg.topology.server is not None) else mcfg.staleness
        assert mcfg.topology.elastic is not None or all(
            m["staleness_max"] <= bound for m in card_m), label
        worst = 0.0
        for c, g in zip(cpu, card):
            torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5)
            assert bool(torch.isfinite(g).all()), label
            worst = max(worst, float((g.double() - c.double()).abs().max()))
        extra = ""
        if mcfg.robust is not None:
            clipped = [m["robust_clipped_learners"] for m in card_m]
            assert clipped == [m["robust_clipped_learners"] for m in cpu_m]
            assert sum(clipped) > 0, clipped
            extra = f"; clipped {clipped}"
        print(f"  {label}: card == CPU to rtol=1e-5, atol=1e-5 over {ticks} "
              f"ticks (max |diff| {worst:.3e}); fired {fired}, staleness_max "
              f"{[m['staleness_max'] for m in card_m]}{extra}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    for packed in (True, False):
        flat, _, fc, _ = run(MAvgConfig(**base, packed=packed), "cuda", None,
                             n=3)
        uni, um, uc, _ = run(MAvgConfig(**base, packed=packed,
                                        topology=TopologyConfig(
                                            kind="async",
                                            server=AsyncConfig())),
                             "cuda", None, n=3)
        assert fc == uc, (fc, uc)
        assert uc["fused_momentum_broadcast" if packed
                  else "block_momentum"] == 3 * (1 if packed else n_leaves)
        for a, b in zip(flat, uni):  # the flat planes, then the anchors
            assert torch.equal(a, b)
        assert [m["fired_count"] for m in um] == [float(L)] * 3
        print(f"  uniform profile == flat on the card, "
              f"{'packed' if packed else 'per-leaf'}: bitwise over 3 ticks; "
              f"launches {({k: v for k, v in uc.items() if v})}")
    return total


def async_full_width(torch, ops, label, mcfg, ticks) -> dict:
    """Phase 14b: Qwen3-1.7B at full width, depth cut to ASYNC_DEPTH layers,
    the async server through the Trainer (K=4, B=8, S=64, uniform tokens):
    staleness <= tau and fired counts equal to the host replay on every
    tick, sgd_apply launched K times a completed block, no fused launch
    off the degenerate case, every plane finite; the median tick, blocks
    per second, the peak device memory and one more tick profiled."""
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import warmup_cosine
    from repro_torch.topology import make_topology

    full = get_config("qwen3-1.7b")
    cfg = dataclasses.replace(full, num_layers=ASYNC_DEPTH)
    k, batch, seq = mcfg.k_steps, 8, 64
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=batch,
                       seq_len=seq, meta_steps=ticks)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(
        tcfg, lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, mcfg.num_learners, k, batch, seq),
        lr_schedule=warmup_cosine(LR, 5, ticks), device="cuda")
    state = trainer.state
    spec = state.spec
    planes = sum(x.numel() for x in [state.global_params, state.momentum,
                                     state.learners, state.topo["anchor"]]
                 ) // spec.total
    # what the phase holds beyond the state (nothing, unless an earlier
    # phase left something on the card)
    extra = torch.cuda.memory_allocated() - planes * spec.plane_bytes()
    print(f"  {label}: {spec.rows} rows x 128 ({spec.plane_bytes() / 1e9:.3f}"
          f" GB a plane), {planes} planes (w~, v, {mcfg.num_learners} "
          f"learners, {mcfg.num_learners} anchors), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"({extra / 1e9:.2f} GB beside the planes)")
    fired = blocks_per_tick(make_topology(mcfg), ticks)
    peaks = PhasePeaks(torch, trainer)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.run(log=None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = peaks.stop()
    want = dict(NO_LAUNCHES, sgd_apply=k * sum(fired))
    print(f"  launches: {({k_: v for k_, v in counts.items() if v})} "
          f"(K x {sum(fired)} completed blocks)")
    assert counts == want, (label, counts, want)
    assert [h["fired_count"] for h in history] == fired, history
    stale = [h["staleness_max"] for h in history]
    assert all(x <= mcfg.topology.server.staleness if mcfg.topology.server
               else x == 0 for x in stale), stale
    state = trainer.state
    for name, t in (("w~", state.global_params), ("v", state.momentum),
                    ("learners", state.learners),
                    ("anchors", state.topo["anchor"])):
        assert bool(torch.isfinite(t).all()), name
    losses = [h["loss"] for h in history]
    assert all(math.isfinite(x) for x in losses), losses
    tick_ms = [1e3 / h["meta_steps_per_sec"] for h in history]
    median = statistics.median(tick_ms[1:])
    # the profiled tick (the next one) does the work of the earlier ticks
    # that complete as many blocks; its idle share is read against their
    # median wall time
    profiled = blocks_per_tick(make_topology(mcfg), ticks + 1)[-1]
    same = statistics.median(
        ms for ms, f in zip(tick_ms[1:], fired[1:]) if f == profiled)
    print(f"  fired per tick {fired}; staleness_max {stale}; "
          f"staleness_p99 {[round(h['staleness_p99'], 2) for h in history]}")
    print(f"  losses {[round(x, 4) for x in losses]} (ln V = "
          f"{math.log(cfg.vocab_size):.4f}); every plane finite")
    print(f"  tick ms {[round(x, 1) for x in tick_ms]}")
    print(f"  {ticks} ticks in {seconds:.2f} s: median tick {median:.1f} ms "
          f"(ticks 1-{ticks - 1}; tick 0 {tick_ms[0]:.1f} ms), "
          f"{sum(fired) / seconds:.3f} completed blocks/s, "
          f"{ticks / seconds:.3f} ticks/s; samples {history[-1]['samples']}")
    print(f"  peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)"
          "; by part: " + ", ".join(f"{n} {v / 1e9:.2f} GB"
                                    for n, v in peaks.parts))
    assert peak < 80e9, peak
    profile_call(torch, f"async tick {ticks} ({profiled} blocks; against "
                 f"the median of the earlier {profiled}-block ticks)",
                 lambda: trainer.run(1, log=None), same)
    trainer.close()
    del trainer, state
    free(torch)
    return dict(counts, median_tick_ms=median, peak=peak,
                blocks_per_s=sum(fired) / seconds)


def async_uniform_full_width(torch, ops) -> None:
    """Phase 14b, last: the uniform profile at full width (ASYNC_DEPTH layers,
    L=4, K=4, B=8, S=64) for 2 ticks, bitwise equal to FlatAllReduce on
    the same params and batches; one fused launch a tick in each."""
    from repro_torch.configs.base import (
        AsyncConfig,
        MAvgConfig,
        TopologyConfig,
        get_config,
    )
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=ASYNC_DEPTH)
    base = dict(algorithm="mavg", num_learners=L, k_steps=4, learner_lr=LR,
                momentum=MU)
    batch_fn = uniform_batch_fn(cfg, L, 4, 8, 64)
    loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731

    def run(mcfg):
        params = api.init_params(torch.Generator(device="cuda")
                                 .manual_seed(3), cfg, "cuda")
        state = init_state(params, mcfg)
        del params
        step = make_meta_step(loss_fn, mcfg)
        ops.reset_launch_counts()
        for t in range(2):
            state, _ = step(state, batch_fn(
                torch.Generator(device="cuda").manual_seed(10 + t), t))
        torch.cuda.synchronize()
        return state, ops.launch_counts()

    flat, fc = run(MAvgConfig(**base))
    uni, uc = run(MAvgConfig(**base, topology=TopologyConfig(
        kind="async", server=AsyncConfig())))
    assert fc == uc == dict(NO_LAUNCHES, fused_momentum_broadcast=2,
                            sgd_apply=32), (fc, uc)
    for f in ("global_params", "momentum", "learners"):
        assert torch.equal(getattr(flat, f), getattr(uni, f)), f
    assert torch.equal(uni.topo["anchor"][L - 1], uni.global_params)
    print(f"  uniform profile == flat at full width ({ASYNC_DEPTH} layers, "
          f"L={L}) "
          f"over 2 ticks: w~, v and learners bitwise; launches "
          f"{({k: v for k, v in uc.items() if v})} in each")
    del flat, uni
    free(torch)


def async_benchmarks_on_the_card(torch, ops) -> dict:
    """Phase 14c: E4 quick, the async bench quick and the chaos bench
    quick on the card, each with the reference's assertions; their rows
    printed. Returns the launches of the three."""
    from repro_torch.benchmarks import async_bench, baselines, chaos_bench

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = baselines.main(quick=True, device="cuda")
    print(f"  E4 quick: {({a: r[2] for a, r in results.items()})} samples "
          f"to 1.1 ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rows = async_bench.main(quick=True, device="cuda")
    accept = next(r for r in rows if r["kind"] == "async_accept")
    print(f"  async bench quick: {json.dumps(accept)} "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    work = ROOT / "build" / f"chaos_bench_{os.getpid()}"
    try:
        rows = chaos_bench.main(quick=True, device="cuda",
                                workdir=str(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"  chaos bench quick: {json.dumps(rows[-1])} "
          f"({time.perf_counter() - t0:.1f} s)")
    counts = ops.launch_counts()
    print(f"  launches: {({k: v for k, v in counts.items() if v})}")
    assert counts["sgd_apply"] > 0 and counts["fused_momentum_broadcast"] > 0
    return counts


# ---------------------------------------------------------------------------
# phase 15: E2, E3, the ablations, the gated benches, the suite runner and
# the two examples
# ---------------------------------------------------------------------------

ONE_EXAMPLE = 1 / 2048 + 1e-9  # one of the 2,048 evaluation examples
E2_RUNS = [(P, 40) for P in (2, 4, 8, 16) for _ in range(5)]  # (P, steps)
E3_RUNS = [(128 // K, K) for _ in (0.0, 0.7) for K in (1, 2, 4, 8, 16)]
# the topology gate's flat_dense loss baseline, a value of JAX's stream
FIXED_SEED = "fixed-seed smoke run"
# train_100m's meta steps (20 until the whole run neared its time limit;
# at 5 the loss need not fall)
TRAIN_100M_STEPS = 10
# blocks (of 12) run in 15c's profiled train_100m meta step (all 12 until
# the whole run neared its time limit); its idle share is that of a
# PROFILE_100M_DEPTH-block program, not train_100m's
PROFILE_100M_DEPTH = 2
TRAIN_100M = ["--width", "full", "--steps", str(TRAIN_100M_STEPS),
              "--learners", "4", "--k", "4", "--batch", "8", "--seq", "128"]


def expect_flat(counts: dict, meta: int, local: int, label: str) -> None:
    """A packed flat dense run launches the fused meta update once a meta
    step, ``sgd_apply`` once a local step of a learner, and nothing else."""
    want = dict(NO_LAUNCHES, fused_momentum_broadcast=meta, sgd_apply=local)
    assert counts == want, (label, counts, want)


def cpu_drawn_inputs(torch, device):
    """``inputs(P=, K=, batch=, seed=)`` for the sweeps: the port's MLP
    params and batches drawn on the CPU (seeded as ``run_mlp`` seeds them)
    and moved to ``device``, so both devices train on the same numbers."""
    from repro_torch.benchmarks.common import CLASSES, D_IN, HIDDEN
    from repro_torch.data import classif_batch_fn, classif_eval_set
    from repro_torch.models.simple import mlp_init
    from repro_torch.utils.rng import seeded_generator
    from repro_torch.utils.tree import tree_map

    def move(tree):
        return tree_map(lambda x: x.to(device), tree)

    ev = move(classif_eval_set(D_IN, CLASSES, device="cpu"))

    def inputs(*, P, K, batch, seed):
        bf = classif_batch_fn(D_IN, CLASSES, P, K, batch, device="cpu")
        return dict(
            params=move(mlp_init(seeded_generator("cpu", seed), D_IN,
                                 HIDDEN, CLASSES, device="cpu")),
            batch_at=lambda i: move(bf(seeded_generator("cpu", seed + 1, i),
                                       i)),
            eval_set=ev)

    return inputs


def sweep_card_vs_cpu(torch, label, sweep) -> None:
    """Where a sweep's verdict fails on the card's own stream: the sweep
    on the card and on the CPU from the same CPU-drawn inputs, TF32 off;
    every loss within rtol 1e-5 / atol 1e-6, every accuracy within one
    evaluation example. ``sweep(device, inputs)`` -> (table, curves)."""
    with full_f32(torch):
        (gt, gc), (ct, cc) = (sweep(dev, cpu_drawn_inputs(torch, dev))
                              for dev in ("cuda", "cpu"))
    worst = 0.0
    for key in ct:
        assert abs(gt[key] - ct[key]) <= ONE_EXAMPLE, (label, key)
        for a, b in zip(gc[key], cc[key]):
            torch.testing.assert_close(torch.tensor(a), torch.tensor(b),
                                       rtol=1e-5, atol=1e-6)
            worst = max(worst, float((torch.tensor(a) - torch.tensor(b))
                                     .abs().max()))
    print(f"  {label} card vs CPU on CPU-drawn inputs: tables equal within "
          f"one example (card {json.dumps({str(k): v for k, v in gt.items()})}"
          f"; cpu {json.dumps({str(k): v for k, v in ct.items()})}); max "
          f"|loss diff| {worst:.3e} (rtol 1e-5, atol 1e-6)")


def timed(torch, ops, label, fn):
    """``fn()`` with the launch counters zeroed before and read after;
    returns (its result, the counts, the seconds)."""
    free(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  {label}: {seconds:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return out, counts, seconds


def sweeps_on_the_card(torch, ops) -> dict:
    """Phase 15a. E2, E3 and the ablations in quick mode on the card's own
    streams, with the reference's assertions, and the tuning example; a
    sweep whose verdict fails is held card against CPU on CPU-drawn
    inputs (the rule for a reference verdict that rests on a thin
    margin). Returns the launches of the four."""
    from repro_torch.benchmarks import ablations, k_sweep, mu_p_sweep
    from repro_torch.examples import momentum_tuning

    log = lambda s: print("  " + s)  # noqa: E731
    total = dict(NO_LAUNCHES)

    def e2():
        try:
            return mu_p_sweep.main(quick=True, device="cuda", log=log)[1]
        except AssertionError as e:
            print(f"  E2 verdict FAILED on the card's stream: best mu {e}")
            sweep_card_vs_cpu(torch, "E2", lambda dev, inp: mu_p_sweep.sweep(
                quick=True, device=dev, inputs=inp, log=lambda s: None))
            return None

    best, counts, _ = timed(torch, ops, "E2 quick", e2)
    print(f"  E2 best mu per P on the card: {best}")
    # a failed verdict runs the sweep on the card once more, on CPU-drawn
    # inputs
    runs = 1 if best is not None else 2
    expect_flat(counts, runs * sum(n for _, n in E2_RUNS),
                runs * sum(n * P * 4 for P, n in E2_RUNS), "E2")
    for k, v in counts.items():
        total[k] += v

    def e3():
        try:
            acc0, acc7, k_opt = k_sweep.main(quick=True, device="cuda",
                                             log=log)
            return (max(acc0, key=acc0.get), max(acc7, key=acc7.get), k_opt)
        except AssertionError as e:
            print(f"  E3 verdict FAILED on the card's stream: {e!r}")

            def both(dev, inp):
                tables, curves = {}, {}
                for mu in (0.0, 0.7):
                    acc, cur = k_sweep.sweep(mu, (0,), device=dev,
                                             inputs=inp, log=lambda s: None)
                    tables.update({(mu, K): a for K, a in acc.items()})
                    curves.update({(mu, K): c for K, c in cur.items()})
                return tables, curves

            sweep_card_vs_cpu(torch, "E3", both)
            return None

    verdict, counts, _ = timed(torch, ops, "E3 quick", e3)
    print(f"  E3 K_opt (mu 0, mu 0.7, with the reference's comm ratio) on "
          f"the card: {verdict}")
    runs = 1 if verdict is not None else 2
    expect_flat(counts, runs * sum(n for n, _ in E3_RUNS),
                runs * sum(n * K * 4 for n, K in E3_RUNS), "E3")
    for k, v in counts.items():
        total[k] += v

    results, counts, _ = timed(torch, ops, "ablations quick",
                               lambda: ablations.main(quick=True,
                                                      device="cuda", log=log))
    print("  ablations samples to 1.1: "
          f"{ {t: r[2] for t, r in results.items()} }")
    # the mlocal variant's local steps are learner MSGD (ATen), no sgd_apply
    expect_flat(counts, 5 * 40, 4 * 40 * 16, "ablations")
    for k, v in counts.items():
        total[k] += v

    best, counts, _ = timed(torch, ops, "momentum_tuning",
                            lambda: momentum_tuning.main(["--device",
                                                          "cuda"]))
    print(f"  momentum_tuning best mu by P {best[0]}, best K by mu {best[1]}")
    # guideline 1: P in (2, 8) x 3 mu, 60 meta steps at K=4; guideline 2:
    # P=4, K in (2, 8) at 128 local steps, 2 mu
    expect_flat(counts, 6 * 60 + 2 * (64 + 16),
                3 * 60 * 4 * (2 + 8) + 2 * 2 * 128 * 4, "momentum_tuning")
    for k, v in counts.items():
        total[k] += v
    return total


def gate(suite: str, rows) -> list[str]:
    """The port's ``obs.baseline.compare`` of envelope rows (``row_kind``)
    against ``benchmarks/expected/<suite>.json``, read as data; returns
    the violations, printed."""
    from repro_torch.obs.baseline import compare

    spec = json.loads((ROOT / "benchmarks" / "expected" /
                       f"{suite}.json").read_text())
    bad = compare(rows, spec)
    print(f"  gate {suite}: {len(spec['metrics'])} metrics, "
          f"{'all within bounds' if not bad else bad}")
    return bad


def benches_on_the_card(torch, ops) -> dict:
    """Phase 15b. The robust (under the Supervisor), topology, elastic,
    async and chaos benches in quick mode on the card, each through
    ``run.py --only <suite>`` with its trajectory store under ``build/``
    (removed afterwards); the robust, topology, async and chaos stores
    checked by ``compare``; then the comm bench (its ``main`` returns no
    rows, as the reference's) and ``--only roofline`` run (its rows are
    phase 19c's). Each suite's
    launches are checked against what its configuration implies. Returns
    the launches of all six."""
    from repro_torch.benchmarks import comm_bench, run
    from repro_torch.benchmarks.common import run_mlp
    from repro_torch.obs.baseline import latest_rows

    total = dict(NO_LAUNCHES)
    bench_dir = ROOT / "build" / f"bench_out_{os.getpid()}"

    def suite(name):
        """``run.py --only name`` -> (its stored rows, its launches)."""
        _, counts, _ = timed(torch, ops, f"run.py --only {name}",
                             lambda: run.main(["--only", name, "--bench-dir",
                                               str(bench_dir)]))
        for k, v in counts.items():
            total[k] += v
        return latest_rows(str(bench_dir / f"BENCH_{name}.json")), counts

    def kind(rows, k):
        return [r for r in rows if r.get("row_kind") == k]

    try:
        rows, counts = suite("robust")
        print(f"  robust_accept: {json.dumps(kind(rows, 'robust_accept'))}")
        assert not gate("robust", rows)
        # 64 meta steps over the five arms, 16 local steps a meta step;
        # the trimmed mean once a step of the robust arm
        assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=64,
                              sgd_apply=64 * 16, robust_reduce=16), counts

        rows, counts = suite("topology")
        print("  topology final loss (x flat): " + ", ".join(
            f"{r['cell']} {r['final_loss']:.4f} ({r['vs_flat']:.3f})"
            for r in kind(rows, "topo_measured")))
        print(f"  topo_accept: inter_reduction_vs_flat "
              f"{kind(rows, 'topo_accept')[0]['inter_reduction_vs_flat']:.1f}")
        bad = gate("topology", rows)
        if bad:
            # the gate's flat_dense baseline (0.713) is a value of JAX's
            # stream: a miss there is judged on the card against the CPU
            assert all(FIXED_SEED in v for v in bad), bad
            print("  only the fixed-seed flat_dense baseline missed; "
                  "holding that cell card against CPU on CPU-drawn inputs")

            def flat_dense(dev, inp):
                losses, acc = run_mlp("mavg", P=8, K=4, mu=0.7, steps=20,
                                      device=dev,
                                      **inp(P=8, K=4, batch=16, seed=0))
                return {"flat_dense": acc}, {"flat_dense": [losses]}

            sweep_card_vs_cpu(torch, "topology flat_dense", flat_dense)
        # 6 cells x 20 meta steps x 8 learners x K=4 local steps; the
        # fused update on the flat cells' steps and the hierarchical outer
        # level's (every 2nd step); block_momentum on the hierarchical
        # inner level and the gossip cells; neighbor_mix once a gossip
        # step, twice with momentum tracking; int8's pack_update;
        # int8_topk's outer route quantize and dequantize
        assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=60,
                              block_momentum=80, sgd_apply=3840,
                              pack_update=20, quantize=10, dequantize=10,
                              neighbor_mix=60), counts

        rows, counts = suite("elastic")
        (accept,) = kind(rows, "elastic_accept")
        vs = accept["loss_vs_static_at_25pct_churn"]
        print(f"  elastic_accept: hier_drop25 {vs:.3f}x static (within 5 "
              f"%: {accept['within_5pct']}; the reference records it and "
              f"asserts nothing)")
        assert all(math.isfinite(r["final_loss"]) for r in rows
                   if "final_loss" in r)
        # 15 cells x 20 meta steps: sgd_apply K=4 times a present learner
        # (churn drops 1-3 of 8; hetero-K runs group_k steps a group); the
        # fused update on the hierarchical outer level (every 2nd step),
        # block_momentum on every gossip and hierarchical inner step,
        # neighbor_mix once a static or masked gossip step, the stepped
        # entry on one_peer_exponential
        assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=80,
                              block_momentum=300, sgd_apply=7360,
                              neighbor_mix=120, neighbor_mix_stepped=20), \
            counts

        for name in ("async", "chaos"):
            rows, counts = suite(name)
            print(f"  {name}_accept: "
                  f"{json.dumps(kind(rows, f'{name}_accept'))}")
            assert not gate(name, rows)
            assert counts["sgd_apply"] > 0, counts
        stores = sorted(p.name for p in bench_dir.iterdir())
        assert stores == [f"BENCH_{n}.json" for n in (
            "async", "chaos", "elastic", "robust", "topology")], stores
    finally:
        shutil.rmtree(bench_dir, ignore_errors=True)

    def comm():
        return (comm_bench.measured(True, device="cuda")
                + comm_bench.modeled())

    rows, counts, _ = timed(torch, ops, "comm bench quick", comm)
    for k, v in counts.items():
        total[k] += v
    for r in rows:
        if r["kind"] == "comm_measured":
            print(f"  comm {r['scheme']}: {r['bytes_wire']:.0f} B, "
                  f"compression {r['compression']:.2f}, step "
                  f"{r['step_time_us']:.0f} us on {r['device']}, final loss "
                  f"{r['final_loss']:.4f} ({r['vs_dense']:.3f}x dense)")
            assert math.isfinite(r["final_loss"]), r
    # 5 schemes x 20 meta steps (15, then the timed step: one call, one
    # warmup, 3 timed); int8 takes pack_update on the packed plane,
    # int8_topk quantize and dequantize on its top-k route, fp8 and topk
    # ATen
    assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=100,
                          sgd_apply=1600, pack_update=20, quantize=20,
                          dequantize=20), counts
    # the dry run's suite tabulates whatever rows build/dryrun/ holds;
    # phase 19c writes and checks them
    run.main(["--only", "roofline", "--bench-dir", ""])
    return total


# train_100m card vs CPU: what two meta updates did to the params on the
# card against the CPU's, relative to the CPU's norm (the CPU parity
# test's limit against JAX, tests/test_torch_examples.py)
DTHETA_RTOL = 5e-5


# layers (of 12) of 15c's f32 card-vs-CPU run of train_100m's full width:
# the CPU's 2 meta steps took 29.7 s at 12; 2 until the whole run neared
# its time limit
F32_100M_DEPTH = 1


def train_100m_card_vs_cpu(torch, ops, batch_fn) -> None:
    """Phase 15c: the full-width config's widths at F32_100M_DEPTH layers
    in f32 compute, TF32 off, L=4, K=2, B=2, S=128, 2 meta steps through
    ``train_100m.run`` on the card (the fused_momentum_broadcast and
    sgd_apply kernels at the full plane) and on the CPU (their plain
    versions), from the same CPU-drawn params and the same batches of the
    card's bigram stream (``batch_fn``, cut to K=2, B=2): dtheta within
    DTHETA_RTOL of the CPU's, losses and the evaluation loss within rtol
    1e-5, the card's launches those of a packed flat run."""
    from repro_torch.examples import train_100m
    from repro_torch.models import api
    from repro_torch.pack import unpack_params
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(train_100m.make_config("full"),
                              dtype="float32", num_layers=F32_100M_DEPTH)
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    drawn = [batch_fn(torch.Generator(device="cuda").manual_seed(s), s)
             for s in range(2)]
    batches = [{k: v[:, :2, :2].cpu() for k, v in b.items()} for b in drawn]
    ev = {k: v[0, 0].cpu() for k, v in drawn[0].items()}  # (8, 128)
    del drawn

    def flat(tree):
        return torch.cat([x.detach().reshape(-1).cpu() for x in tree])

    theta0 = flat(tree_leaves(params))
    out = {}
    for dev in ("cpu", "cuda"):
        args = train_100m.parser().parse_args(
            ["--width", "full", "--steps", "2", "--learners", "4", "--k",
             "2", "--batch", "2", "--seq", "128", "--device", dev])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with full_f32(torch):
            trainer, hist, loss, _ = train_100m.run(
                args, params=params, batch_at=batches.__getitem__,
                eval_set=ev, cfg=cfg, log=lambda s: None)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        state = trainer.state
        out[dev] = dict(
            losses=[h["loss"] for h in hist], loss=loss,
            theta=flat(tree_leaves(unpack_params(state))),
            momentum=state.momentum.detach().cpu(),
            seconds=time.perf_counter() - t0)
        trainer.close()
        del trainer, state
        free(torch)
    expect_flat(counts, 2, 2 * 2 * 4, "train_100m card vs CPU")
    cpu, card = out["cpu"], out["cuda"]
    dtheta = cpu["theta"] - theta0
    err = float((card["theta"] - cpu["theta"]).norm() / dtheta.norm())
    m_err = float((card["momentum"] - cpu["momentum"]).norm()
                  / cpu["momentum"].norm())
    print(f"  train_100m full width f32 ({F32_100M_DEPTH} of 12 layers), L=4 "
          f"K=2 B=2 S=128, 2 meta steps: "
          f"card {card['seconds']:.1f} s, CPU {cpu['seconds']:.1f} s; "
          f"dtheta card vs CPU {err:.3e} of its norm "
          f"({float(dtheta.norm()):.4e}; limit {DTHETA_RTOL:g}), momentum "
          f"{m_err:.3e}; losses card {card['losses']} CPU {cpu['losses']}; "
          f"eval loss {card['loss']:.6f} / {cpu['loss']:.6f}; card "
          f"launches {({k: v for k, v in counts.items() if v})}")
    assert err <= DTHETA_RTOL, err
    torch.testing.assert_close(torch.tensor(card["losses"]),
                               torch.tensor(cpu["losses"]), rtol=1e-5,
                               atol=0)
    assert abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])


def examples_on_the_card(torch, ops) -> dict:
    """Phase 15c. ``train_100m --width full`` (125.8M parameters), L=4,
    K=4, B=8, S=128, TRAIN_100M_STEPS meta steps on the card: the loss
    falls, every
    plane is finite, the peak device memory printed; one more meta step
    at PROFILE_100M_DEPTH of its 12 blocks timed and profiled (the device's idle share, the bigram draws' host time and
    device span); 2 meta steps of its widths at F32_100M_DEPTH layers card
    vs CPU (``train_100m_card_vs_cpu``); then ``serve_batch`` on the reduced
    archs it serves (dense, MoE, the VLM's decode-only demo). Returns the
    main run's launches."""
    from repro_torch.examples import serve_batch, train_100m

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    (trainer, hist, ev, n), counts, seconds = timed(
        torch, ops, f"train_100m --width full, {TRAIN_100M_STEPS} meta steps",
        lambda: train_100m.main(TRAIN_100M))
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the Trainer's rate over its last log window
    rate = hist[-1]["meta_steps_per_sec"]
    print(f"  train_100m: {n:,} parameters; loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}, eval loss {ev:.4f}, "
          f"{hist[-1]['samples']} samples in {seconds:.1f} s (tables and "
          f"evaluation included); last window {rate:.3f} meta steps/s "
          f"({1e3 / rate:.1f} ms a meta step, "
          f"{rate * 4 * 4 * 8 * 128:.0f} tokens/s); peak device memory "
          f"{peak:.2f} GB")
    assert 100e6 <= n <= 130e6, n
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    for f in ("global_params", "momentum", "learners"):
        assert bool(torch.isfinite(getattr(trainer.state, f)).all()), f
    assert math.isfinite(ev)
    expect_flat(counts, TRAIN_100M_STEPS, TRAIN_100M_STEPS * 4 * 4,
                "train_100m")
    draw = trainer.batch_fn

    def traced_draw(gen, step):
        with torch.profiler.record_function("smoke.draw_batch"):
            return draw(gen, step)

    trainer.batch_fn = traced_draw
    # the profiled step runs PROFILE_100M_DEPTH of the 12 blocks: the
    # profiler takes about a millisecond an event to digest, and the whole
    # step's ~90,000 launches took a minute
    from repro_torch.launch.dryrun_lib import layer_limit

    with layer_limit({"blocks": PROFILE_100M_DEPTH}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(1, log=None)
        torch.cuda.synchronize()
        cut_ms = (time.perf_counter() - t0) * 1e3
        profile_call(torch, f"train_100m meta step ({PROFILE_100M_DEPTH} "
                     f"of 12 blocks)", lambda: trainer.run(1, log=None),
                     cut_ms)
    trainer.batch_fn = draw
    # one draw of a meta step's batches alone, unprofiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draw(torch.Generator(device="cuda").manual_seed(0), 0)
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3
    print(f"  one draw of a meta step's batches (16 sequences of 128 "
          f"tokens from the bigram table) alone: {draw_ms:.1f} ms, "
          f"{draw_ms * rate / 1e3:.3f} of the last window's meta step")
    train_100m_card_vs_cpu(torch, ops, draw)
    trainer.close()
    del trainer
    free(torch)

    out, scounts, _ = timed(torch, ops, "serve_batch, reduced archs",
                            lambda: serve_batch.main(["--device", "cuda"]))
    served = {a: t for a, t in out.items() if t is not None}
    assert sorted(served) == ["deepseek-moe-16b", "hymba-1.5b",
                              "internvl2-76b", "kimi-k2-1t-a32b",
                              "llama3-405b", "qwen1.5-110b", "qwen2-7b",
                              "qwen3-1.7b", "xlstm-350m"], sorted(served)
    assert all(t.shape == (2, 12) and t.is_cuda for t in served.values())
    # use_pallas is not set, as in the reference: no flash launch
    assert sum(scounts.values()) == 0, scounts
    return counts


# phase 16: the MoE family (DeepSeekMoE-16B: 1 dense + 27 MoE layers,
# 64 routed experts top-6 and 2 shared, d_expert 1408), and the audio and
# VLM inputs
MOE_ARCH = "deepseek-moe-16b"
MOE_REDUCED = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "hubert-xlarge",
               "internvl2-76b")
# layers of the full-width MoE training run (1 dense + 1 MoE; 1 dense + 2
# until the whole run neared its time limit); at 28 layers one plane
# alone is 65.5 GB
MOE_TRAIN_DEPTH = 2
# the MoE sites, by input shape in a profile: the expert products, the
# dispatch and combine gathers, and the gate and dispatch tables' scatters
MOE_OPS = ("aten::bmm", "aten::index", "aten::scatter", "aten::scatter_")


def families_card_vs_cpu(torch, ops, archs, meta_archs) -> None:
    """Phases 16a and 17a: reduced ``archs`` in f32 (TF32 off) on the card
    against the CPU, the same params and batch (``api.make_batch`` drawn
    on the CPU): the forward's logits and aux loss, the loss path's loss
    and every gradient, then (decoders) the prefill (through the f32 flash
    kernel where the family's attention takes it: one launch a layer;
    InternVL2's over its patches and tokens; Hymba's and xLSTM's through
    none, as JAX's), its whole cache, 8 decode steps and 8 greedy tokens;
    then 2 packed M-AVG meta steps of each of ``meta_archs`` (L=4, K=2,
    B=2, S=16). Section 2's limits: rtol 1e-5 with atol 1e-6 for losses,
    gradients and planes, 1e-5 for logits and caches; tokens equal."""
    from repro_torch.configs.base import MAvgConfig, get_config
    from repro_torch.core.meta import init_state, make_meta_step
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves, tree_map

    # section 2's limits: logits, caches and decode steps as serving's,
    # losses and planes as training's; gradients rtol 1e-5 / atol 1e-5
    # (their f32 sums cancel: InternVL2's patch_pos gradient measured 1.1e-6
    # apart at a value of 1.1e-2)
    serving, training = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5,
                                                         atol=1e-6)
    gradient = serving

    def close(label, got, want, errs, tol=training):
        got, want = got.detach().cpu(), want.detach()
        errs.append(float((got - want).abs().max()))
        torch.testing.assert_close(
            got, want, **tol, msg=lambda m: f"{label} ({tol}): {m}")

    def cache_entries(cache):  # xLSTM's entries are tuples of states
        return [(f"{k}[{i}]" if isinstance(v, tuple) else k, t)
                for k, v in sorted(cache.items()) if k != "pos"
                for i, t in enumerate(v if isinstance(v, tuple) else (v,))]

    for arch in archs:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        batch = api.make_batch(torch.Generator().manual_seed(1), cfg, 4, 16)
        out, errs = {}, []
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True)
                         .requires_grad_(True), params)
            b = tree_map(lambda t: t.to(dev), batch)
            with torch.no_grad():
                logits, aux = api.forward(p, cfg, b)
            loss, m = api.loss_fn(p, cfg, b)
            loss.backward()
            grads = [torch.zeros_like(t) if t.grad is None else t.grad
                     for t in tree_leaves(p)]
            out[dev] = (logits, aux["aux_loss"], loss, m["aux_loss"], grads)
        (lc, ac, xc, mc, gc_), (lg, ag, xg, mg, gg) = out["cpu"], out["cuda"]
        close(f"{arch} logits", lg, lc, errs, serving)
        for label, g, c in (("forward aux", ag, ac), ("loss", xg, xc),
                            ("loss aux", mg, mc)):
            close(f"{arch} {label}", g, c, errs)
        for i, (g, c) in enumerate(zip(gg, gc_)):
            close(f"{arch} grad {i}", g, c, errs, gradient)
        line = (f"  {arch} reduced f32: logits, aux, loss and "
                f"{len(gg)} grads")
        if cfg.supports_decode:
            flash = cfg.family not in ("hybrid", "ssm")
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            S = sum(v.shape[1] for v in prompt.values()) + cfg.meta_tokens
            cache_len = S + 8 + 4
            gparams = tree_map(lambda t: t.to("cuda"), params)
            with torch.no_grad():
                ops.reset_launch_counts()
                lg, cg = api.prefill(gparams, cfg, tree_map(
                    lambda t: t.cuda(), prompt), cache_len, use_pallas=True)
                torch.cuda.synchronize()
                assert ops.launch_counts() == dict(
                    NO_LAUNCHES,
                    flash_attention_f32=cfg.num_layers if flash else 0)
                lc, cc = api.prefill(params, cfg, prompt, cache_len,
                                     use_pallas=True)
                close(f"{arch} prefill", lg, lc, errs, serving)
                entries = cache_entries(cc)
                for (label, c), (_, g) in zip(entries, cache_entries(cg)):
                    close(f"{arch} cache {label}", g, c, errs, serving)
                assert int(cg["pos"]) == int(cc["pos"]) == S
                nxt_g = torch.argmax(lg, -1).to(torch.int32)
                nxt_c = torch.argmax(lc, -1).to(torch.int32)
                toks_g, toks_c = [], []
                for i in range(8):
                    assert torch.equal(nxt_g.cpu(), nxt_c), (arch, i)
                    toks_g.append(nxt_g)
                    toks_c.append(nxt_c)
                    lg, cg = api.decode_step(gparams, cfg, cg, nxt_g)
                    lc, cc = api.decode_step(params, cfg, cc, nxt_c)
                    close(f"{arch} decode {i}", lg, lc, errs, serving)
                    nxt_g = torch.argmax(lg, -1).to(torch.int32)
                    nxt_c = torch.argmax(lc, -1).to(torch.int32)
                for (label, c), (_, g) in zip(cache_entries(cc),
                                              cache_entries(cg)):
                    close(f"{arch} decoded cache {label}", g, c, errs,
                          serving)
            line += (f", prefill{' (flash)' if flash else ''} and its "
                     f"{len(entries)} cache entries, 8 decode steps; greedy "
                     f"tokens equal ({torch.stack(toks_c, 1)[0].tolist()})")
        print(f"{line}: card == CPU within rtol 1e-5 / atol 1e-6, logits "
              f"and caches atol 1e-5 (max |diff| {max(errs):.3g})")

    for arch in meta_archs:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        mcfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=2,
                          learner_lr=0.1, momentum=0.7)
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        gen = torch.Generator().manual_seed(2)
        batches = [{"tokens": t, "labels": t} for t in (
            torch.randint(0, cfg.vocab_size, (L, 2, 2, 16), generator=gen)
            for _ in range(2))]
        loss_fn = lambda p, b: api.loss_fn(p, cfg, b)  # noqa: E731
        runs = {}
        for dev in ("cpu", "cuda"):
            state = init_state(tree_map(lambda t: t.to(dev), params), mcfg)
            step = make_meta_step(loss_fn, mcfg)
            ops.reset_launch_counts()
            losses = []
            for b in batches:
                state, metrics = step(state, tree_map(lambda t: t.to(dev),
                                                      b))
                losses.append(float(metrics["loss"]))
            runs[dev] = (state, losses, ops.launch_counts())
        (sc, lc, _), (sg, lg, counts) = runs["cpu"], runs["cuda"]
        assert counts == dict(NO_LAUNCHES, fused_momentum_broadcast=2,
                              sgd_apply=2 * 2 * L), counts
        assert all(math.isclose(a, b, rel_tol=1e-5)
                   for a, b in zip(lg, lc)), (lg, lc)
        errs, tol = [], META_PLANE_TOL.get(arch, training)
        beyond = 0
        for name in ("global_params", "momentum", "learners"):
            g, c = getattr(sg, name).cpu(), getattr(sc, name)
            beyond += int(((g - c).abs() > 1e-6 + 1e-5 * c.abs()).sum())
            close(f"{arch} meta {name}", g, c, errs, tol)
        print(f"  {arch} reduced f32, 2 packed M-AVG meta steps (L={L}, "
              f"K=2): losses {[round(x, 6) for x in lc]} and every plane "
              f"card == CPU within rtol {tol['rtol']} / atol {tol['atol']} "
              f"(max |diff| {max(errs):.3g}; {beyond} values beyond rtol "
              f"1e-5 / atol 1e-6); launches "
              f"{ {k: v for k, v in counts.items() if v} }")


# ---------------------------------------------------------------------------
# phase 17: the hybrid and SSM families (Hymba-1.5B, xLSTM-350M)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("hymba-1.5b", "xlstm-350m")
# 17a's meta planes of xLSTM at the gradient limit, rtol 1e-5 / atol 1e-5:
# its embedding gradient cancels, and the CPU alone, at 1 thread against
# 4, moves 44 of the 2,073,600 values of the reduced model's global plane
# beyond 1e-6 after the same 2 meta steps (max 2.9e-6, all in
# embed/embedding); Hymba's none (max 9.5e-7)
META_PLANE_TOL = {"xlstm-350m": dict(rtol=1e-5, atol=1e-5)}
# layers of the full-width M-AVG training runs (of 32 and 24): at full
# depth a meta step took 23.0 s for Hymba (peak 60.05 GB) and 36 s for
# xLSTM at 8 layers, host-bound (measured on one H100); xLSTM keeps
# one super-block (3 mLSTM + 1 sLSTM), its smallest whole unit. Hymba
# went from 8 layers to 4, then 2, when the whole run neared its time
# limit
FAMILY_TRAIN_DEPTH = {"hymba-1.5b": 2, "xlstm-350m": 4}
# meta steps of those runs (2 until the whole run neared its time limit)
FAMILY_TRAIN_STEPS = 1
# prompt tokens of 17b's profiled prefill: xLSTM's recurrences launch the
# same kernels at every position (~570 a token), and the profiler takes
# about a millisecond an event to digest, so its prefill is profiled on
# the prompt's first 16 tokens; Hymba's on the whole prompt
FAMILY_PROFILE_PROMPT = {"xlstm-350m": 16}


class ServeLog:
    """While on, each ``api.prefill`` and ``api.decode_step`` call keeps
    its logits and cache (references to tensors it made) and records a
    CUDA event after it, the first event recorded on entry: ``generate``'s
    own prefill and decode steps timed on the device's clock (which waits
    on the host where the host is slower), and its logits kept for the
    teacher-forcing check, without a second run."""

    def __init__(self, torch):
        from repro_torch.models import api

        self.torch, self.api = torch, api
        self.real = (api.prefill, api.decode_step)

    def __enter__(self):
        torch, (prefill, decode) = self.torch, self.real
        self.logits, self.cache = [], None
        self.events = [torch.cuda.Event(enable_timing=True)]
        self.events[0].record()

        def keep(out):
            self.logits.append(out[0])
            self.cache = out[1]
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
            return out

        self.api.prefill = lambda *a, **k: keep(prefill(*a, **k))
        self.api.decode_step = lambda *a, **k: keep(decode(*a, **k))
        return self

    def __exit__(self, *exc):
        self.api.prefill, self.api.decode_step = self.real

    def prefill_ms(self) -> float:
        return self.events[0].elapsed_time(self.events[1])

    def decode_ms(self) -> float:
        """Per step, the argmax between steps included (``generate``'s)."""
        return (self.events[1].elapsed_time(self.events[-1])
                / (len(self.events) - 2))


def serving_family_full_width(torch, ops, arch) -> dict:
    """Phase 17b: full-width, full-depth Hymba-1.5B or xLSTM-350M, f32
    params from a seeded generator, bf16 compute, phase 10b's request (B=8,
    a 512-token prompt of uniform random tokens, 64 greedy tokens through
    ``generate``, cache_len 512 + 64 + 8: Hymba's window then holds every
    token after its meta prefix, xLSTM's cache is its state). No kernel on
    this path (JAX's Hymba and xLSTM call none): every launch count stays
    0. ``generate``'s prefill and decode steps are timed and their logits
    kept (``ServeLog``). Checked: finite logits, generate's greedy tokens
    their argmax, teacher forcing (one forward over prompt and generated
    tokens against those logits) within the bf16 limit, peak < 80 GB.
    Prefill ms, decode ms a step, tokens/s, peak; one decode step (from
    generate's cache) and one prefill profiled. Returns the launch counts
    of the generate run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch)
    B, S0, new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    cache_len = S0 + new + 8
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
    prompt = torch.randint(
        0, cfg.vocab_size, (B, S0), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"  params {sum(t.numel() for t in tree_leaves(params)):,}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB f32, "
          f"{cfg.num_layers} layers, compute {cfg.dtype}")
    with torch.no_grad():
        ops.reset_launch_counts()
        with ServeLog(torch) as log:
            t0 = time.perf_counter()
            tokens = serve.generate(params, cfg, prompt, new, cache_len)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"  launches: {counts}")
        assert counts == NO_LAUNCHES, counts
        assert tokens.shape == (B, new) and tokens.dtype == torch.int32
        prefill_ms, step_ms = log.prefill_ms(), log.decode_ms()
        assert len(log.logits) == 1 + new
        served = torch.stack(log.logits, 1)
        cache = log.cache
        del log
        assert bool(torch.isfinite(served).all()), "non-finite logits"
        assert torch.equal(torch.argmax(served[:, :-1], -1).to(torch.int32),
                           tokens)
        print(f"  {served.numel()} logits of generate's prefill and {new} "
              f"decode steps finite; its tokens are their argmax")
        # teacher forcing: the forward's logits at the same positions,
        # behind the meta prefix
        fwd, _ = api.forward(params, cfg, {"tokens": torch.cat(
            [prompt, tokens], 1)})
        bf16_close(torch, f"teacher forcing, forward over {S0 + new} "
                   f"tokens vs generate's prefill + {new} decode steps",
                   served, fwd[:, cfg.meta_tokens + S0 - 1:])
        del fwd, served
        peak = torch.cuda.max_memory_allocated()
        free(torch)
        print(f"  prefill {prefill_ms:.1f} ms ({B * S0 / prefill_ms * 1e3:.0f}"
              f" prompt tokens/s); decode {step_ms:.2f} ms a step, "
              f"{1e3 / step_ms:.2f} steps/s, {B * 1e3 / step_ms:.1f} "
              f"tokens/s (CUDA events around generate's calls); generate "
              f"{gen_s:.2f} s ({B * new / gen_s:.1f} tokens/s); peak device "
              f"memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)")
        assert peak < 80e9, peak
        tok = tokens[:, -1]
        profile_call(torch, "decode step",
                     lambda: api.decode_step(params, cfg, cache, tok),
                     step_ms)
        del cache
        n = FAMILY_PROFILE_PROMPT.get(arch, S0)
        part = {"tokens": prompt[:, :n]}
        if n < S0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, cfg, part, cache_len)
            torch.cuda.synchronize()
            part_ms = (time.perf_counter() - t0) * 1e3
        else:
            part_ms = prefill_ms
        profile_call(torch, f"prefill of {n} prompt tokens",
                     lambda: api.prefill(params, cfg, part, cache_len),
                     part_ms)
    del params
    free(torch)
    return counts


# ---------------------------------------------------------------------------
# phase 18: the cost model (repro_torch.roofline) against the card
# ---------------------------------------------------------------------------

RATE_BYTES = 1 << 30  # the triad's buffer
RATE_MM = 8192  # the matmul rate's square: 2 x 8192^3 flops a product
# the modeled peak (jit_cost's peak_state_bytes: the state, the batches
# and the step's largest set of live temporaries) against the card's
# max_memory_allocated over the step above the allocation before the
# trainer was built: within this share of the modeled peak (set before
# the first call on the card; the caching allocator rounds each block up
# to 512 bytes, and a library's workspace would land in the measured
# side only)
COST_PEAK_RTOL = 0.05
COST_STEPS = 2  # the launcher's steps with --obs-cost


def measured_rates(torch) -> dict:
    """Phase 18a. The card's memory rate (the triad of
    ``obs.measured_peak_gbps`` over 1 GiB) and its bf16 and TF32 matmul
    rates (``torch.matmul`` of two 8192 x 8192 matrices, CUDA-event
    medians), beside the data sheet's."""
    from repro_torch.obs import measured_peak_gbps
    from repro_torch.roofline.terms import H100_SXM

    gbps = measured_peak_gbps(RATE_BYTES, device="cuda", refresh=True)
    gen = torch.Generator(device="cuda").manual_seed(18)
    flops = 2.0 * RATE_MM ** 3
    rates = {"hbm_gbps": gbps}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, dtype, tf32 in (("bf16", torch.bfloat16, False),
                                  ("tf32", torch.float32, True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            a, b = (torch.randn((RATE_MM, RATE_MM), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            ms = cuda_ms(torch, lambda: torch.matmul(a, b), warmup=3,
                         iters=10)
            rates[f"{name}_tflops"] = flops / (ms * 1e-3) / 1e12
            del a, b
            free(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sheet = {"hbm_gbps": H100_SXM.hbm_bytes_per_s / 1e9,
             "bf16_tflops": H100_SXM.bf16_flops_per_s / 1e12,
             "tf32_tflops": H100_SXM.tf32_flops_per_s / 1e12}
    for key, value in rates.items():
        print(f"  {key}: {value:.1f} measured, {sheet[key]:.1f} data sheet "
              f"({value / sheet[key]:.1%})")
        assert math.isfinite(value) and value > 0, (key, value)
    return rates


def cost_against_the_card(torch, ops) -> dict:
    """Phase 18b. ``jit_cost`` of phase 4's flat dense meta step (Qwen3-1.7B
    widths, DEPTH layers, L=4, K=4, B=8, S=64) on meta copies of the
    trainer's state, then the same step on the card: the modeled kernel
    calls equal the launches the card counts (one fused_momentum_broadcast
    and 16 sgd_apply), the modeled matmul flops equal
    ``torch.profiler``'s exactly, and the modeled peak is within
    COST_PEAK_RTOL of the measured one. Returns the launch counts, and
    for phase 19a the step's configs, meta copies of its state and batch
    and their cost."""
    from repro_torch.configs.base import MAvgConfig, TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.roofline.cost import (
        jit_cost,
        meta_copy,
        profiled_matmul_flops,
    )
    from repro_torch.roofline.terms import H100_SXM

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=DEPTH)
    k, batch, seq = 4, 8, 64
    free(torch)
    baseline = torch.cuda.memory_allocated()
    trainer = Trainer(
        TrainConfig(model=cfg, mavg=MAvgConfig(algorithm="mavg",
                                               num_learners=L, k_steps=k),
                    batch_per_learner=batch, seq_len=seq, meta_steps=1),
        lambda p, b: api.loss_fn(p, cfg, b),
        init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
        batch_fn=uniform_batch_fn(cfg, L, k, batch, seq), device="cuda")
    step = lambda s, b: trainer._step_fn(s, b, lr=LR)  # noqa: E731

    def batches(i):
        return trainer.batch_fn(trainer._data_generator(i), i)

    batch = batches(0)
    inputs = dict(cfg=cfg, mcfg=trainer.mcfg,
                  args=meta_copy(trainer.state, batch))
    t0 = time.perf_counter()
    jc = jit_cost(step, trainer.state, batch, in_place=(0,))
    inputs["cost"] = jc
    model_s = time.perf_counter() - t0
    print(f"  modeled in {model_s:.2f} s on the meta device: "
          f"{jc.flops:.6e} matmul flops, {jc.hbm_bytes / 1e9:.3f} GB moved "
          f"(eager model), peak_state {jc.peak_state_bytes / 1e9:.3f} GB "
          f"(arg {jc.arg_bytes / 1e9:.3f}, out {jc.out_bytes / 1e9:.3f}, "
          f"alias {jc.alias_bytes / 1e9:.3f}, temp "
          f"{jc.temp_bytes / 1e9:.3f}), kernel calls {jc.kernel_calls}")
    assert trainer.state.step == 0  # the live state was not stepped
    # the step on the card, unprofiled: launches and the memory peak
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.state, _ = step(trainer.state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    measured = torch.cuda.max_memory_allocated() - baseline
    launched = {name: n for name, n in counts.items() if n}
    print(f"  the step on the card in {step_s * 1e3:.1f} ms: launches "
          f"{launched}; peak {measured / 1e9:.3f} GB above the baseline "
          f"against {jc.peak_state_bytes / 1e9:.3f} GB modeled "
          f"({measured / jc.peak_state_bytes - 1:+.3%})")
    assert launched == jc.kernel_calls, (launched, jc.kernel_calls)
    assert launched == dict(fused_momentum_broadcast=1, sgd_apply=k * L)
    assert (abs(measured - jc.peak_state_bytes)
            <= COST_PEAK_RTOL * jc.peak_state_bytes), (measured, jc)
    # the next step under the profiler: its matmul flops. The blocks run
    # under the default remat, whose early stop ends a block's recompute
    # inside the autograd wrapper of its last product, after the profiler
    # has recorded it: the two are compared with the early stop off
    from torch.utils.checkpoint import set_checkpoint_early_stop

    with set_checkpoint_early_stop(False):
        whole = jit_cost(step, inputs["args"][0], inputs["args"][1],
                         in_place=(0,))
        _, flops = profiled_matmul_flops(step, trainer.state, batches(1))
    torch.cuda.synchronize()
    print(f"  torch.profiler counts {flops:.6e} matmul flops with the "
          f"early stop off, modeled {whole.flops:.6e} ({jc.flops:.6e} "
          f"with it on); the step's compute term at the data sheet's "
          f"bf16 rate {jc.flops / H100_SXM.bf16_flops_per_s * 1e3:.3f} ms, "
          f"its memory term {jc.hbm_bytes / H100_SXM.hbm_bytes_per_s * 1e3:.3f} "
          f"ms, measured {step_s * 1e3:.1f} ms")
    assert flops == whole.flops, (flops, whole.flops)
    del trainer, batch
    free(torch)
    return counts, inputs


# ---------------------------------------------------------------------------
# phase 19: the placement half (sharding rules, DeviceMesh/DTensor
# placements, the placed meta step, the dry run of a 256-GPU mesh)
# ---------------------------------------------------------------------------

# phase 19b: the meta steps of the placed and the unplaced state
PLACED_STEPS = 2
# phase 19c: the dry run's rows (modeled on the meta device, on the CPU,
# layer-scaled). Left out: Hymba-1.5B's prefill_32k (its 32,896 tokens
# with the meta prefix give 128-token attention blocks, JAX's largest
# divisor: 66,049 blocks a layer, minutes each)
DRYRUN_ROWS = (
    ("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
    ("qwen3-1.7b", "prefill_32k"), ("deepseek-moe-16b", "train_4k"),
    ("deepseek-moe-16b", "decode_32k"), ("hymba-1.5b", "train_4k"),
    ("hymba-1.5b", "decode_32k"), ("xlstm-350m", "train_4k"),
    ("xlstm-350m", "decode_32k"), ("xlstm-350m", "prefill_32k"),
    ("deepseek-moe-16b", "prefill_32k"))
# rows costed in a dry-run process of their own, beside the one that
# costs the others (DeepSeekMoE-16B's prefill_32k takes minutes on one
# host thread: in the other process it would outlast the phases)
DRYRUN_OWN = (("deepseek-moe-16b", "prefill_32k"),)
# the rows one after the other, in the dry run's CLI
DRYRUN_PROGRAM = (
    "import os, sys\n"
    "os.nice(19)  # the host's cores go to the phases first\n"
    "from repro_torch.launch import dryrun\n"
    "rcs = [dryrun.main(['--arch', a, '--shape', s, '--mesh', 'single'])\n"
    "       for a, s in {rows!r}]\n"
    "sys.exit(max(rcs))\n")

# phase 19b's program, run in a process of its own so that its process
# group (NCCL, world size 1) never outlives it: for each named
# configuration the same packed state stepped unplaced and placed by
# specs.state_shardings on a (1, 1) DeviceMesh, the same payload fault in
# both (the placed step takes it on each rank's whole learners by global
# index); prints each one's planes' equality, metrics' equality and both
# runs' launches. "trainer": a Trainer with the cost analysis and the
# attribution rows on, unplaced and on the mesh
PLACED_STEP_SCRIPT = r"""
import dataclasses, json, sys, time
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import base as Bc
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.data import uniform_batch_fn
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.models import api
from repro_torch.sharding import Spec
from repro_torch.sharding.placed import Placement, placed_meta_step
from repro_torch.utils.rng import seeded_generator

depth, L, K, B, Sq, steps, port = map(int, sys.argv[1:8])
lr = float(sys.argv[8])
device, backend, width = sys.argv[9:12]  # cuda nccl full on the card


def setup(name):
    # (the config, the payload fault or None)
    kw = dict(num_learners=L, k_steps=K)
    if name in ("mavg", "mavg_mlocal"):
        return Bc.MAvgConfig(algorithm=name, local_momentum=0.5
                             if name == "mavg_mlocal" else 0.0, **kw), None
    if name == "int8":
        return Bc.MAvgConfig(comm=Bc.CommConfig(scheme="int8"),
                             **dict(kw, num_learners=2)), None
    if name == "hier_elastic":
        return Bc.MAvgConfig(topology=Bc.TopologyConfig(
            kind="hierarchical", groups=2, outer_every=2,
            inner_comm=Bc.CommConfig(scheme="int8"),
            elastic=Bc.ElasticConfig(period=2, drop_frac=0.25, seed=1)),
            **kw), None
    if name == "robust":
        from repro_torch.chaos import (ChaosConfig, FaultSchedule, FaultSpec,
                                       PayloadCorruptor)

        return Bc.MAvgConfig(robust=Bc.RobustConfig(
            estimator="trimmed", trim=1, clip_mult=3.0, clip_window=1),
            **kw), PayloadCorruptor(FaultSchedule(ChaosConfig(
                seed=0, horizon=steps, faults=(FaultSpec(
                    "finite_scale", step=0, learner=L - 1, duration=steps,
                    magnitude=12.0, sticky=True),)), L))
    if name == "guard":
        def nan(learners, step, offset=0):  # learner 1 NaN at step 1
            j = 1 - offset
            if int(step) == 1 and 0 <= j < learners.shape[0]:
                learners[j].fill_(float("nan"))
            return learners
        return Bc.MAvgConfig(finite_guard=True, **kw), nan
    if name == "per_leaf":
        return Bc.MAvgConfig(packed=False, **kw), None
    if name == "gossip":
        return Bc.MAvgConfig(topology=Bc.TopologyConfig(
            kind="gossip", graph="ring", momentum_tracking=True),
            comm=Bc.CommConfig(scheme="int8"), **kw), None
    if name == "async":
        return Bc.MAvgConfig(topology=Bc.TopologyConfig(
            kind="async", server=Bc.AsyncConfig(
                staleness=3, step_time=(1, 1, 2, 4))), **kw), None
    raise ValueError(name)


def sync():
    if device == "cuda":
        torch.cuda.synchronize()


def tensors(state):
    # every plane, a per-leaf tree leaf by leaf
    from repro_torch.utils.tree import tree_leaves, tree_paths

    fields = [(f, getattr(state, f)) for f in (
        "global_params", "momentum", "learners", "local_momentum",
        "comm_residual")]
    fields += [("topo/" + k, v) for k, v in (state.topo or {}).items()]
    out = {}
    for f, tree in fields:
        if tree is None:
            continue
        for path, x in zip(tree_paths(tree), tree_leaves(tree)):
            if isinstance(x, torch.Tensor):
                out[f + ("/" + path if path else "")] = x
    return out


def local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def trainer_run(cfg, mesh):
    from repro_torch.core.trainer import Trainer

    mcfg = Bc.MAvgConfig(num_learners=2, k_steps=K)
    tcfg = Bc.TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=B,
                          seq_len=Sq, meta_steps=steps, log_every=1,
                          obs=Bc.ObsConfig(cost_analysis=True,
                                           attribution=True))
    ops.reset_launch_counts()
    tr = Trainer(tcfg, lambda p, b: api.loss_fn(p, cfg, b),
                 init_params_fn=lambda g: api.init_params(g, cfg, device),
                 batch_fn=uniform_batch_fn(cfg, 2, K, B, Sq),
                 device=device, mesh=mesh)
    hist = tr.run(log=None)
    sync()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    jc = tr.jit_cost
    out = {"hist": [{k: v for k, v in h.items() if k not in (
        "meta_steps_per_sec", "samples_per_sec", "elapsed_s")}
        for h in hist], "launches": counts,
        "cost": None if jc is None else {
            "flops": jc.flops, "kernel_calls": jc.kernel_calls,
            "collective_bytes": jc.collective_bytes},
        "attribution": {r["op"]: r["median_us"] for r in tr.attribution}}
    del tr
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
try:
    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
    cfg = Bc.get_config("qwen3-1.7b")
    cfg = dataclasses.replace(cfg if width == "full" else cfg.reduced(),
                              num_layers=depth)
    loss = lambda p, b: api.loss_fn(p, cfg, b)
    placement = Placement(mesh, ("data",))
    for name in sys.argv[12].split(","):
        if name == "trainer":
            one, placed = trainer_run(cfg, None), trainer_run(cfg, mesh)
            print(json.dumps({"algorithm": name, "unplaced": one,
                              "placed": placed}), flush=True)
            continue
        mcfg, chaos = setup(name)
        n = mcfg.num_learners
        batch_fn = uniform_batch_fn(cfg, n, K, B, Sq)
        batches = [batch_fn(seeded_generator(device, 19, 1 + i), i)
                   for i in range(steps)]
        params = api.init_params(seeded_generator(device, 19, 0), cfg,
                                 device)
        ref, mine = init_state(params, mcfg), init_state(params, mcfg)
        del params
        step = make_meta_step(loss, mcfg, chaos=chaos)
        ops.reset_launch_counts()
        mr, ms = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            ref, m = step(ref, b, lr=lr)
            mr.append({k: float(v) for k, v in m.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        unplaced = {k: v for k, v in ops.launch_counts().items() if v}
        st = S.place_tree(mine, S.state_shardings(cfg, mcfg, mesh), mesh)
        ops.reset_launch_counts()
        mp, pms = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            bt = {k: S.place(v, Spec("data"), mesh) for k, v in b.items()}
            st, m = placed_meta_step(st, bt, loss_fn=loss, cfg=mcfg,
                                     placement=placement, lr=lr,
                                     chaos=chaos)
            mp.append({k: float(v) for k, v in m.items()})
            pms.append((time.perf_counter() - t0) * 1e3)
        placed = {k: v for k, v in ops.launch_counts().items() if v}
        want, got = tensors(ref), tensors(st)
        equal = {k: bool(torch.equal(local(got[k]), v))
                 for k, v in want.items()}
        same = {k: all(a[k] == b[k] or a[k] != a[k] and b[k] != b[k]
                       for a, b in zip(mp, mr)) for k in mr[0]}
        print(json.dumps({"algorithm": name, "equal": equal,
                          "metrics_equal": all(same.values()) and
                          all(set(a) == set(b) for a, b in zip(mp, mr)),
                          "unplaced": unplaced, "placed": placed,
                          "loss": [mr[-1]["loss"], mp[-1]["loss"]],
                          "metrics": {k: mp[-1][k] for k in (
                              "nonfinite_learners", "present_count",
                              "robust_clipped_learners", "comm_compression")
                              if k in mp[-1]},
                          "by_step": {k: [m[k] for m in mp] for k in (
                              "nonfinite_learners",
                              "robust_clipped_learners") if k in mp[0]},
                          "ms": {"unplaced": ms, "placed": pms},
                          "placements": str(next(
                              v.placements for k, v in got.items()
                              if k.startswith("learners"))),
                          "planes": len(want)}),
              flush=True)
        # every reference to the two states goes before the next
        # configuration's (gossip's two states hold 59 GB at 2 layers)
        del ref, mine, st, want, got, batches, step, b, bt
        if device == "cuda":
            torch.cuda.empty_cache()
finally:
    dist.destroy_process_group()
"""
# phase 19b's configurations, each at Qwen3-1.7B's widths and
# DEPTH layers, K=4, B=8, S=64 (L=4 unless named): the dense mavg
# (19b) and mavg_mlocal (20b), then int8 + EF (L=2), hierarchical elastic
# (G=2, H=2, int8 + EF inner), robust (trimmed mean, trim 1, the clip at
# 3x a one-step ring; learner 3's payload scaled x12), the finite guard
# (learner 1 NaN at step 1), a Trainer with the cost analysis and the
# attribution rows (L=2), per-leaf planes (flat dense), gossip (the ring,
# momentum tracking, int8 + EF) and the async server (the profile
# (1, 1, 2, 4), tau 3, as phase 14b)
PLACED_CONFIGS = ("mavg", "mavg_mlocal", "int8", "hier_elastic", "robust",
                  "guard", "trainer", "per_leaf", "gossip", "async")
# the kernels each new placed configuration must launch (as often as its
# unplaced step)
PLACED_KERNELS = {
    "int8": ("pack_update", "fused_momentum_broadcast"),
    "hier_elastic": ("pack_compress", "block_momentum",
                     "fused_momentum_broadcast"),
    "robust": ("robust_reduce", "fused_momentum_broadcast"),
    "guard": ("fused_momentum_broadcast",),
    "per_leaf": ("block_momentum", "sgd_apply"),
    "gossip": ("pack_compress", "neighbor_mix", "block_momentum"),
    "async": ("sgd_apply",),
}


def placed_cost_on_a_1x1_mesh(inputs: dict) -> None:
    """Phase 19a. Phase 18b's step placed by ``specs.state_shardings`` on
    a (1, 1) DeviceMesh (a fake process group of one rank, destroyed
    afterwards) and costed as the dry run costs a rank's program: its
    flops, bytes and kernel calls equal 18b's unplaced ``jit_cost``
    exactly, with no collective; it thereby inherits 18b's check of the
    model against the card."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun_lib as D
    from repro_torch.launch import specs as S
    from repro_torch.sharding import Spec
    from repro_torch.sharding.placed import Placement, placed_meta_step

    cfg, mcfg, jc = inputs["cfg"], inputs["mcfg"], inputs["cost"]
    state, batch = inputs["args"]
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    try:
        placement = Placement(mesh, ("data",))
        st = S.place_tree(state, S.state_shardings(cfg, mcfg, mesh), mesh)
        bt = {k: S.place(v, Spec("data"), mesh) for k, v in batch.items()}
        loss = api_loss(cfg)
        t0 = time.perf_counter()
        got = D.cost_program(
            lambda s, b: placed_meta_step(s, b, loss_fn=loss, cfg=mcfg,
                                          placement=placement, lr=LR),
            (st, bt), dict(in_place=(0,), groups=placement.labels))
        print(f"  placed on (1, 1) and costed in "
              f"{time.perf_counter() - t0:.2f} s: {got.flops:.6e} flops "
              f"({jc.flops:.6e} unplaced), {got.hbm_bytes:.6e} bytes "
              f"({jc.hbm_bytes:.6e}), kernel calls {got.kernel_calls} "
              f"({jc.kernel_calls}), {got.collective_bytes:.0f} collective "
              f"bytes")
        assert got.flops == jc.flops, (got.flops, jc.flops)
        assert got.hbm_bytes == jc.hbm_bytes, (got.hbm_bytes, jc.hbm_bytes)
        assert got.kernel_calls == jc.kernel_calls
        assert got.collective_bytes == 0 and got.collective_calls == 0
    finally:
        dist.destroy_process_group()


def api_loss(cfg):
    from repro_torch.models import api

    return lambda p, b: api.loss_fn(p, cfg, b)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def placed_steps_on_the_card() -> dict:
    """Phases 19b and 20b. A real one-GPU DeviceMesh (NCCL, world size 1)
    in a process of its own: phase 4's model (Qwen3-1.7B widths,
    DEPTH layers, K=4, B=8, S=64) in each of PLACED_CONFIGS, its
    state placed by ``specs.state_shardings`` and stepped PLACED_STEPS meta
    steps by
    the placed step; its planes, residual and topology buffers (the
    local-momentum plane too) equal the unplaced run's from the same
    start bitwise, every metric equals the unplaced one, and it launches
    each kernel as often. The Trainer's placed run logs the unplaced
    run's records, and its ``jit_cost`` has the unplaced one's kernel
    calls and flops. Returns each configuration's result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [str(x) for x in (DEPTH, L, 4, 8, 64, PLACED_STEPS,
                             free_port(),
                             LR, "cuda", "nccl", "full",
                             ",".join(PLACED_CONFIGS))]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PLACED_STEP_SCRIPT, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = {}
    for line in proc.stdout.strip().splitlines():
        if line.startswith("{"):
            out = json.loads(line)
            outs[out["algorithm"]] = out
    print(f"  {len(outs)} configurations in {time.perf_counter() - t0:.1f} "
          f"s (a process of its own)")
    assert set(outs) == set(PLACED_CONFIGS), outs
    for name, out in outs.items():
        if name == "trainer":
            one, placed = out["unplaced"], out["placed"]
            assert placed["hist"] == one["hist"], out
            assert placed["launches"] == one["launches"], out
            assert one["cost"] is not None and placed["cost"] is not None
            assert placed["cost"]["kernel_calls"] == one["cost"][
                "kernel_calls"], out
            assert placed["cost"]["flops"] == one["cost"]["flops"], out
            assert set(placed["attribution"]) == set(one["attribution"]) \
                == {"phase:step", "phase:local", "phase:meta_mix"}, out
            continue
        assert all(out["equal"].values()) and out["metrics_equal"], out
        assert out["placed"] == out["unplaced"], out
        assert out["loss"][0] == out["loss"][1], out
        if name == "mavg":
            assert out["placed"] == dict(fused_momentum_broadcast=PLACED_STEPS,
                                         sgd_apply=PLACED_STEPS * 4 * L), out
        if name == "mavg_mlocal":
            # local steps update with momentum in plain ops: no sgd_apply
            assert out["placed"] == dict(
                fused_momentum_broadcast=PLACED_STEPS), out
            assert "local_momentum" in out["equal"], out
        for kernel in PLACED_KERNELS.get(name, ()):
            assert out["placed"].get(kernel, 0) > 0, (name, kernel, out)
    assert outs["guard"]["by_step"]["nonfinite_learners"] == [0.0, 1.0], outs
    assert outs["robust"]["by_step"]["robust_clipped_learners"][-1] >= 1.0, \
        outs
    assert "comm_residual" in outs["int8"]["equal"], outs
    assert "topo/inner_residual" in outs["hier_elastic"]["equal"], outs
    # per-leaf: every leaf of every field; gossip: the params, momentum
    # and residual stacks, two neighbor mixes a step (params, momentum);
    # async: the anchors and the clocks, no fused update off the
    # degenerate profile
    assert outs["per_leaf"]["planes"] > 4, outs["per_leaf"]
    assert {"topo/params", "topo/momentum", "topo/residual"} <= set(
        outs["gossip"]["equal"]), outs["gossip"]
    assert outs["gossip"]["placed"]["neighbor_mix"] == 2 * PLACED_STEPS, \
        outs["gossip"]
    assert {"topo/anchor", "topo/clock"} <= set(outs["async"]["equal"]), \
        outs["async"]
    assert "fused_momentum_broadcast" not in outs["async"]["placed"], \
        outs["async"]
    return outs


def print_placed(out: dict) -> None:
    if out["algorithm"] == "trainer":
        one, placed = out["unplaced"], out["placed"]
        print(f"  trainer (cost analysis, attribution): records equal; "
              f"launches {placed['launches']}; jit_cost kernel calls "
              f"{placed['cost']['kernel_calls']}, {placed['cost']['flops']:.6e}"
              f" flops (unplaced {one['cost']['flops']:.6e}), collective "
              f"bytes {placed['cost']['collective_bytes']:.0f}; attribution "
              f"us placed {placed['attribution']}, unplaced "
              f"{one['attribution']}")
        return
    ms = {k: [round(x, 1) for x in v] for k, v in out["ms"].items()}
    print(f"  {out['algorithm']}: planes equal {out['equal']}; metrics equal "
          f"{out['metrics_equal']} {out['metrics']} {out['by_step']}; "
          f"launches placed {out['placed']}, unplaced {out['unplaced']}; "
          f"losses {out['loss']}; ms a meta step (host clock, metrics read "
          f"each step) {ms}; learner placements {out['placements']}")


def start_dry_run():
    """Phase 19c's dry run, started after phase 3 in processes of their own
    (their fake process groups of 256 ranks never reach this one) so that
    they run on the host beside phases 4-19b: the dry run's CLI for each
    of DRYRUN_ROWS on the single (32, 8) H100 mesh, one thread a process,
    each of DRYRUN_OWN in a process of its own and the others in one, the
    output in files under ``build/`` (a pipe would fill and stall them).
    A process still running at exit is killed. Returns [(a process, its
    log, its rows)] and the start time."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    (ROOT / "build").mkdir(exist_ok=True)
    groups = [tuple(r for r in DRYRUN_ROWS if r not in DRYRUN_OWN)] + [
        (r,) for r in DRYRUN_OWN]
    started = []
    for i, rows in enumerate(groups):
        cmd = [sys.executable, "-c", DRYRUN_PROGRAM.format(rows=rows)]
        log = ROOT / "build" / f"dryrun_smoke_{i}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                    stderr=subprocess.STDOUT, text=True)
        started.append((proc, log, rows))

    def stop():
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return started, time.perf_counter()


def dry_run_rows(started) -> None:
    """Phase 19c. The dry run started by ``start_dry_run``, then
    ``run.py --only roofline`` on the rows. Every row is written; a train
    row's meta average is an all-reduce over 'data' of at least the
    device's plane. Every number of a row is modeled at the data sheet's
    rates, none measured."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun_lib as D
    from repro_torch.launch import specs as S
    from repro_torch.pack import make_pack_spec

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, t0 = started
    waited = time.perf_counter()
    for proc, log, rows in procs:
        try:
            proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - waited)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = log.read_text()
        assert proc.returncode == 0, out[-4000:]
        counted = [line.strip() for line in out.splitlines()
                   if line.strip().startswith("counted in")]
        print(f"  dry run of {len(rows)} rows in a process done "
              f"{time.perf_counter() - t0:.1f} s after its start (CPU, "
              f"meta device, layer-scaled; beside phases 4-19b; waited "
              f"{time.perf_counter() - waited:.1f} s here); {counted}")
    for arch, shape in DRYRUN_ROWS:
        path = Path(D.result_path(arch, shape, "single"))
        row = json.loads(path.read_text())
        rf, mem, coll = row["roofline"], row["memory"], row["collectives"]
        print(f"  {arch} {shape} (modeled in {row['lower_s']} s): args "
              f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, "
              f"{rf['hlo_flops']:.4e} flops, {rf['hlo_bytes']:.4e} "
              f"bytes, collectives {coll['by_type']} by axes "
              f"{coll['by_axes']}; compute {rf['compute_s']:.4g} s, "
              f"memory {rf['memory_s']:.4g} s, collective "
              f"{rf['collective_s']:.4g} s: {rf['bottleneck']}-bound")
        assert row["cost"]["flops"] > 0 and rf["chips"] == 256, row
        assert row["layer_scaled"], row
        if shape.startswith("train"):
            cfg = get_config(arch)
            rows = make_pack_spec(S.abstract_params(cfg)).rows
            plane = rows * 128 * 4 // (8 if rows % 64 == 0 else 1)
            assert coll["by_type"].get("all-reduce", 0) >= plane, row
            assert coll["by_axes"].get("data", 0) >= plane, row
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "roofline", "--bench-dir", ""], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for arch, shape in DRYRUN_ROWS:
        assert f"| {arch} | {shape} | single |" in proc.stdout, (
            arch, shape, proc.stdout[-3000:])
    print("  run.py --only roofline tabulates the rows")


def obs_cost_launcher(torch, tmp: Path) -> None:
    """Phase 18c. ``launch/train.py --obs-cost`` for COST_STEPS meta steps
    of the reduced model on the card with the JSONL sink: the manifest
    carries ``jit_cost``, and ``tools/check_telemetry.py`` accepts the
    log."""
    from repro_torch.launch import train as launch_train

    run_dir = tmp / "cost_run"
    launch_train.main(["--device", "cuda", "--learners", "2", "--k", "2",
                       "--steps", str(COST_STEPS), "--batch", "2", "--seq",
                       "16", "--obs-sink", "jsonl", "--run-dir",
                       str(run_dir), "--obs-cost"])
    log = run_dir / "run.jsonl"
    manifest = json.loads(log.read_text().splitlines()[0])
    cost = manifest["jit_cost"]
    assert cost["flops"] > 0 and cost["alias_bytes"] > 0, cost
    print(f"  manifest jit_cost {cost}; {check_telemetry(log)}")


def cost_benches(torch, ops, tmp: Path) -> dict:
    """Phase 18d. ``run.py --only kernel pack`` on the card (quick): every
    row ok, the attribution rows timing the kernels themselves. Returns
    the launches."""
    from repro_torch.benchmarks import run

    bench_dir = tmp / "bench"
    _, counts, _ = timed(torch, ops, "run.py --only kernel pack",
                         lambda: run.main(["--only", "kernel", "pack",
                                           "--device", "cuda",
                                           "--bench-dir", str(bench_dir)]))
    for suite in ("kernel", "pack"):
        recs = [json.loads(line) for line in
                (bench_dir / f"BENCH_{suite}.json").read_text().splitlines()]
        rows = [r for rec in recs for r in rec["rows"]]
        bad = [r for r in rows if r.get("ok") is False]
        assert rows and not bad, (suite, bad)
        for r in rows:
            if r.get("row_kind") == "attribution" and "route" in r:
                assert r["route"] == "cuda kernel", r
                print(f"  {suite} {r['op']}: {r['median_us']:.1f} us, "
                      f"{r['achieved_gbps']:.1f} GB/s, "
                      f"{r['pct_of_bound']:.1f} % of the measured peak")
    for name in ("pack_update", "fused_momentum_broadcast", "neighbor_mix",
                 "quantize", "sgd_apply", "block_momentum",
                 "pack_compress", "flash_attention_f32"):
        assert counts[name] > 0, (name, counts)
    return counts


# ---------------------------------------------------------------------------
# phase 20: block remat, the placed mavg_mlocal step, costed robust and
# guarded steps
# ---------------------------------------------------------------------------

# phase 20a: one local step of full-width, full-depth Qwen3-1.7B
REMAT_B, REMAT_S, REMAT_ITERS = 8, 512, 3
# each gradient leaf under dots and everything against full's, as the
# norm of the difference over the norm of full's: the three recompute the
# same bf16 products, but the embedding's and the attention's backward
# accumulate with atomics on the card
REMAT_RTOL = 1e-3


def remat_on_the_card(torch) -> dict:
    """Phase 20a. Full-width Qwen3-1.7B, 28 layers, f32 params (the
    planes' dtype) and bf16 compute: one local step's forward and backward
    (``torch.autograd.grad`` of the loss, B=8, S=512 uniform tokens) under
    each remat policy. For each: the peak device memory above the params
    (``max_memory_allocated``) beside ``jit_cost``'s peak on meta copies,
    and ms a step (CUDA-event median of REMAT_ITERS after one warm-up).
    The losses are equal, every gradient leaf within REMAT_RTOL of full's,
    and full's peak is the lowest. A policy that does not fit is printed
    and skipped. Returns {policy: (peak bytes, ms)}."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api, transformer
    from repro_torch.roofline.cost import jit_cost, meta_copy
    from repro_torch.utils.rng import seeded_generator
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("qwen3-1.7b")
    free(torch)
    params = api.init_params(seeded_generator("cuda", 20, 0), cfg, "cuda")
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (REMAT_B, REMAT_S),
                         generator=seeded_generator("cuda", 20, 1),
                         device="cuda")
    batch = {"tokens": toks, "labels": toks}

    def step(p, b):
        loss = api.loss_fn(p, cfg, b)[0]
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))

    mparams, mbatch = meta_copy(params, batch)
    base = torch.cuda.memory_allocated()
    print(f"  params {base / 1e9:.3f} GB (f32), {cfg.num_layers} layers, "
          f"B={REMAT_B}, S={REMAT_S}")
    saved = transformer.REMAT_POLICY
    out, ref = {}, None
    try:
        for policy in ("full", "dots", "everything"):
            transformer.set_remat_policy(policy)
            modeled = jit_cost(step, mparams, mbatch)
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            try:
                loss, grads = step(params, batch)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                print(f"  {policy}: does not fit on the card")
                free(torch)
                continue
            peak = torch.cuda.max_memory_allocated() - base
            times = []
            for _ in range(REMAT_ITERS):
                del grads
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, grads = step(params, batch)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            print(f"  {policy}: peak {peak / 1e9:.3f} GB above the params "
                  f"(modeled {(modeled.peak_state_bytes - modeled.arg_bytes) / 1e9:.3f} "
                  f"GB), {ms:.2f} ms a step (median of {times}), "
                  f"{modeled.flops:.4e} flops modeled, loss "
                  f"{float(loss):.6f}")
            if ref is None:
                ref = (loss, grads)
            else:
                assert torch.equal(loss, ref[0]), (policy, loss, ref[0])
                worst = max(float((g - r).norm() / r.norm().clamp_min(
                    1e-30)) for g, r in zip(grads, ref[1]))
                print(f"  {policy}: loss equal to full's; gradient leaves "
                      f"within {worst:.3e} of full's (relative norm)")
                assert worst <= REMAT_RTOL, (policy, worst)
            del grads
            out[policy] = (peak, ms)
    finally:
        transformer.REMAT_POLICY = saved
    del params, leaves, ref
    free(torch)
    assert "full" in out and all(out["full"][0] <= v[0]
                                 for v in out.values()), out
    return out


def costed_steps_on_the_card(torch, ops) -> dict:
    """Phase 20c. ``Trainer._cost`` (the ``--obs-cost`` path) of phase 9's
    robust step (Qwen3-1.7B widths, DEPTH layers, L=4, K=4, B=8, S=64,
    ROBUST and the finite guard, no corruption) and of a guarded flat
    dense step, each then run on the card: the modeled kernel calls equal
    the launches, and the modeled flops equal ``torch.profiler``'s with
    the checkpoint's early stop off. Returns the launches of the robust
    step."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.configs.base import (
        MAvgConfig,
        RobustConfig,
        TrainConfig,
        get_config,
    )
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import uniform_batch_fn
    from repro_torch.models import api
    from repro_torch.roofline.cost import profiled_matmul_flops

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=DEPTH)
    k, batch, seq = 4, 8, 64
    launched = {}
    for label, mcfg in (
            ("robust", MAvgConfig(algorithm="mavg", num_learners=L,
                                  k_steps=k, finite_guard=True,
                                  robust=RobustConfig(**ROBUST))),
            ("guarded", MAvgConfig(algorithm="mavg", num_learners=L,
                                   k_steps=k, finite_guard=True))):
        free(torch)
        trainer = Trainer(
            TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=batch,
                        seq_len=seq, meta_steps=1),
            lambda p, b: api.loss_fn(p, cfg, b),
            init_params_fn=lambda gen: api.init_params(gen, cfg, "cuda"),
            batch_fn=uniform_batch_fn(cfg, L, k, batch, seq),
            device="cuda")
        step = lambda s, b: trainer._step_fn(s, b, lr=LR)  # noqa: E731
        b0 = trainer.batch_fn(trainer._data_generator(0), 0)
        t0 = time.perf_counter()
        with set_checkpoint_early_stop(False):
            trainer._cost(b0, LR)
        jc = trainer.jit_cost
        assert jc is not None, label
        print(f"  {label}: jit_cost in {time.perf_counter() - t0:.2f} s: "
              f"{jc.flops:.6e} flops, {jc.hbm_bytes / 1e9:.3f} GB moved, "
              f"peak_state {jc.peak_state_bytes / 1e9:.3f} GB, kernel calls "
              f"{jc.kernel_calls}")
        ops.reset_launch_counts()
        with set_checkpoint_early_stop(False):
            (trainer.state, _), flops = profiled_matmul_flops(
                step, trainer.state, b0)
        torch.cuda.synchronize()
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        print(f"  {label}: the step on the card launched {counts}; "
              f"torch.profiler counts {flops:.6e} matmul flops")
        assert counts == jc.kernel_calls, (label, counts, jc.kernel_calls)
        assert flops == jc.flops, (label, flops, jc.flops)
        launched[label] = counts
        del trainer, step, b0
    free(torch)
    assert launched["robust"]["robust_reduce"] == 1, launched
    return launched["robust"]


# ---------------------------------------------------------------------------
# side processes: phases that run beside the main ones
# ---------------------------------------------------------------------------


def side_store(torch, ops, stamp) -> None:
    """Phases 12 and 13c: the checkpoint and the supervised recovery, bound
    by the host's copies, checksums and disk. Main joins this process
    before phase 16b, whose 71 GB peak leaves no room for their state."""
    stamp(f"phase 12: the checkpoint at full width ({CKPT_DEPTH} layers), "
          f"flat dense M-AVG, L={CKPT_L}: save, verify, restore in place, "
          f"resume")
    ckpt_counts = checkpoint_full_width(torch, ops)
    assert ckpt_counts["fused_momentum_broadcast"] > 0, ckpt_counts
    stamp(f"phase 13c: supervised recovery at full width ({SUP_DEPTH} "
          f"layers), L={CKPT_L}, finite guard, nan_batch on learner 0 at "
          f"step 3 of {SUP_STEPS}")
    sup_counts = supervised_recovery(torch, ops)
    assert sup_counts["fused_momentum_broadcast"] > 0, sup_counts
    assert sup_counts["sgd_apply"] > 0, sup_counts


def side_host(torch, ops, stamp) -> None:
    """Phases 14a, 14c, 15a and 15b: the async server card vs CPU on the
    reduced model and the quick benches, bound by the host's launches of
    small kernels, a few GB of the card at most."""
    stamp(f"phase 14a: the async server card vs CPU, qwen3-1.7b.reduced() "
          f"float32, L={L}, K=2, {2 * max(ASYNC_PROFILE)} ticks")
    with full_f32(torch):
        async_card_vs_cpu(torch, ops)
    free(torch)  # what this process keeps of the card from here is small
    stamp("phase 14c: E4, the async bench and the chaos bench, quick, on "
          "the card")
    async_benchmarks_on_the_card(torch, ops)
    t15 = time.perf_counter()
    stamp("phase 15a: E2, E3, the ablations and momentum_tuning, quick, on "
          "the card")
    sweep_counts = sweeps_on_the_card(torch, ops)
    stamp("phase 15b: the robust, topology, elastic, async and chaos "
          "benches, quick, through run.py --only (stores under build/), "
          "gated; the comm bench")
    bench_counts = benches_on_the_card(torch, ops)
    print(f"  phases 15a-b in {time.perf_counter() - t15:.1f} s; launches: "
          f"sweeps {({k: v for k, v in sweep_counts.items() if v})}, "
          f"benches {({k: v for k, v in bench_counts.items() if v})}")


SIDES = {"store": side_store, "host": side_host}


def side(name: str, epoch: float) -> int:
    """``chip_smoke.py --side NAME EPOCH``: the phases of ``SIDES[NAME]``
    in this process, their headers stamped with the seconds since EPOCH
    (the main process's start, ``time.time()``)."""
    import torch

    from repro_torch.kernels import ops

    assert torch.cuda.is_available()

    def stamp(msg: str) -> None:
        print(f"[{time.time() - epoch:7.1f} s] {msg}")

    SIDES[name](torch, ops, stamp)
    return 0


def start_side(name: str, epoch: float):
    """Start ``SIDES[name]`` in a process of its own on the same card, its
    output in a file under ``build/``; a process still running at exit is
    killed. Returns (the process, its log, its name)."""
    import atexit

    (ROOT / "build").mkdir(exist_ok=True)
    log = ROOT / "build" / f"side_{name}_{os.getpid()}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-u", str(ROOT / "chip_smoke.py"), "--side",
             name, repr(epoch)], cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log, name


def join_side(started, stamp) -> None:
    """Wait for a side process, print its output and fail if it failed."""
    proc, log, name = started
    waited = time.perf_counter()
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stamp(f"the '{name}' side process ended (waited "
          f"{time.perf_counter() - waited:.1f} s here, exit code "
          f"{proc.returncode}); its output:")
    print(log.read_text(), end="")
    log.unlink()
    assert proc.returncode == 0, f"the '{name}' side process failed"


def main() -> int:
    t_start, epoch = time.perf_counter(), time.time()

    def stamp(msg: str) -> None:
        # each phase's header carries the seconds since the start
        print(f"[{time.perf_counter() - t_start:7.1f} s] {msg}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import block_momentum as bm
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_meta as fm
    from repro_torch.kernels import local_sgd as sgd
    from repro_torch.kernels import neighbor_mix as nm
    from repro_torch.kernels import pack_update as pu
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import robust_reduce as rr
    from repro_torch.models import api
    from repro_torch.pack import make_pack_spec

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    stamp("phase 2: build")
    t0 = time.perf_counter()
    lib = build.library()
    print(f"  {lib.path.name} ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_s:.2f} s)")
    # each kernel's registers and spills; the 64 instantiations of the
    # robust-reduce kernel (L = 1..16, 1 or 4 coordinates a thread, f32 or
    # bf16), the 5 of the bf16 flash-attention kernel and the 5 of the f32
    # one (one a head dim; registers at launch: setmaxnreg then gives the
    # bf16 kernel's producer warpgroup 24 and its consumers 240, the f32
    # kernel's 56 and 224 where it has two consumer warpgroups) in one
    # line each
    grouped = ("robust_reduce_kernel", "flash_hopper_kernel",
               "flash_hopper_f32_kernel")
    entry, regs, spills = "", {g: [] for g in grouped}, {g: [] for g in
                                                         grouped}
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            entry = line
        elif "registers" in line or "spill" in line:
            group = next((g for g in grouped if g in entry), None)
            if group is None:
                print("  " + line.strip())
            elif "registers" in line:
                regs[group].append(int(line.split("Used ")[1].split()[0]))
            else:
                spills[group].append(line.strip())
    for group in grouped:
        if regs[group]:
            unspilled = all(x.startswith("0 bytes stack frame, 0 bytes "
                                         "spill stores, 0 bytes spill loads")
                            for x in spills[group])
            print(f"  {group}: {len(regs[group])} instantiations, "
                  f"{min(regs[group])}-{max(regs[group])} registers, "
                  f"{'no stack and no spills' if unspilled else spills[group]}")
            if group == "flash_hopper_f32_kernel":
                assert unspilled, spills[group]
    sass = sass_ops(lib.path, "flash_hopper_kernel", ("HGMMA", "UTMALDG"))
    if sass is None:
        print("  flash_hopper_kernel SASS: not checked (no cuobjdump)")
    else:
        print(f"  flash_hopper_kernel SASS: {sass['functions']} functions, "
              f"{sass['HGMMA']} HGMMA (wgmma) and {sass['UTMALDG']} UTMALDG "
              f"(TMA load) instructions")
    # the f32 kernel's products run on the TF32 tensor cores, and nothing
    # of it lives in local memory
    sass = sass_ops(lib.path, "flash_hopper_f32_kernel",
                    ("HGMMA", "x8.F32.TF32", "UTMALDG", "LDL", "STL"))
    if sass is None:
        print("  flash_hopper_f32_kernel SASS: not checked (no cuobjdump)")
    else:
        print(f"  flash_hopper_f32_kernel SASS: {sass['functions']} "
              f"functions, {sass['HGMMA']} HGMMA (wgmma), of them "
              f"{sass['x8.F32.TF32']} on TF32 operands, {sass['UTMALDG']} "
              f"UTMALDG, "
              f"{sass['LDL']} LDL and {sass['STL']} STL (local memory)")
        assert sass["functions"] == 5 and sass["HGMMA"] > 0, sass
        assert sass["x8.F32.TF32"] == sass["HGMMA"], sass
        assert sass["LDL"] == sass["STL"] == 0, sass

    stamp("phase 3: kernels vs plain versions at the main path's shapes")
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
                    + [check_pack_update(torch, pu, rows),
                       check_pack_compress(torch, pu, rows)])
    rows_cut = make_pack_spec(api.init_params(None, dataclasses.replace(
        get_config("qwen3-1.7b"), num_layers=CUT_PLANE_DEPTH), "meta")).rows
    main_err = check_pack_compress_main(torch, pu, rows_cut)
    comm_records[-1]["max_abs_err"] = max(comm_records[-1]["max_abs_err"],
                                          main_err)
    for r in comm_records:
        r["source"] = COMM_SOURCE
    topo_records = check_neighbor_mix(torch, nm, rows)
    for r in topo_records:
        r["source"] = TOPOLOGY_SOURCE
    robust_record = check_robust_reduce(torch, rr, rows, rows_cut)
    robust_record["source"] = ROBUST_SOURCE
    flash_records = check_flash_attention(torch, fa)
    records += comm_records + topo_records + [robust_record] + flash_records
    for r in records:
        print(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
              f"ms by {r['bound_by']}), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']}")
    # phase 19c's dry run, on the host beside the phases to come
    dry_run = start_dry_run()

    stamp(f"phase 4: full-width Qwen3-1.7B M-AVG trainer ({DEPTH} "
          f"layers), dense")
    dense_counts, _ = full_width_training(torch, ops)

    stamp(f"phase 5: full-width Qwen3-1.7B M-AVG trainer ({DEPTH} "
          f"layers), int8 + error feedback, L={L_COMM}")
    comm_counts = compressed_full_width(torch, ops)

    stamp("phase 6: card vs CPU, qwen3-1.7b.reduced() float32")
    with full_f32(torch):
        leaf_counts, topo_counts = card_vs_cpu(torch, ops)
        stamp("phase 6, robust: card vs CPU, qwen3-1.7b.reduced() float32, "
              f"L={L}, 3 meta steps")
        robust_card_vs_cpu(torch, ops)

    from repro_torch.configs.base import (
        CommConfig,
        ElasticConfig,
        MAvgConfig,
        TopologyConfig,
    )

    stamp(f"phase 7: gossip at full width ({DEPTH} layers), "
          f"one_peer_exponential, momentum tracking, int8 + EF, L={L}")
    gossip_counts = topology_full_width(
        torch, ops, "gossip",
        MAvgConfig(algorithm="mavg", num_learners=L, k_steps=4,
                   comm=CommConfig(scheme="int8"),
                   topology=TopologyConfig(kind="gossip",
                                           graph="one_peer_exponential",
                                           momentum_tracking=True)),
        3, lambda steps: dict(
            sgd_apply=steps * 4 * L, pack_compress=steps,
            neighbor_mix_stepped=2 * steps, block_momentum=steps))

    stamp(f"phase 8: hierarchical at full width ({DEPTH} layers), G=2, "
          f"H=2, mu_out=0.3, elastic (period 4, drop 0.25), inner int8 + "
          f"EF, outer dense, L={L}")
    # one learner of four absent per step; the outer level fires on
    # steps 1 and 3
    hier_counts = topology_full_width(
        torch, ops, "hierarchical",
        MAvgConfig(algorithm="mavg", num_learners=L, k_steps=4,
                   topology=TopologyConfig(
                       kind="hierarchical", groups=2, outer_every=2,
                       outer_momentum=0.3,
                       inner_comm=CommConfig(scheme="int8"),
                       elastic=ElasticConfig(period=4, drop_frac=0.25))),
        4, lambda steps: dict(
            sgd_apply=steps * 4 * (L - 1), pack_compress=2 * steps,
            block_momentum=steps, fused_momentum_broadcast=steps // 2))
    assert hier_counts["pack_compress"] == 8

    stamp(f"phase 9: full-width Qwen3-1.7B M-AVG trainer ({DEPTH} "
          f"layers), robust (trimmed "
          f"mean, clip 3x, scores) + finite guard, learner {L - 1} under "
          f"sticky corruption, L={L}")
    robust_counts = robust_full_width(torch, ops)

    stamp("phase 10: serving, card vs CPU on reduced configs (float32)")
    with full_f32(torch):
        print(f"  f32 flash launches in the two reduced prefills: "
              f"{serving_card_vs_cpu(torch, ops)}")
    stamp(f"phase 10: serving full-width Qwen3-1.7B, 28 layers, B={SERVE_B}, "
          f"{SERVE_PROMPT}-token prompt, {SERVE_NEW} greedy tokens, flash "
          f"prefill")
    serve_counts = serving_full_width(torch, ops)
    stamp(f"phase 10c: serving full-width Qwen3-1.7B in f32, 28 layers, "
          f"B={SERVE_B}, {SERVE_PROMPT}-token prompt, {SERVE_NEW} greedy "
          f"tokens, f32 flash prefill")
    f32_serve_counts = serving_full_width_f32(torch, ops)

    stamp(f"phase 13a: telemetry on the dense main path: full-width "
          f"Qwen3-1.7B, {DEPTH} layers, L={L}, JSONL sink, spans, torch "
          f"profiler, health, log_every=2, {OBS_STEPS} meta steps")
    obs_counts = telemetry_full_width(torch, ops)
    assert obs_counts["fused_momentum_broadcast"] > 0, obs_counts
    assert obs_counts["sgd_apply"] > 0, obs_counts
    stamp(f"phase 13b: attribution (profile_phases) on phase 12's "
          f"configuration at {CKPT_DEPTH} layers, L={CKPT_L}")
    attribution_on_the_card(torch)

    # the phases bound by the host run from here in processes of their
    # own beside the main ones: 12 and 13c until phase 16b, 14a, 14c, 15a
    # and 15b until the end
    store, host = (start_side(name, epoch) for name in ("store", "host"))
    stamp("phases 12 and 13c (side process 'store') and 14a, 14c, 15a and "
          "15b (side process 'host') started beside the phases to come")

    stamp("phase 11: E1 on the card: the CNN card vs CPU (M-AVG, L=4, K=4, "
          "packed and per-leaf), then convergence.main(quick=True)")
    e1_counts = e1_on_the_card(torch, ops)
    for name in ("fused_momentum_broadcast", "sgd_apply", "block_momentum"):
        assert e1_counts[name] > 0, (name, e1_counts)

    from repro_torch.configs.base import AsyncConfig

    stamp(f"phase 14b: the async server at full width ({ASYNC_DEPTH} "
          f"layers), mavg on profile {ASYNC_PROFILE}, tau {ASYNC_TAU}, "
          f"L={L}, K=4, {ASYNC_TICKS} ticks")
    async_counts = async_full_width(
        torch, ops, "async mavg",
        MAvgConfig(algorithm="mavg", num_learners=L, k_steps=4,
                   topology=TopologyConfig(kind="async", server=AsyncConfig(
                       staleness=ASYNC_TAU, step_time=ASYNC_PROFILE))),
        ASYNC_TICKS)
    stamp(f"phase 14b: eamsgd at full width ({ASYNC_DEPTH} layers), L={L}, "
          f"K=4, 4 ticks")
    async_full_width(torch, ops, "eamsgd",
                     MAvgConfig(algorithm="eamsgd", num_learners=L,
                                k_steps=4), 4)
    stamp(f"phase 14b: the uniform profile against flat at full width "
          f"({ASYNC_DEPTH} layers)")
    async_uniform_full_width(torch, ops)
    print(f"  phase 14b launches on the async main path: sgd_apply "
          f"{async_counts['sgd_apply']}, fused_momentum_broadcast "
          f"{async_counts['fused_momentum_broadcast']}")

    t15 = time.perf_counter()
    stamp(f"phase 15c: train_100m --width full (L=4, K=4, B=8, S=128, "
          f"{TRAIN_100M_STEPS} meta steps) and serve_batch on the reduced "
          f"archs")
    e2e_counts = examples_on_the_card(torch, ops)
    print(f"  phase 15c in {time.perf_counter() - t15:.1f} s; launches: "
          f"train_100m {({k: v for k, v in e2e_counts.items() if v})}")

    t16 = time.perf_counter()
    stamp(f"phase 16a: the MoE, audio and VLM families card vs CPU, "
          f"reduced {', '.join(MOE_REDUCED)} float32, then 2 M-AVG meta "
          f"steps of {MOE_ARCH} reduced, L={L}")
    with full_f32(torch):
        families_card_vs_cpu(torch, ops, MOE_REDUCED, (MOE_ARCH,))
    join_side(store, stamp)
    stamp(f"phase 16b: serving full-width DeepSeekMoE-16B, 28 layers (1 "
          f"dense + 27 MoE), B={SERVE_B}, {SERVE_PROMPT}-token prompt, "
          f"{SERVE_NEW} greedy tokens, flash prefill")
    moe_serve_counts = serving_full_width(torch, ops, MOE_ARCH,
                                          ops_by_shape=MOE_OPS)
    stamp(f"phase 16c: full-width DeepSeekMoE-16B M-AVG trainer "
          f"({MOE_TRAIN_DEPTH} layers: 1 dense + {MOE_TRAIN_DEPTH - 1} MoE), "
          f"L={L}, K=4, B=8, S=64")
    moe_train_counts, moe_step_ms = full_width_training(
        torch, ops, dataclasses.replace(get_config(MOE_ARCH),
                                        num_layers=MOE_TRAIN_DEPTH),
        ops_by_shape=MOE_OPS)
    nonzero = lambda c: {k: v for k, v in c.items() if v}  # noqa: E731
    print(f"  phase 16 in {time.perf_counter() - t16:.1f} s; launches on "
          f"the MoE paths: serving {nonzero(moe_serve_counts)}, training "
          f"{nonzero(moe_train_counts)} ({moe_step_ms:.1f} ms a meta step)")

    t17 = time.perf_counter()
    stamp(f"phase 17a: the hybrid and SSM families card vs CPU, reduced "
          f"{', '.join(FAMILY_ARCHS)} float32, then 2 M-AVG meta steps of "
          f"each, L={L}")
    with full_f32(torch):
        families_card_vs_cpu(torch, ops, FAMILY_ARCHS, FAMILY_ARCHS)
    family_counts = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        stamp(f"phase 17b: serving full-width {arch}, {cfg.num_layers} "
              f"layers, B={SERVE_B}, {SERVE_PROMPT}-token prompt, "
              f"{SERVE_NEW} greedy tokens")
        serve_counts_17 = serving_family_full_width(torch, ops, arch)
        depth = FAMILY_TRAIN_DEPTH[arch]
        stamp(f"phase 17c: full-width {arch} M-AVG trainer ({depth} of "
              f"{cfg.num_layers} layers), L={L}, K=4, B=8, S=64, "
              f"{FAMILY_TRAIN_STEPS} meta steps")
        counts, step_ms = full_width_training(
            torch, ops, dataclasses.replace(cfg, num_layers=depth),
            steps=FAMILY_TRAIN_STEPS, local_profile=True)
        family_counts[arch] = (serve_counts_17, counts, step_ms)
    print(f"  phase 17 in {time.perf_counter() - t17:.1f} s; launches on "
          f"the hybrid and SSM paths: " + "; ".join(
              f"{arch} serving {nonzero(sc)}, training {nonzero(tc)} "
              f"({ms:.1f} ms a meta step)"
              for arch, (sc, tc, ms) in family_counts.items()))

    t18 = time.perf_counter()
    stamp("phase 18a: the card's memory, bf16 and TF32 matmul rates")
    measured_rates(torch)
    stamp(f"phase 18b: the cost model (roofline.cost.jit_cost) of phase "
          f"4's meta step ({DEPTH} layers, L={L}) against the card")
    cost_counts, cost_inputs = cost_against_the_card(torch, ops)
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        stamp(f"phase 18c: launch/train.py --obs-cost, {COST_STEPS} meta "
              f"steps, reduced model, JSONL sink")
        obs_cost_launcher(torch, Path(tmp))
        stamp("phase 18d: run.py --only kernel pack on the card")
        cost_benches(torch, ops, Path(tmp))
    print(f"  phase 18 in {time.perf_counter() - t18:.1f} s; launches on "
          f"the costed step {nonzero(cost_counts)}")

    t19 = time.perf_counter()
    stamp("phase 19a: phase 18b's step placed on a (1, 1) DeviceMesh, "
          "costed as the dry run costs a rank")
    placed_cost_on_a_1x1_mesh(cost_inputs)
    del cost_inputs
    stamp(f"phase 19b: the placed meta step on a one-GPU NCCL "
          f"DeviceMesh ({DEPTH} layers), {PLACED_STEPS} meta steps "
          f"against the unplaced step ({', '.join(PLACED_CONFIGS)}; "
          f"mavg_mlocal printed in 20b; in one process)")
    placed_runs = placed_steps_on_the_card()
    for name in PLACED_CONFIGS:
        if name != "mavg_mlocal":
            print_placed(placed_runs[name])
    placed_counts = {name: placed_runs[name]["placed"]
                     for name in PLACED_KERNELS}
    stamp(f"phase 19c: the dry run of the (32, 8) H100 mesh, "
          f"{len(DRYRUN_ROWS)} rows, and run.py --only roofline")
    dry_run_rows(dry_run)
    print(f"  phase 19 in {time.perf_counter() - t19:.1f} s; launches on "
          f"the new placed steps {placed_counts}")

    t20 = time.perf_counter()
    stamp(f"phase 20a: block remat on the card: full-width Qwen3-1.7B, 28 "
          f"layers, one local step (B={REMAT_B}, S={REMAT_S}) under full, "
          f"dots and everything")
    remat_on_the_card(torch)
    stamp(f"phase 20b: the placed mavg_mlocal meta step on a one-GPU NCCL "
          f"DeviceMesh, {PLACED_STEPS} meta steps against the unplaced "
          f"step (run in 19b's process)")
    print_placed(placed_runs["mavg_mlocal"])
    mlocal_counts = placed_runs["mavg_mlocal"]["placed"]
    stamp(f"phase 20c: jit_cost of phase 9's robust step and of a guarded "
          f"step ({DEPTH} layers, L={L}) against the card")
    costed_counts = costed_steps_on_the_card(torch, ops)
    print(f"  phase 20 in {time.perf_counter() - t20:.1f} s; launches: "
          f"placed mavg_mlocal {mlocal_counts}, costed robust step "
          f"{costed_counts}")

    join_side(host, stamp)

    # each kernel's launches in the run of the path it serves: the dense
    # and compressed full-width runs, the reduced per-leaf runs, the gossip
    # run (whose time-varying graph takes the stepped entry), the reduced
    # gossip runs on static or elastic-masked matrices, the robust run, the
    # full-width serving run (bf16 flash) and one prefill of the
    # full-width f32 serving run (f32 flash)
    launches = dict(
        fused_momentum_broadcast=dense_counts["fused_momentum_broadcast"],
        sgd_apply=dense_counts["sgd_apply"],
        pack_update=comm_counts["pack_update"],
        block_momentum=leaf_counts["block_momentum"],
        quantize=leaf_counts["quantize"],
        dequantize=leaf_counts["dequantize"],
        pack_compress=gossip_counts["pack_compress"],
        neighbor_mix=topo_counts["neighbor_mix"],
        neighbor_mix_stepped=gossip_counts["neighbor_mix_stepped"],
        # the windowed entry of the placed gossip step (19b; on one rank
        # its window is the square (0, L), counted under neighbor_mix)
        neighbor_mix_window=placed_counts["gossip"]["neighbor_mix"],
        robust_reduce=robust_counts["robust_reduce"],
        flash_attention=serve_counts["flash_attention"],
        flash_attention_f32=f32_serve_counts["flash_attention_f32"])
    for r in records:
        r.update(route="cuda", launches=launches[r["name"]])
        assert r["launches"] > 0, r
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(side(sys.argv[2], float(sys.argv[3]))
             if sys.argv[1:2] == ["--side"] else main())
