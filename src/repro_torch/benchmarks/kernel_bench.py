"""Kernel micro-benchmarks (the JAX package's ``benchmarks/kernel_bench.py``,
on the port's kernels and its cost model).

What it shows, as the reference's:

1. *Launch and padding collapse* of the packed meta plane
   (``meta_plane_rows``): per-leaf launches per meta op against one
   packed launch, and the per-leaf (rows, 128) padding against the packed
   layout's, on the meta-device params of llama3-405b, qwen1.5-110b,
   xlstm-350m and hymba-1.5b (nothing is allocated, so the full-scale
   numbers are exact).
2. *The HBM passes* of the fused updates (the reference's structural
   rows).
3. *Measured against modeled* (``attribution_rows``): ``pack_update``,
   ``fused_momentum_broadcast``, ``neighbor_mix`` and ``quantize``, each
   timed in steady state (``obs.profile``) and joined with its modeled
   cost (``roofline.cost.jit_cost``: the kernel's declared bytes, each
   input read and each output written once), giving achieved GB/s and
   the share of the measured peak. On the card these are the
   hand-written kernels; on the CPU their plain versions, and the rows
   say which (``route``).
4. *Kernel against plain version*: the fused momentum-broadcast (bf16
   learners) and flash attention, on the card the kernels against their
   plain versions within the reference's limits (1e-5 and 5e-3); on the
   CPU both sides are the plain version.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --quick \\
      [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import steady, write_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_meta as fm
from repro_torch.kernels import ops
from repro_torch.kernels.planes import layout

# the real configs the packed meta plane targets (the leafiest and the
# padding-heaviest)
LAUNCH_COUNT_ARCHS = ("llama3-405b", "qwen1.5-110b", "xlstm-350m",
                      "hymba-1.5b")
# per-leaf meta-phase kernel launches per op family (block momentum,
# quantize, dequantize each launched once per leaf; packed once)
META_OPS = ("block_momentum", "quantize", "dequantize")


def per_leaf_pad_waste(spec) -> int:
    """Padded elements of the per-leaf layout: each leaf padded on its own
    to a (rows, 128) plane with rows % 8 == 0."""
    return sum(layout(n)[1] for n in spec.sizes)


def meta_plane_rows(quick: bool = False) -> list[dict]:
    """Meta-phase launch count and padding waste, per-leaf against packed,
    on the meta-device params of the real configs."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.pack import make_pack_spec

    del quick  # shapes only: free at any scale
    rows = []
    for arch in LAUNCH_COUNT_ARCHS:
        spec = make_pack_spec(api.init_params(None, get_config(arch),
                                              "meta"))
        per_leaf = per_leaf_pad_waste(spec)
        rows.append({
            "kind": "meta_plane", "arch": arch,
            "n_leaves": spec.num_leaves,
            "launches_per_op_per_leaf": spec.num_leaves,
            "launches_per_op_packed": 1,
            "launch_reduction": spec.num_leaves,
            "pad_waste_elems_per_leaf": per_leaf,
            "pad_waste_elems_packed": spec.pad_waste,
            "params": sum(spec.sizes),
            "packed_rows": spec.rows,
            "ok": spec.pad_waste <= per_leaf,
        })
        r = rows[-1]
        print(f"kernel,meta_launches_per_op,{arch},"
              f"{r['launches_per_op_per_leaf']}->1")
        print(f"kernel,meta_pad_waste_elems,{arch},"
              f"{r['pad_waste_elems_per_leaf']}->"
              f"{r['pad_waste_elems_packed']}")
    return rows


def route(device) -> str:
    """What a wrapper runs on ``device``."""
    return ("cuda kernel" if torch.device(device).type == "cuda"
            else "plain version (cpu)")


def attribution_rows(quick: bool = False, device="cuda") -> list[dict]:
    """Measured against modeled: each kernel timed in steady state and
    joined with its ``jit_cost`` (one call of the kernel, its declared
    bytes), achieved GB/s and the share of the measured peak."""
    from repro_torch.obs.profile import attribution_row, measured_peak_gbps
    from repro_torch.roofline.cost import jit_cost

    gen = torch.Generator(device=device).manual_seed(3)
    rows_n, L = (1024, 4) if quick else (8192, 8)
    peak = measured_peak_gbps(device=device)
    print(f"kernel,attr,measured_peak_gbps,{peak:.1f}")

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    gp, v, a = (normal(rows_n, 128) for _ in range(3))
    lrn = normal(L, rows_n, 128, scale=0.1)
    u = torch.rand((L, rows_n, 128), generator=gen, device=device)
    u2 = torch.rand((rows_n, 128), generator=gen, device=device)
    # degree-2 ring mixing matrix (doubly stochastic), on the host
    eye = np.eye(L, dtype=np.float32)
    ring = (0.5 * eye + 0.25 * np.roll(eye, 1, 0)
            + 0.25 * np.roll(eye, -1, 0))

    targets = [
        ("pack_update", "pack_update",
         lambda lrn, gp, u: ops.pack_update(lrn, gp, None, u), (lrn, gp, u)),
        ("fused_meta", "fused_momentum_broadcast",
         lambda gp, v, a: ops.fused_momentum_broadcast(
             gp, v, a, mu=0.9, eta=1.0, num_learners=L,
             ldtype=torch.float32), (gp, v, a)),
        ("neighbor_mix", "neighbor_mix",
         lambda lrn: ops.neighbor_mix(lrn, ring), (lrn,)),
        ("quantize", "quantize",
         lambda gp, u2: ops.quantize(gp, lambda shape: u2)[:2], (gp, u2)),
    ]
    iters, warmup = (5, 2) if quick else (20, 3)
    rows = []
    for op, kernel, fn, args in targets:
        cost = jit_cost(fn, *args)
        timing = steady(fn, *args, iters=iters, warmup=warmup)
        row = attribution_row(op, timing, cost, peak_gbps=peak,
                              device=device,
                              extra={"rows": rows_n, "learners": L,
                                     "route": route(device),
                                     "kernel_calls": cost.kernel_calls})
        row["ok"] = cost.kernel_calls == {kernel: 1}
        rows.append(row)
        print(f"kernel,attr,{op},{row['median_us']:.1f}"
              f"±{row['iqr_us']:.1f}us,"
              f"{row['achieved_gbps']:.1f}GB/s,"
              f"{row['pct_of_bound']:.0f}%of_bound,{row['route']}")
    return rows


def main(quick: bool = False, device="cuda",
         json_path: str | None = None) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(0)
    n = 1 << 16 if quick else 1 << 20
    w, v, a = (torch.randn((n // 128, 128), generator=gen, device=device)
               for _ in range(3))

    # unfused: four separate ATen passes (what a naive meta update does),
    # against the block-momentum kernel (its plain version on the CPU)
    def unfused(w, v, a):
        d = a - w
        v2 = 0.9 * v
        v2 = v2 + d
        return w + v2, v2

    def fused(w, v, a):
        return ops.block_momentum(w, v, a, mu=0.9, eta=1.0)

    t_unfused = steady(unfused, w, v, a)
    t_fused = steady(fused, w, v, a)
    print(f"kernel,block_momentum_unfused_aten,"
          f"{t_unfused.median_us:.1f}±{t_unfused.iqr_us:.1f},us")
    print(f"kernel,block_momentum_{route(device).split()[0]},"
          f"{t_fused.median_us:.1f}±{t_fused.iqr_us:.1f},us")

    # analytic HBM passes (the roofline argument for the kernel): naive =
    # 4 reads (w, v, a, and the materialized d) + 2 writes; fused = 3
    # reads + 2 writes, all f32
    bytes_naive = (4 + 2) * 4 * n
    bytes_fused = (3 + 2) * 4 * n
    print(f"kernel,block_momentum_hbm_bytes_naive,{bytes_naive},bytes")
    print(f"kernel,block_momentum_hbm_bytes_fused,{bytes_fused},bytes")

    rows = meta_plane_rows(quick=quick)
    rows.append({
        "kind": "hbm_passes", "op": "block_momentum",
        "bytes_naive": bytes_naive, "bytes_fused": bytes_fused,
        "passes_naive": 6, "passes_fused": 5,
    })
    rows.append({
        # displacement pass + EF-add pass + quantize pass over the plane
        # (2 reads + 1 write each) vs one 4-read / 3-write pass
        "kind": "hbm_passes", "op": "pack_update",
        "passes_naive": 9, "passes_fused": 7,
    })
    rows.append({
        # block momentum (3R+2W of the meta plane) + the broadcast's
        # re-read of w~' (1R) in one pass; the L learner writes are on
        # both sides and left out
        "kind": "hbm_passes", "op": "fused_momentum_broadcast",
        "passes_naive": 6, "passes_fused": 5,
        "plane_reads_removed": 1,
    })
    rows.append({
        # the compress-only kernel reads no zero meta plane; without
        # error feedback it writes no err plane either
        "kind": "hbm_passes", "op": "pack_compress",
        "passes_naive": 6, "passes_fused": 5, "passes_fused_no_ef": 4,
        "plane_reads_removed": 1,
    })
    for r in rows[-2:]:
        print(f"kernel,hbm_passes,{r['op']},"
              f"{r['passes_naive']}->{r['passes_fused']}")

    rows += attribution_rows(quick=quick, device=device)

    # the fused momentum-broadcast against its plain version (bf16
    # learners)
    rows_n, L = (64, 4) if quick else (512, 8)
    w2, v2, a2 = (torch.randn((rows_n, 128), generator=gen, device=device)
                  for _ in range(3))
    got = ops.fused_momentum_broadcast(w2, v2, a2, mu=0.9, eta=1.0,
                                       num_learners=L,
                                       ldtype=torch.bfloat16)
    want = fm.fused_momentum_broadcast_plain(w2, v2, a2, 0.9, 1.0, L,
                                             torch.bfloat16)
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    print(f"kernel,fused_momentum_broadcast_vs_plain_maxerr,{err:.2e},abs")
    rows.append({"kind": "kernel_parity", "op": "fused_momentum_broadcast",
                 "route": route(device), "max_abs_err": err,
                 "ok": err < 1e-5})

    # flash attention against its plain version, causal, f32
    B, S, H, KV, D = (1, 128, 4, 2, 64) if quick else (1, 512, 8, 2, 128)
    q, k, vv = (torch.randn((B, S, h, D), generator=gen,
                            device=device).mul_(0.3)
                for h in (H, KV, KV))
    plain = lambda q, k, v: fa.flash_attention_bshd_plain(  # noqa: E731
        q, k, v, causal=True)
    t_plain = steady(plain, q, k, vv, iters=3, warmup=1)
    print(f"kernel,attention_plain,"
          f"{t_plain.median_us:.1f}±{t_plain.iqr_us:.1f},us")
    out = ops.flash_attention(q, k, vv, causal=True)
    err = float((out - plain(q, k, vv)).abs().max())
    print(f"kernel,flash_attention_vs_plain_maxerr,{err:.2e},abs")
    rows.append({"kind": "kernel_parity", "op": "flash_attention",
                 "route": route(device), "max_abs_err": err,
                 "ok": err < 5e-3})

    if json_path:
        write_rows(json_path, rows, suite="kernel_bench")
        print(f"kernel,json,{json_path},written")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    main(quick=args.quick, device=args.device, json_path=args.json)
