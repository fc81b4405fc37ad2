"""The dry-run CLI (the JAX package's ``launch/dryrun.py``): one rank's
program of every (architecture x input shape) pair on the single (32 x 8
= 256 GPUs) and multi (2 x 32 x 8 = 512 GPUs) H100 production meshes,
costed on the meta device, with per-combination JSON (roofline terms
included) written to ``build/dryrun/``.

JAX's CLI sets ``XLA_FLAGS`` for 512 host devices before any import; the
port starts a fake process group of each mesh's size in this process
only (``launch/dryrun_lib.py::fake_mesh``), so nothing else that imports
the library sees one. Every number is modeled (``dryrun_lib`` says how);
none is measured. ``--save-hlo`` has no counterpart (there is no
compiled module) and raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback


def main(argv=None) -> int:
    from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch import dryrun_lib as D

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None,
                    help="arch ids (default: all)")
    ap.add_argument("--shape", nargs="*", default=None,
                    help="input shapes (default: all)")
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--hierarchical", action="store_true",
                    help="pod-level learners + FSDP inside pods (multi only)")
    ap.add_argument("--algorithm", default="mavg")
    ap.add_argument("--tp-mode", default="megatron",
                    choices=["megatron", "fsdp", "dp"])
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--variant", default="",
                    help="label suffix for perf-iteration results")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "everything"],
                    help="activation-checkpoint policy of the dense and MoE "
                         "blocks in train rows (models.transformer."
                         "set_remat_policy)")
    ap.add_argument("--mlstm-chunk", type=int, default=0,
                    help="chunkwise-parallel mLSTM chunk length (0=recurrent)")
    ap.add_argument("--k", type=int, default=2,
                    help="K local steps per meta-step in the costed program")
    ap.add_argument("--expert-axis", default="",
                    help="pin the MoE expert tables to this mesh axis")
    ap.add_argument("--expert-shard-map", action="store_true",
                    help="manual expert parallelism (serve only)")
    ap.add_argument("--no-serve-fsdp", action="store_true",
                    help="replicate serve weights over data (perf probe)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--save-hlo", action="store_true")
    args = ap.parse_args(argv)

    if args.save_hlo:
        raise SystemExit("--save-hlo has no counterpart in the port: it runs "
                         "eagerly and compiles no module to save")
    from repro_torch.models import transformer

    transformer.set_remat_policy(args.remat)
    if args.mlstm_chunk:
        from repro_torch.models import xlstm

        xlstm.set_mlstm_chunk(args.mlstm_chunk)
    if args.expert_axis:
        from repro_torch.models import moe

        moe.set_expert_axis(args.expert_axis)
    if args.no_serve_fsdp:
        from repro_torch.launch import specs

        specs.SERVE_FSDP_ENABLED = False

    archs = args.arch or ARCH_IDS
    shapes = args.shape or list(INPUT_SHAPES)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in args.mesh:
                if args.hierarchical and mesh != "multi":
                    continue
                mode = "hier" if args.hierarchical else "faithful"
                if args.variant:
                    mode = f"{mode}+{args.variant}"
                path = D.result_path(arch, shape, mesh, mode, args.algorithm)
                if args.skip_existing and os.path.exists(path):
                    print(f"SKIP (exists) {arch} {shape} {mesh} {mode}")
                    continue
                print(f"=== {arch} x {shape} x {mesh} ({mode}) ===",
                      flush=True)
                try:
                    res = D.run_one(
                        arch, shape, mesh, hierarchical=args.hierarchical,
                        algorithm=args.algorithm, tp_mode=args.tp_mode,
                        compute_dtype=args.compute_dtype,
                        variant=args.variant, k_steps=args.k,
                        expert_shard_map=args.expert_shard_map,
                    )
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mesh, str(e)))
                    continue
                if res.get("skipped"):
                    print(f"  SKIPPED: {res['reason']}")
                else:
                    print(f"  memory: {json.dumps(res['memory'])}")
                    cost = res["cost"]
                    print(f"  cost: flops={cost['flops']:.3e} "
                          f"bytes={cost['bytes accessed']:.3e}")
                    print(f"  collectives: "
                          f"{json.dumps(res['collectives']['by_type'])} "
                          f"by axes {json.dumps(res['collectives']['by_axes'])}")
                    r = res["roofline"]
                    print(f"  roofline (modeled): compute={r['compute_s']:.4g}s "
                          f"memory={r['memory_s']:.4g}s "
                          f"collective={r['collective_s']:.4g}s "
                          f"-> {r['bottleneck']}-bound "
                          f"(useful_ratio={r['useful_ratio']:.3f})")
                    print(f"  counted in {res['lower_s']}s")
                print(f"  wrote {D.save_result(res, args.algorithm)}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nAll requested dry-run combinations costed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
