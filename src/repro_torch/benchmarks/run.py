"""The benchmark harness's entry point on the port (the JAX package's
``benchmarks/run.py``): one module per paper table or figure.

  E1 convergence.py     Figures 1-6, Table I (M-AVG vs K-AVG, 3 models)
  E2 mu_p_sweep.py      Figures 9-12, Lemma 6 (optimal mu grows with P)
  E3 k_sweep.py         Lemmas 5 and 7 (optimal K > 1; momentum shrinks K)
  E4 baselines.py       section IV baselines (Downpour, EAMSGD, sync)
  C  comm_bench.py      meta-communication compression (repro_torch.comm)
  T  topology_bench.py  meta-mixing topologies x comm
  L  elastic_bench.py   elastic membership, hetero-K, time-varying gossip
  A  async_bench.py     the async bounded-staleness server vs the barrier
  X  chaos_bench.py     fault injection and supervised recovery
  B  robust_bench.py    robust aggregation under sticky corruption
     ablations.py       block-momentum flavours

The reference's ``kernel``, ``pack`` and ``roofline`` suites read XLA's
compiled cost and a TPU dry run; they are not ported (ROADMAP Queue 1,
item 10). Naming one in ``--only`` raises; a default run prints that it
was not run, and why.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--only k mu_p ...] \\
      [--full] [--device cpu] [--bench-dir build/bench_out]

Quick mode is the default, as in the reference; ``--full`` runs the full
settings. A suite fails when it raises (its assertions) or returns a row
with ``"ok": False``; the run then exits non-zero after every suite ran.
Each suite that returns result rows (a list of dicts) has them appended,
in the ``row_kind`` envelope, to ``<bench-dir>/BENCH_<suite>.json``
(``obs.baseline``), the store ``tools/bench_compare.py`` gates against
``benchmarks/expected/``; ``--bench-dir ''`` disables the stores.

Where the port departs from the reference: a suite whose result is a
table rather than rows (E1-E3, E4, the ablations, comm) gets no store.
The reference appends the table as a row, which fails the E2 and E3
suites after they ran (their keys are tuples and ints, which
``json.dumps(sort_keys=True)`` cannot order beside "kind") and stores an
empty point for the ablations.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

# suites of the reference that read XLA's compiled cost or a TPU dry run
NOT_PORTED = {
    "kernel": "benchmarks/kernel_bench.py reads XLA's compiled cost",
    "pack": "benchmarks/pack_bench.py reads XLA's compiled cost",
    "roofline": "benchmarks/roofline_table.py aggregates the TPU dry run",
}
ITEM_10 = "ROADMAP Queue 1, item 10: the layers tied to the TPU"
DEFAULT_BENCH_DIR = "build/bench_out"


def suites(quick: bool, device: str) -> dict:
    """Suite name -> a callable running it (the reference's names)."""
    from repro_torch.benchmarks import (
        ablations,
        async_bench,
        baselines,
        chaos_bench,
        comm_bench,
        convergence,
        elastic_bench,
        k_sweep,
        mu_p_sweep,
        robust_bench,
        topology_bench,
    )

    return {
        "comm": lambda: comm_bench.main(quick=quick, device=device),
        "topology": lambda: topology_bench.main(quick=quick, device=device),
        "elastic": lambda: elastic_bench.main(quick=quick, device=device),
        "async": lambda: async_bench.main(quick=quick, device=device),
        "chaos": lambda: chaos_bench.main(quick=quick, device=device),
        "robust": lambda: robust_bench.main(quick=quick, device=device),
        "convergence": lambda: convergence.main(quick=quick, device=device),
        "baselines": lambda: baselines.main(quick=quick, device=device),
        "k": lambda: k_sweep.main(quick=quick, device=device),
        "mu_p": lambda: mu_p_sweep.main(quick=quick, device=device),
        "ablations": lambda: ablations.main(quick=quick, device=device),
    }


def result_rows(result) -> list[dict] | None:
    """The rows a suite returned, or None when it returned a table."""
    if isinstance(result, list) and all(isinstance(r, dict)
                                        for r in result):
        return result
    return None


def store(bench_dir: str, name: str, rows: list[dict]) -> str:
    """Append the ``common.envelope`` of ``rows`` to the suite's
    trajectory store."""
    from repro_torch.benchmarks.common import envelope
    from repro_torch.obs.baseline import append_trajectory, trajectory_path

    path = trajectory_path(bench_dir, name)
    append_trajectory(path, name, envelope(rows))
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="explicit form of the default (smoke-sized "
                         "suites); mutually exclusive with --full")
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset: convergence mu_p k baselines comm "
                         "topology elastic async chaos robust ablations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--bench-dir", default=DEFAULT_BENCH_DIR,
                    help="directory of the BENCH_<suite>.json trajectory "
                         "stores ('' = don't append)")
    args = ap.parse_args(argv)
    if args.full and args.quick:
        ap.error("--full and --quick are mutually exclusive")
    quick = not args.full

    table = suites(quick, args.device)
    if args.only:
        refused = [s for s in args.only if s in NOT_PORTED]
        if refused:
            raise NotImplementedError(
                f"suites {refused} are not ported: " + "; ".join(
                    NOT_PORTED[s] for s in refused) + f" ({ITEM_10})")
        unknown = [s for s in args.only if s not in table]
        if unknown:
            ap.error(f"unknown suites {unknown}")
        table = {k: v for k, v in table.items() if k in args.only}
    else:
        for name, why in NOT_PORTED.items():
            print(f"bench,{name},not run: {why} ({ITEM_10})")

    failed = []
    for name, fn in table.items():
        print(f"\n===== bench:{name} =====", flush=True)
        t0 = time.time()
        try:
            rows = result_rows(fn())
            # a failing cell fails the run even if the suite didn't raise
            bad = [r for r in rows or () if r.get("ok") is False]
            if bad:
                raise SystemExit(f"{len(bad)} cell(s) not ok")
            if args.bench_dir and rows:
                print(f"bench,{name},trajectory,"
                      f"{store(args.bench_dir, name, rows)}")
            elif args.bench_dir:
                print(f"bench,{name},trajectory,none (a table, no rows)")
            print(f"bench,{name},{(time.time() - t0) * 1e6:.0f},ok")
        except (Exception, SystemExit) as e:
            if not isinstance(e, SystemExit):
                traceback.print_exc()
            failed.append(name)
            print(f"bench,{name},{(time.time() - t0) * 1e6:.0f},FAILED ({e})")
    if failed:
        sys.exit(f"FAILED suites: {failed}")


if __name__ == "__main__":
    main()
