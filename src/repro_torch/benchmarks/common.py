"""Shared helpers of the port's benchmark runners: the teacher-
classification MLP run, the samples-to-target metric, the ``--json`` row
writer and the steady-state timer, as in the JAX package's
``benchmarks/common.py``."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.core.meta import init_state, make_meta_step
from repro_torch.data import classif_batch_fn, classif_eval_set
from repro_torch.models.simple import mlp_accuracy, mlp_init, mlp_loss
from repro_torch.pack import unpack_params
from repro_torch.topology import make_topology
from repro_torch.utils.rng import seeded_generator

D_IN, CLASSES, HIDDEN = 32, 10, 64


def train_curve(loss_fn: Callable, cfg: MAvgConfig, params, batch_at,
                steps: int, dither=None) -> tuple[list[float], object]:
    """Drive ``steps`` meta steps of ``make_meta_step(loss_fn, cfg)`` from
    ``params`` on the batches ``batch_at(i)``; returns the per-step mean
    local losses (read back once, at the end) and the final state.
    ``dither`` replaces the quantizers' dither source (a parity test
    passes JAX's, through ``interop.dither_from_numpy``)."""
    topo = make_topology(cfg, dither=dither)
    state = init_state(params, cfg, topology=topo)
    step = make_meta_step(loss_fn, cfg, topology=topo)
    losses = []
    for i in range(steps):
        state, m = step(state, batch_at(i))
        losses.append(m["loss"])
    return [float(x) for x in torch.stack(losses).tolist()], state


def seeded_batches(batch_fn: Callable, seed: int, device) -> Callable:
    """``batch_at(i)``: ``batch_fn`` on a generator keyed on (seed, i), the
    port's counterpart of ``fold_in(PRNGKey(seed), i)``."""
    return lambda i: batch_fn(seeded_generator(device, seed, i), i)


def run_mlp(algorithm: str, *, P: int, K: int, mu: float, lr: float = 0.2,
            steps: int = 60, batch: int = 16, seed: int = 0,
            local_momentum: float = 0.0, staleness: int = 1,
            elastic_alpha: float = 0.05, comm=None, topology=None,
            device="cuda", params: Optional[dict] = None,
            batch_at: Optional[Callable] = None,
            eval_set: Optional[dict] = None, dither=None):
    """Train the teacher-classification MLP; returns (losses, val_acc).
    ``staleness`` is downpour's bound and ``elastic_alpha`` eamsgd's
    coupling (both aliases onto the async server). ``comm``: an optional
    CommConfig (default dense, exact averaging); ``topology``: an optional
    TopologyConfig (default the flat all-reduce).

    ``params``, ``batch_at(i)`` and ``eval_set`` replace the port's own
    initial params, batches and evaluation set, and ``dither`` the
    quantizers' dither source (a parity test passes JAX's, carried over
    with ``repro_torch.interop``); by default they are drawn from
    generators seeded on ``seed`` on ``device``.
    """
    extra = {} if comm is None else {"comm": comm}
    if topology is not None:
        extra["topology"] = topology
    cfg = MAvgConfig(algorithm=algorithm, num_learners=P, k_steps=K,
                     learner_lr=lr, momentum=mu,
                     local_momentum=local_momentum, staleness=staleness,
                     elastic_alpha=elastic_alpha, **extra)
    if params is None:
        params = mlp_init(seeded_generator(device, seed), D_IN, HIDDEN,
                          CLASSES, device=device)
    if batch_at is None:
        batch_at = seeded_batches(
            classif_batch_fn(D_IN, CLASSES, P, K, batch, device=device),
            seed + 1, device)
    losses, state = train_curve(mlp_loss, cfg, params, batch_at, steps,
                                dither)
    if eval_set is None:
        eval_set = classif_eval_set(D_IN, CLASSES, device=device)
    with torch.no_grad():
        acc = float(mlp_accuracy(unpack_params(state), eval_set))
    return losses, acc


def samples_to_target(losses, target: float, P: int, K: int, batch: int):
    """First sample count at which the running-min loss crosses target.

    This is the paper's speed-up metric (Lemma 4): M-AVG reaches a target
    with fewer samples than K-AVG. Returns None if never reached.
    """
    best = float("inf")
    for i, l in enumerate(losses):
        best = min(best, l)
        if best <= target:
            return (i + 1) * P * K * batch
    return None


def envelope(rows: list) -> list[dict]:
    """Result rows as run-log records: ``{"kind": "row", ...}``, a bench's
    own ``kind`` (its row taxonomy) moved to ``row_kind``, as in the
    reference. ``write_rows`` and ``run.store`` both write these."""
    recs = []
    for r in rows:
        rec = dict(r)
        if rec.get("kind") not in (None, "row"):
            rec["row_kind"] = rec.pop("kind")
        recs.append({"kind": "row", **rec})
    return recs


def write_rows(path: str, rows: list, suite: str) -> str:
    """The ``--json PATH`` writer the benches share: the run-log envelope
    of ``repro_torch.obs`` (a ``{"kind": "manifest", "suite": ...}`` first
    line, then the ``envelope`` of the rows), the stream
    ``tools/bench_compare.py`` reads."""
    from repro_torch.obs import JsonlSink, run_manifest

    sink = JsonlSink(path)
    sink.open_run(run_manifest(suite=suite))
    for rec in envelope(rows):
        sink.append(rec)
    sink.close()
    return path


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall clock of ``fn(*args)`` in us, through the shared
    steady-state harness (``obs.profile.steady_timeit``: warmup, a
    synchronize around each call on the card, median of N)."""
    return steady(fn, *args, iters=iters, warmup=warmup).median_us


def steady(fn, *args, iters: int = 10, warmup: int = 2):
    """The full ``obs.profile.Timing`` (median and IQR) of ``fn(*args)``."""
    from repro_torch.obs.profile import steady_timeit

    return steady_timeit(fn, *args, iters=iters, warmup=warmup)
