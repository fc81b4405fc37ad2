"""The port's runners of E4 (``repro_torch.benchmarks.baselines``), the
async bench and the chaos bench (``async_bench``, ``chaos_bench``)
against the JAX package's ``benchmarks/baselines.py``,
``async_bench.py`` and ``chaos_bench.py``.

* The settings are the reference's, case for case.
* The eamsgd and downpour arms of E4 and the async bench's async arm,
  fed the JAX runner's own inputs, give JAX's per-step losses within
  rtol 1e-5 (the local phase differs by a few ulps between XLA:CPU and
  ATen) and its staleness exactly.
* Each runner passes the reference's assertions on the CPU at smoke size
  (quick mode) on the port's own streams.

E4's departure, pinned here: downpour runs no local step on its first
two ticks (no clock has filled), both packages report loss 0 there, and
the reference's running minimum reads that 0 as reaching the 1.1 target
at 128 samples, which fails the reference's own assertion; the port's E4
skips those ticks (``baselines.idle_ticks``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import async_bench as jasync_bench  # noqa: E402
from benchmarks import baselines as jbaselines  # noqa: E402
from benchmarks.common import run_mlp as jrun_mlp  # noqa: E402
from benchmarks.common import samples_to_target as jstt  # noqa: E402
from repro.data import classif_batch_fn, classif_eval_set  # noqa: E402
from repro.models.simple import mlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    async_bench,
    baselines,
    chaos_bench,
    common,
)

torch.set_num_threads(2)


def _jax_inputs(P, K, B, steps, seed=0):
    """The JAX runners' own inputs: the seed's init, fold_in(PRNGKey(seed
    + 1), i) batches and the evaluation set, as numpy."""
    params = jax.device_get(mlp_init(jax.random.PRNGKey(seed), common.D_IN,
                                     common.HIDDEN, common.CLASSES))
    bf = classif_batch_fn(common.D_IN, common.CLASSES, P, K, B)
    batches = [jax.device_get(bf(jax.random.fold_in(
        jax.random.PRNGKey(seed + 1), i), i)) for i in range(steps)]
    ev = jax.device_get(classif_eval_set(common.D_IN, common.CLASSES))
    return (interop.params_from_jax(params),
            lambda i: interop.params_from_jax(batches[i]),
            interop.params_from_jax(ev))


def test_settings_are_the_references():
    assert baselines.CASES == jbaselines.CASES
    for algo, _ in baselines.CASES:
        st = baselines.settings(algo, quick=True)
        assert st["K"] == (1 if algo == "sync" else 4)
        assert st["steps"] == (160 if algo == "sync" else 40)
        assert (st["P"], st["lr"], st["batch"]) == (4, 0.15, 8)
    assert baselines.TARGET == 1.1
    assert (async_bench.P, async_bench.K, async_bench.MU, async_bench.LR,
            async_bench.BATCH) == (jasync_bench.P, jasync_bench.K,
                                   jasync_bench.MU, jasync_bench.LR,
                                   jasync_bench.BATCH)
    assert async_bench.PROFILE == jasync_bench.PROFILE
    assert async_bench.TAU == jasync_bench.TAU
    assert (chaos_bench.P, chaos_bench.K, chaos_bench.MU, chaos_bench.LR,
            chaos_bench.BATCH, chaos_bench.TAU) == (4, 4, 0.7, 0.2, 16, 2)


@pytest.mark.parametrize("algo", ["eamsgd", "downpour"])
def test_baseline_arm_fed_jax_inputs_matches_jax(algo):
    kw = dict(baselines.CASES)[algo]
    st = baselines.settings(algo, quick=True)
    jlosses, jacc = jrun_mlp(algo, **st, **kw)
    params, batch_at, ev = _jax_inputs(st["P"], st["K"], st["batch"],
                                       st["steps"])
    losses, acc = common.run_mlp(algo, **st, **kw, device="cpu",
                                 params=params, batch_at=batch_at,
                                 eval_set=ev)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-7)
    assert abs(acc - jacc) <= 1 / 2048 + 1e-9
    idle = baselines.idle_ticks(algo, st, kw)
    if algo == "downpour":
        # the warmup ticks: no step ran, loss 0 in both packages, and the
        # reference's metric "reaches" the target there
        assert idle[:2] == [True, True] and not any(idle[2:])
        assert jlosses[:2] == [0.0, 0.0]
        assert jstt(jlosses, baselines.TARGET, 4, 4, 8) == 128
    else:
        assert not any(idle)
    measured = [float("nan") if i else x for x, i in zip(losses, idle)]
    stt = common.samples_to_target(measured, baselines.TARGET, 4, 4, 8)
    assert stt is not None and stt > 128


def test_e4_quick_passes_on_the_port(capsys):
    results = baselines.main(quick=True, device="cpu")
    assert list(results) == [a for a, _ in baselines.CASES]
    out = capsys.readouterr().out
    assert out.count("baselines,") == 6
    mavg = results["mavg"][2]
    for other in ("downpour", "eamsgd"):
        if results[other][2]:
            assert mavg <= 1.5 * results[other][2]


def test_async_arm_fed_jax_inputs_matches_jax():
    ticks = async_bench.async_ticks(15 * async_bench.P)
    assert ticks == 23
    jl, jacc, jm, jtopo = jasync_bench._run(_jax_async_topology(), ticks)
    params, batch_at, _ = _jax_inputs(async_bench.P, async_bench.K,
                                      async_bench.BATCH, ticks)
    losses, acc, metrics, topo = async_bench.run_arm(
        async_bench.ASYNC_TOPOLOGY, ticks, device="cpu", params=params,
        batch_at=batch_at)
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-7)
    for k in ("staleness_max", "fired_count"):
        assert [m[k] for m in metrics] == [m[k] for m in jm], k
    assert topo.work_completed(ticks - 1) == jtopo.work_completed(ticks - 1)
    assert max(m["staleness_max"] for m in metrics) <= async_bench.TAU


def _jax_async_topology():
    from repro.configs.base import AsyncConfig, TopologyConfig

    return TopologyConfig(kind="async", server=AsyncConfig(
        staleness=jasync_bench.TAU, step_time=jasync_bench.PROFILE))


def test_async_bench_quick_passes_on_the_port():
    rows = async_bench.main(quick=True, device="cpu")
    assert [r.get("cell") for r in rows[:3]] == [
        "sync_barrier", "async_skew4x", "elastic_mask25"]
    assert [r["kind"] for r in rows[3:]] == ["async_accept"] + 3 * [
        "async_model"]
    accept = rows[3]
    assert accept["loss_vs_sync_at_equal_samples"] <= 1.05
    assert accept["staleness_max"] <= 3 and accept["staleness_bounded"]
    assert accept["sync_idle_frac"] == 0.5
    assert accept["wall_clock_speedup"] == pytest.approx(60 / 23)
    # equal effective samples: the async arm completed the sync arm's
    # 120 blocks
    assert rows[1]["effective_samples"] >= rows[0]["effective_samples"]


def test_chaos_bench_quick_passes_on_the_port(tmp_path):
    rows = chaos_bench.main(quick=True, device="cpu",
                            workdir=str(tmp_path))
    cells = {r.get("cell"): r for r in rows}
    accept = rows[-1]
    assert accept["ok"] and accept["within_5pct"]
    assert accept["state_finite"] and accept["bitwise_off"]
    assert accept["resume_verified"] and accept["retries_used"] == 1
    # the supervised run's completed blocks follow the schedule (crash
    # window, straggle spike, then the retry's quarantine): 87 blocks of
    # 64 samples, as JAX's chaos bench reports in quick mode
    assert cells["chaos_supervised"]["effective_samples"] == 87 * 64
    assert cells["fault_free"]["effective_samples"] == 24 * 4 * 64
    assert cells["chaos_supervised"]["faults_injected"] == 6
