"""The port's timing harness and phase attribution
(``repro_torch.obs.profile``) against the JAX package's
``tests/test_obs_profile.py``, case for case.

Mirrored invariants (see tests/test_obs_profile.py): PRF1 steady_timeit
(warmup untimed, median and IQR over exactly ``iters``), PRF2 the
attribution arithmetic, PRF3 profile_fn end to end, PRF4 profile_phases
covers phase:step, phase:local and phase:meta_mix and leaves the passed
state as it was, PRF5 the measured peak is cached per size.

Where the port departs: profile_fn's modeled cost is the port's
(``roofline.cost.jit_cost`` on the meta device, the eager byte model), not
XLA's; JAX's own quantile and attribution arithmetic are the oracles of
the port's.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import profile as jprofile  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MAvgConfig,
    ObsConfig,
    TopologyConfig,
    TrainConfig,
)
from repro_torch.core.meta import init_state  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    measured_peak_gbps,
    profile_fn,
    profile_phases,
)
from repro_torch.obs import profile as tprofile  # noqa: E402
from repro_torch.obs.profile import (  # noqa: E402
    Timing,
    _quantile,
    attribution_row,
    steady_timeit,
)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# PRF1: the timing harness
# ---------------------------------------------------------------------------


def test_prf1_quantile_interpolation():
    assert _quantile([5.0], 0.5) == 5.0
    assert _quantile([1.0, 2.0, 3.0], 0.5) == 2.0
    assert _quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.5
    assert _quantile([0.0, 10.0], 0.25) == 2.5
    xs = sorted(np.random.default_rng(0).uniform(size=9).tolist())
    for q in (0.25, 0.5, 0.75):
        assert _quantile(xs, q) == jprofile._quantile(xs, q)


def test_prf1_steady_timeit_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1.0

    t = steady_timeit(fn, torch.tensor(1.0), iters=7, warmup=3)
    assert len(calls) == 10  # warmup + iters, nothing more
    assert t.n == 7 and t.warmup == 3 and len(t.times_s) == 7
    assert t.median_s > 0 and t.iqr_s >= 0
    assert t.median_us == pytest.approx(t.median_s * 1e6)
    assert min(t.times_s) <= t.median_s <= max(t.times_s)


def test_prf1_validates_arguments():
    with pytest.raises(AssertionError):
        steady_timeit(lambda: 0, iters=0)


# ---------------------------------------------------------------------------
# PRF2: the attribution join
# ---------------------------------------------------------------------------


def test_prf2_attribution_arithmetic():
    timing = Timing(median_s=2e-3, iqr_s=1e-4, n=5, warmup=2,
                    times_s=(2e-3,) * 5)
    cost = types.SimpleNamespace(hbm_bytes=40_000_000, flops=1_000_000)
    row = attribution_row("op_x", timing, cost, peak_gbps=100.0,
                          device="cpu", extra={"rows": 7})
    assert row["kind"] == "attribution" and row["op"] == "op_x"
    assert row["median_us"] == pytest.approx(2000.0)
    assert row["modeled_hbm_bytes"] == 40_000_000.0
    assert row["achieved_gbps"] == pytest.approx(20.0)
    assert row["pct_of_bound"] == pytest.approx(20.0)
    assert row["rows"] == 7
    assert row["backend"] == "cpu"
    jt = jprofile.Timing(median_s=2e-3, iqr_s=1e-4, n=5, warmup=2,
                         times_s=(2e-3,) * 5)
    jrow = jprofile.attribution_row("op_x", jt, cost, peak_gbps=100.0,
                                    extra={"rows": 7})
    assert {k: v for k, v in row.items() if k != "backend"} == {
        k: v for k, v in jrow.items() if k != "backend"}


def test_prf2_no_cost_no_bandwidth_fields():
    timing = Timing(median_s=1e-3, iqr_s=0.0, n=1, warmup=0, times_s=(1e-3,))
    row = attribution_row("op_y", timing, device="cpu")
    assert "achieved_gbps" not in row and "pct_of_bound" not in row
    assert row["median_us"] == pytest.approx(1000.0)


# ---------------------------------------------------------------------------
# PRF3/PRF5: profile_fn and the measured peak
# ---------------------------------------------------------------------------


def test_prf3_profile_fn_end_to_end():
    x = torch.ones(4096)
    row = profile_fn("saxpy", lambda x: x * 2.0 + 1.0, x, iters=3, warmup=1,
                     peak_gbps=10.0, device="cpu")
    assert row["op"] == "saxpy" and row["iters"] == 3
    assert row["median_us"] > 0 and row["backend"] == "cpu"
    # the port's modeled cost: x * 2.0 reads x and writes a copy, + 1.0
    # reads that and writes the result (4 x 16 KB); no matmul
    assert row["modeled_hbm_bytes"] == 4 * 4096 * 4
    assert row["modeled_flops"] == 0.0
    assert row["pct_of_bound"] == pytest.approx(
        100.0 * row["achieved_gbps"] / 10.0)


def test_prf5_peak_is_cached_per_size():
    a = measured_peak_gbps(1 << 16, device="cpu", iters=2, warmup=1)
    b = measured_peak_gbps(1 << 16, device="cpu", iters=2, warmup=1)
    assert a == b and a > 0


# ---------------------------------------------------------------------------
# PRF4: training-phase attribution
# ---------------------------------------------------------------------------

D, C, H = 8, 4, 16
L, K, B = 4, 2, 4


def _batches(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"x": torch.randn((L, K, B, D), generator=gen),
            "y": torch.randint(0, C, (L, K, B), generator=gen)}


def _state(cfg):
    params = mlp_init(torch.Generator().manual_seed(0), D, H, C,
                      device="cpu")
    return init_state(params, cfg)


def _snapshot(state):
    return [x.clone() for x in tree_leaves(
        {"gp": state.global_params, "v": state.momentum,
         "w": state.learners})]


@pytest.mark.parametrize("topology", [
    TopologyConfig(),
    TopologyConfig(kind="gossip", graph="ring"),
], ids=["flat", "gossip"])
def test_prf4_profile_phases_covers_step_local_mix(topology, tmp_path):
    """Every ported topology routes its meta phase through ``mix``, so the
    meta_mix row is always attributable (JAX's second case, downpour on
    the async server, is ``test_prf4_aliased_algorithm_attributes_meta_mix``
    below)."""
    cfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=K,
                     learner_lr=0.1, momentum=0.6, topology=topology)
    state = _state(cfg)
    before, step = _snapshot(state), state.step
    rows = profile_phases(mlp_loss, cfg, state, _batches(), iters=2,
                          warmup=1, peak_gbps=10.0,
                          profiler_trace_dir=str(tmp_path / "prof"))
    assert [r["op"] for r in rows] == [
        "phase:step", "phase:local", "phase:meta_mix"]
    for r in rows:
        assert r["kind"] == "attribution" and r["backend"] == "cpu"
        assert r["median_us"] > 0 and r["iqr_us"] >= 0
        assert r["algorithm"] == "mavg"
        assert r["topology"] == topology.kind
    # the profiled work ran on a clone: the passed state is as it was
    assert state.step == step
    for a, b in zip(before, _snapshot(state)):
        assert torch.equal(a, b)
    assert list((tmp_path / "prof").iterdir())


def test_prf4_aliased_algorithm_attributes_meta_mix():
    """downpour is an alias onto the async server (one Topology protocol
    for every algorithm), so its meta phase is attributable too; the
    passed state (its host clocks included) is left as it was."""
    cfg = MAvgConfig(algorithm="downpour", num_learners=L, k_steps=K,
                     learner_lr=0.1, momentum=0.6)
    state = _state(cfg)
    before = _snapshot(state)
    clocks = {k: state.topo[k].clone()
              for k in ("clock", "pull_update", "updates", "anchor")}
    rows = profile_phases(mlp_loss, cfg, state, _batches(), iters=2,
                          warmup=1)
    assert [r["op"] for r in rows] == [
        "phase:step", "phase:local", "phase:meta_mix"]
    assert all(r["algorithm"] == "downpour" and r["topology"] == "flat"
               for r in rows)
    for a, b in zip(before, _snapshot(state)):
        assert torch.equal(a, b)
    for k, v in clocks.items():
        assert torch.equal(state.topo[k], v), k


def test_trainer_attribution_rows_reach_the_sink(tmp_path):
    cfg = TrainConfig(
        model=None, mavg=MAvgConfig(algorithm="mavg", num_learners=L,
                                    k_steps=K, learner_lr=0.1, momentum=0.6),
        batch_per_learner=B, meta_steps=2, log_every=1,
        obs=ObsConfig(sink="memory", attribution=True))
    tr = Trainer(cfg, mlp_loss,
                 init_params_fn=lambda gen: mlp_init(gen, D, H, C,
                                                     device="cpu"),
                 batch_fn=lambda gen, s: _batches(s), device="cpu")
    tr.run(2, log=None)
    kinds = [r.get("kind", "step") for r in tr._sink.records]
    assert kinds[:3] == ["attribution"] * 3 and kinds[3:] == ["step"] * 2
    assert [r["op"] for r in tr.attribution] == [
        "phase:step", "phase:local", "phase:meta_mix"]


def test_trainer_attribution_is_best_effort(monkeypatch):
    """As in JAX, a failing attribution leaves no rows and the run goes
    on."""
    def boom(*a, **k):
        raise RuntimeError("no timer")

    monkeypatch.setattr("repro_torch.core.trainer.profile_phases", boom)
    cfg = TrainConfig(
        model=None, mavg=MAvgConfig(algorithm="mavg", num_learners=L,
                                    k_steps=K, learner_lr=0.1, momentum=0.6),
        batch_per_learner=B, meta_steps=2,
        obs=ObsConfig(sink="memory", attribution=True))
    tr = Trainer(cfg, mlp_loss,
                 init_params_fn=lambda gen: mlp_init(gen, D, H, C,
                                                     device="cpu"),
                 batch_fn=lambda gen, s: _batches(s), device="cpu")
    assert len(tr.run(2, log=None)) == 2 and tr.attribution == []


def test_clone_state_copies_every_plane():
    cfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=K)
    state = _state(cfg)
    clone = tprofile.clone_state(state)
    for a, b in zip(tree_leaves({"gp": state.global_params,
                                 "w": state.learners}),
                    tree_leaves({"gp": clone.global_params,
                                 "w": clone.learners})):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_prf4_the_clone_is_freed_on_return():
    """The timed clone is released when ``profile_phases`` returns, without
    waiting for the garbage collector: on the card it is a whole state."""
    import gc

    cfg = MAvgConfig(algorithm="mavg", num_learners=L, k_steps=K,
                     learner_lr=0.1, momentum=0.6)
    state = _state(cfg)

    def planes():
        # ``type(o) is``: isinstance would touch deprecated torch objects
        return sum(type(o) is torch.Tensor and o.dim() >= 2
                   and o.shape[-1] == 128 for o in gc.get_objects())

    gc.collect()
    gc.disable()
    try:
        before = planes()
        profile_phases(mlp_loss, cfg, state, _batches(), iters=1, warmup=0)
        assert planes() == before
    finally:
        gc.enable()
