"""The port's async bounded-staleness server
(``repro_torch.topology.async_server``) against the JAX package's, and
the JAX package's own async invariants (tests/test_async.py A1-A7,
tests/test_meta_properties.py I6) on the port.

Tolerances, with their reasons:

* per-step trajectories on the MLP (L=4, K=2, JAX's params and batches):
  global params, momentum, learners and anchors within rtol 1e-5 / atol
  1e-6 after EVERY step (the local phase differs by a few ulps between
  XLA:CPU and ATen, and ``decay**tau`` is numpy's f32 ``powf`` on the
  host where JAX takes ``jnp.power`` on the device: one ulp apart at
  most); the losses and the float metrics within rtol 1e-5; the clocks,
  pull stamps, update counter, fired counts, tau and ``work_completed``
  EXACTLY;
* A1 (the uniform profile is the flat topology) BITWISE inside the port:
  packed and per-leaf, dense and robust.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.chaos import ChaosConfig as JChaosConfig  # noqa: E402
from repro.chaos import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.chaos import FaultSpec as JFaultSpec  # noqa: E402
from repro.chaos import PayloadCorruptor as JPayloadCorruptor  # noqa: E402
from repro.chaos import apply_chaos as japply_chaos  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import Trainer as JTrainer  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import classif_batch_fn as jclassif_batch_fn  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.topology import make_topology as jmake_topology  # noqa: E402
from repro.topology import step_time_profile as jstep_time_profile  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    ChaosConfig,
    FaultSchedule,
    FaultSpec,
    PayloadCorruptor,
    apply_chaos,
)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    AsyncConfig,
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    RobustConfig,
    TopologyConfig,
)
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data.synthetic import classif_batch_fn  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.topology import (  # noqa: E402
    AsyncServer,
    make_topology,
    resolve_async_config,
    step_time_profile,
)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
CLOCKS = ("clock", "pull_update", "updates")
METRICS = ("loss", "grad_norm", "v_norm", "displacement_norm",
           "stale_norm", "consensus_dist", "staleness_mean",
           "staleness_max", "staleness_p99", "fired_count", "comm_bytes")
EXACT = ("staleness_max", "fired_count")
ROBUST = dict(estimator="mean", clip_mult=2.0, clip_window=2, score=True)


def _batches(seed, L, K, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _pair(topology=None, robust=None, **kw):
    """The same MAvgConfig for JAX and for the port: ``topology`` a dict
    whose ``server``/``elastic`` values are dicts too."""
    def make(base):
        extra = {}
        if topology is not None:
            t = dict(topology)
            if "server" in t:
                t["server"] = base.AsyncConfig(**t["server"])
            if "elastic" in t:
                t["elastic"] = base.ElasticConfig(**t["elastic"])
            extra["topology"] = base.TopologyConfig(**t)
        if robust is not None:
            extra["robust"] = base.RobustConfig(**robust)
        return base.MAvgConfig(**kw, **extra)

    return make(jbase), make(tbase)


def _base(**kw):
    return dict(dict(algorithm="mavg", num_learners=4, k_steps=2,
                     learner_lr=0.1, momentum=0.6), **kw)


def _skewed(profile=(1, 1, 2, 4), tau=3, **server):
    return dict(kind="async",
                server=dict(staleness=tau, step_time=profile, **server))


def _close(port, ref, rtol=1e-5, atol=1e-6, what=""):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=what)


def _lockstep(jcfg, cfg, n, *, chaos=None, jchaos=None, poison=None):
    """Run both packages side by side for ``n`` meta steps on the same
    batches and compare after every step. ``poison(i)`` -> (learner,
    value) or None writes ``value`` into one element of that learner in
    both states before step i."""
    jstate = jinit_state(JPARAMS, jcfg)
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg, chaos=jchaos))
    topology = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology, chaos=chaos)
    L, K = cfg.num_learners, cfg.k_steps
    metrics, jmetrics = [], []
    for i in range(n):
        hit = poison(i) if poison else None
        if hit is not None:
            j, val = hit
            jleaf = jax.tree.leaves(jstate.learners)[0]
            jstate = dataclasses.replace(jstate, learners=jax.tree.unflatten(
                jax.tree.structure(jstate.learners),
                [jleaf.at[(j,) + (0,) * (jleaf.ndim - 1)].set(val)]
                + jax.tree.leaves(jstate.learners)[1:]))
            leaf = tree_leaves(state.learners)[0]
            leaf[(j,) + (0,) * (leaf.dim() - 1)] = val
        b = _batches(i, L, K)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, interop.params_from_jax(b))
        jm = jax.device_get(jm)
        what = f"step {i}"
        _close(state.global_params, jstate.global_params, what=what)
        _close(state.momentum, jstate.momentum, what=what)
        _close(state.learners, jstate.learners, what=what)
        if "anchor" in jstate.topo:
            _close(state.topo["anchor"], jstate.topo["anchor"], what=what)
            for k in CLOCKS:
                np.testing.assert_array_equal(
                    state.topo[k].numpy(), np.asarray(jstate.topo[k]),
                    err_msg=f"{k} {what}")
        for k in METRICS + tuple(x for x in jm if x.startswith("robust_")):
            if k not in jm:
                continue
            got, want = float(m[k]), float(jm[k])
            if k in EXACT:
                assert got == want, (k, what, got, want)
            elif k.startswith("robust_"):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{k} {what}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} {what}")
        metrics.append(m)
        jmetrics.append(jm)
    return state, jax.device_get(jstate), metrics, topology


# ---------------------------------------------------------------------------
# per-step trajectories against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
@pytest.mark.parametrize("case", [
    dict(topo=_skewed()),
    dict(topo=_skewed(), kw=dict(nesterov=True)),
    dict(topo=_skewed(update="elastic", elastic_alpha=0.2)),
    dict(topo=_skewed((1, 3, 3, 5), 4, decay=0.9)),
    dict(topo=None, kw=dict(algorithm="eamsgd", elastic_alpha=0.1)),
    dict(topo=None, kw=dict(algorithm="downpour", staleness=2)),
], ids=["mavg", "mavg_nesterov", "elastic", "decay", "eamsgd", "downpour"])
def test_trajectory_matches_jax(case, packed):
    jcfg, cfg = _pair(topology=case["topo"],
                      **_base(packed=packed, **case.get("kw", {})))
    _, _, metrics, topo = _lockstep(jcfg, cfg, 10)
    assert isinstance(topo, AsyncServer) and not topo.degenerate
    # the skewed runs carry real staleness
    if case["topo"] is not None or case["kw"]["algorithm"] == "downpour":
        assert max(m["staleness_max"] for m in metrics) > 0


@pytest.mark.parametrize("update", ["mavg", "elastic"])
def test_trajectory_with_robust_clip_under_corruption(update):
    """Learner 3 ships a x12-scaled plane from step 2 on; the norm clip
    (2x the trailing median of a 2-step ring) and the anomaly scores run
    on the anchor displacements before the staleness weighting, with the
    finite guard on. Seven ticks: learner 3 (start clock -3) fires its
    corrupt block at tick 6. The clip factors come from norms each
    package reduces in its own order, so a clipped displacement moves by
    a few ulps a tick, and the ulps compound with every clipped push: the
    planes stay inside rtol 1e-5 through tick 6 (tick 9 reaches 1.5e-5).
    The robust metrics within rtol 1e-4, as tests/test_torch_robust.py
    holds them (the Krum distances cancel)."""
    faults = (dict(kind="payload_scale", step=2, learner=3, magnitude=12.0,
                   sticky=True, duration=10),)
    jchaos = JChaosConfig(seed=0, horizon=12, faults=tuple(
        JFaultSpec(**f) for f in faults))
    chaos = ChaosConfig(seed=0, horizon=12, faults=tuple(
        FaultSpec(**f) for f in faults))
    jcfg, cfg = _pair(topology=_skewed(update=update), robust=ROBUST,
                      **_base(finite_guard=True))
    _, _, metrics, _ = _lockstep(
        jcfg, cfg, 7, jchaos=JPayloadCorruptor(JFaultSchedule(jchaos, 4)),
        chaos=PayloadCorruptor(FaultSchedule(chaos, 4)))
    assert sum(float(m["robust_clipped_learners"]) for m in metrics) > 0


def test_trajectory_with_elastic_membership():
    jcfg, cfg = _pair(
        topology=dict(_skewed((1, 1, 2, 2), 2),
                      elastic=dict(period=3, drop_frac=0.25, seed=1)),
        **_base())
    _lockstep(jcfg, cfg, 9)


def test_trajectory_with_straggle_fault():
    """apply_chaos lands the straggle spike on the async profile in both
    packages (learner 1: +3 ticks, tau raised to 3), and the runs agree."""
    spec = dict(kind="straggle", step=0, learner=1, magnitude=3.0)
    jcfg, cfg = _pair(topology=dict(kind="async", server=dict(staleness=1)),
                      **_base())
    jcfg = japply_chaos(jcfg, JChaosConfig(seed=0, horizon=8,
                                           faults=(JFaultSpec(**spec),)))
    cfg = apply_chaos(cfg, ChaosConfig(seed=0, horizon=8,
                                       faults=(FaultSpec(**spec),)))
    assert cfg.topology.server == tbase.AsyncConfig(
        **dataclasses.asdict(jcfg.topology.server))
    assert cfg.topology.server.step_time == (1, 4, 1, 1)
    assert cfg.topology.server.staleness == 3
    _, _, metrics, _ = _lockstep(jcfg, cfg, 9)
    assert max(m["staleness_max"] for m in metrics) > 0


def test_uniform_robust_degenerate_matches_jax():
    """The tau=0 delegate to FlatAllReduce with the trimmed-mean
    estimator and the clip: the topo dict rides through the flat mix, so
    the ring advances and survives, in both packages."""
    jcfg, cfg = _pair(topology=dict(kind="async", server=dict()),
                      robust=dict(ROBUST, estimator="trimmed", trim=1),
                      **_base())
    state, jstate, _, topo = _lockstep(jcfg, cfg, 4)
    assert topo.degenerate
    np.testing.assert_allclose(state.topo["robust_ring"].numpy(),
                               np.asarray(jstate.topo["robust_ring"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# 0 * NaN: a non-finite learner that does not fire (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("guard", [False, True], ids=["no_guard", "guard"])
def test_nonfinite_learner_that_does_not_fire(guard):
    """Learner 3 (step time 4, start clock -3) is still computing at tick
    1 when one of its values turns NaN. Both packages sum every learner
    with weight 0 for those that do not fire, and 0 * NaN = NaN: without
    the finite guard the whole center is poisoned on that tick in both;
    with it, the guard resets learner 3 first, and both runs stay finite
    and agree. JAX also computes the masked local steps of a learner that
    does not fire and multiplies their losses by 0, so its loss metric is
    NaN on that tick even with the guard; the port skips those steps and
    reports the active learners' mean (ROADMAP Queue 3)."""
    jcfg, cfg = _pair(topology=_skewed(), **_base(finite_guard=guard))
    jstate = jinit_state(JPARAMS, jcfg)
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    topo = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg, topology=topo)
    step = make_meta_step(mlp_loss, cfg, topology=topo)
    for i in range(3):
        if i == 1:
            assert not bool(topo.fire_mask(state.topo, 1)[3])
            jstate = dataclasses.replace(
                jstate, learners=jstate.learners.at[3, 0, 0].set(jnp.nan))
            state.learners[3, 0, 0] = float("nan")
        b = _batches(i, 4, 2)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, interop.params_from_jax(b))
        assert m["fired_count"] == float(jm["fired_count"])
        if i == 1:
            assert np.isnan(float(jm["loss"]))
            assert np.isfinite(float(m["loss"]))
    jgp = np.asarray(jstate.global_params)
    if guard:
        assert np.isfinite(jgp).all()
        _close(state.global_params, jstate.global_params)
        _close(state.learners, jstate.learners)
    else:
        # every parameter of the center is NaN (the padding of the plane
        # alone stays 0), at the same places in both packages
        spec = state.spec
        n = spec.offsets[-1] + spec.sizes[-1]
        assert np.isnan(jgp.reshape(-1)[:n]).sum() == sum(spec.sizes)
        np.testing.assert_array_equal(
            torch.isnan(state.global_params).numpy(), np.isnan(jgp))


# ---------------------------------------------------------------------------
# the JAX package's invariants on the port (tests/test_async.py)
# ---------------------------------------------------------------------------


def _run(cfg, n_steps=4):
    topology = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology)
    metrics = []
    for i in range(n_steps):
        state, m = step(state, interop.params_from_jax(
            _batches(i, cfg.num_learners, cfg.k_steps)))
        metrics.append(m)
    return state, metrics


def _bitwise(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("robust", [None, dict(ROBUST, estimator="trimmed",
                                               trim=1)],
                         ids=["dense", "robust"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_a1_uniform_async_is_flat_bitwise(packed, robust):
    extra = {} if robust is None else {"robust": RobustConfig(**robust)}
    base = dict(algorithm="mavg", num_learners=4, k_steps=3,
                learner_lr=0.1, momentum=0.6, packed=packed, **extra)
    s_flat, m_flat = _run(MAvgConfig(**base))
    s_async, m_async = _run(MAvgConfig(
        **base, topology=TopologyConfig(kind="async", server=AsyncConfig())))
    _bitwise(s_flat.global_params, s_async.global_params)
    _bitwise(s_flat.momentum, s_async.momentum)
    _bitwise(s_flat.learners, s_async.learners)
    assert float(m_flat[-1]["loss"]) == float(m_async[-1]["loss"])
    if robust is not None:
        assert torch.equal(s_flat.topo["robust_ring"],
                           s_async.topo["robust_ring"])
    # the degenerate case still reports the async bookkeeping
    assert m_async[-1]["staleness_max"] == 0.0
    assert m_async[-1]["fired_count"] == 4.0
    # every anchor is the new center
    for a, g in zip(tree_leaves(s_async.topo["anchor"]),
                    tree_leaves(s_async.global_params)):
        assert torch.equal(a, g.unsqueeze(0).expand_as(a))


def test_a1_eamsgd_alias_matches_legacy_update():
    """eamsgd (uniform profile, elastic update) applies the closed-form
    EASGD step: w~' - w~ == v'."""
    cfg = MAvgConfig(algorithm="eamsgd", num_learners=2, k_steps=2,
                     learner_lr=0.1, momentum=0.5, elastic_alpha=0.1)
    state = init_state(interop.params_from_jax(JPARAMS), cfg)
    step = make_meta_step(mlp_loss, cfg)
    state, _ = step(state, interop.params_from_jax(_batches(0, 2, 2)))
    prev = state.global_params.clone()
    state, _ = step(state, interop.params_from_jax(_batches(1, 2, 2)))
    np.testing.assert_allclose((state.global_params - prev).numpy(),
                               state.momentum.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("profile,tau", [((1, 1, 2, 4), 3),
                                         ((1, 3, 3, 5), 4)])
def test_a2_applied_staleness_bounded(profile, tau):
    cfg = MAvgConfig(algorithm="mavg", num_learners=4, k_steps=2,
                     momentum=0.5,
                     topology=TopologyConfig(kind="async", server=AsyncConfig(
                         staleness=tau, step_time=profile)))
    _, metrics = _run(cfg, n_steps=3 * max(profile) + 2)
    worst = max(m["staleness_max"] for m in metrics)
    assert worst <= tau, (worst, tau)
    assert any(m["staleness_max"] > 0 for m in metrics)


def test_a3_resume_mid_window_identical_trajectory():
    cfg = MAvgConfig(algorithm="mavg", num_learners=4, k_steps=2,
                     momentum=0.5,
                     topology=TopologyConfig(kind="async", server=AsyncConfig(
                         staleness=3, step_time=(1, 2, 3, 4))))
    live, _ = _run(cfg, 7)
    replay, _ = _run(cfg, 7)
    for f in ("global_params", "momentum", "learners"):
        assert torch.equal(getattr(live, f), getattr(replay, f))
    for k, v in live.topo.items():
        assert torch.equal(v, replay.topo[k]), k


def test_a4_downpour_alias_warmup_and_stale_norm():
    cfg = MAvgConfig(algorithm="downpour", num_learners=2, k_steps=2,
                     learner_lr=0.1, staleness=3)
    start = init_state(interop.params_from_jax(JPARAMS), cfg).global_params
    state = init_state(interop.params_from_jax(JPARAMS), cfg)
    step = make_meta_step(mlp_loss, cfg)
    moved = []
    for i in range(6):
        state, m = step(state, interop.params_from_jax(_batches(i, 2, 2)))
        moved.append(float((state.global_params - start).abs().max()) > 1e-7)
        assert "stale_norm" in m
    # frozen through the warmup window, moving afterwards
    assert not any(moved[:3]) and all(moved[3:])


def test_a5_absent_learner_never_fires():
    cfg = MAvgConfig(
        algorithm="mavg", num_learners=4, k_steps=2, momentum=0.5,
        topology=TopologyConfig(
            kind="async",
            server=AsyncConfig(staleness=2, step_time=(1, 1, 2, 2)),
            elastic=ElasticConfig(period=3, drop_frac=0.25, seed=1)))
    topo = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg, topology=topo)
    step = make_meta_step(mlp_loss, cfg, topology=topo)
    sched = state.topo["membership"].numpy()
    for i in range(9):
        fire = topo.fire_mask(state.topo, i).numpy()
        absent = sched[i % 3] == 0
        assert not (fire & absent).any()
        prev = state.learners.clone()
        state, _ = step(state, interop.params_from_jax(_batches(i, 4, 2)))
        assert torch.equal(prev[torch.from_numpy(absent)],
                           state.learners[torch.from_numpy(absent)])


def test_a6_validation():
    with pytest.raises(ValueError, match="staleness"):
        AsyncConfig(staleness=2, step_time=(1, 1, 5))
    with pytest.raises(ValueError, match="dense"):
        MAvgConfig(num_learners=2, k_steps=2,
                   comm=CommConfig(scheme="int8"),
                   topology=TopologyConfig(kind="async"))
    with pytest.raises(ValueError, match="step_time"):
        MAvgConfig(num_learners=4, k_steps=2,
                   topology=TopologyConfig(kind="async", server=AsyncConfig(
                       staleness=1, step_time=(1, 2))))
    # the seeded skew profile: deterministic, spans 1..skew, and JAX's
    for L, skew, seed in ((8, 4, 0), (6, 3, 5), (4, 1, 0)):
        prof = step_time_profile(L, AsyncConfig(staleness=3, skew=skew,
                                                seed=seed))
        np.testing.assert_array_equal(prof, jstep_time_profile(
            L, jbase.AsyncConfig(staleness=3, skew=skew, seed=seed)))
        assert prof.dtype == np.int32
        assert prof.min() == 1 and prof.max() == skew
    # eamsgd/downpour stay refused on the averaging-only topologies
    with pytest.raises(ValueError):
        MAvgConfig(algorithm="eamsgd",
                   topology=TopologyConfig(kind="gossip"))


def test_a7_work_completed_matches_fired_counts():
    cfg = MAvgConfig(algorithm="mavg", num_learners=4, k_steps=2,
                     momentum=0.5,
                     topology=TopologyConfig(kind="async", server=AsyncConfig(
                         staleness=3, step_time=(1, 1, 2, 4))))
    jtopo = jmake_topology(jbase.MAvgConfig(
        algorithm="mavg", num_learners=4, k_steps=2, momentum=0.5,
        topology=jbase.TopologyConfig(kind="async", server=jbase.AsyncConfig(
            staleness=3, step_time=(1, 1, 2, 4)))))
    topo = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg, topology=topo)
    step = make_meta_step(mlp_loss, cfg, topology=topo)
    fired = 0
    for i in range(10):
        steps = topo.local_steps(state.topo, i)
        state, m = step(state, interop.params_from_jax(_batches(i, 4, 2)))
        assert sum(steps) == 2 * m["fired_count"]
        fired += int(m["fired_count"])
        assert topo.work_completed(i) == fired == jtopo.work_completed(i)
    flat = make_topology(MAvgConfig(num_learners=4, k_steps=2))
    assert flat.work_completed(9) == 40


def test_i6_downpour_warmup():
    cfg = MAvgConfig(algorithm="downpour", num_learners=2, k_steps=2,
                     learner_lr=0.1, staleness=3)
    start = init_state(interop.params_from_jax(JPARAMS), cfg).global_params
    state = init_state(interop.params_from_jax(JPARAMS), cfg)
    step = make_meta_step(mlp_loss, cfg)
    for i in range(3):
        state, _ = step(state, interop.params_from_jax(_batches(i, 2, 2)))
        if i < 2:  # frozen until the clocks fill
            assert torch.equal(state.global_params, start)
    state, _ = step(state, interop.params_from_jax(_batches(99, 2, 2)))
    assert float(torch.linalg.vector_norm(state.global_params - start)) > 1e-6


def test_resolve_async_config_matches_jax():
    for kw in (dict(algorithm="eamsgd", elastic_alpha=0.2),
               dict(algorithm="downpour", staleness=3),
               dict(algorithm="mavg"),
               dict(algorithm="eamsgd",
                    topology=dict(kind="async", server=dict(
                        staleness=1, step_time=(1, 2, 1, 1),
                        elastic_alpha=0.3)))):
        kw = dict(kw)
        jcfg, cfg = _pair(topology=kw.pop("topology", None),
                          **dict(num_learners=4, **kw))
        got = dataclasses.asdict(resolve_async_config(cfg))
        want = dataclasses.asdict(
            __import__("repro.topology", fromlist=["x"])
            .resolve_async_config(jcfg))
        assert got == want, kw


# ---------------------------------------------------------------------------
# the Trainer: samples, the quarantine replay, samples_per_sec
# ---------------------------------------------------------------------------


def _trainers(mcfg_kw, steps=8, log_every=8, L=4, K=2, B=4):
    """The JAX and the port Trainer on the same async MLP config."""
    jm, pm = _pair(**mcfg_kw)

    def tcfg(base, m):
        return base.TrainConfig(model=None, mavg=m, batch_per_learner=B,
                                meta_steps=steps, seed=0,
                                log_every=log_every,
                                obs=base.ObsConfig(sink="none"))

    jt = JTrainer(tcfg(jbase, jm), jmlp_loss,
                  init_params_fn=lambda rng: jmlp_init(rng, D, H, C),
                  batch_fn=jclassif_batch_fn(D, C, L, K, B))
    pt = Trainer(tcfg(tbase, pm), mlp_loss,
                 init_params_fn=lambda g: mlp_init(g, D, H, C, device="cpu"),
                 batch_fn=classif_batch_fn(D, C, L, K, B, device="cpu"),
                 device="cpu")
    return jt, pt


def test_samples_per_sec_overstates_async_rate_in_both_packages():
    """Departure of the reference, pinned in both packages: the Trainer's
    ``samples_per_sec`` is meta_steps_per_sec x L K B, while under async
    only ``fired_count`` learners complete a block a tick; ``samples``
    (through ``work_completed``) is right. On (1, 1, 2, 4) over 8 ticks
    21 blocks complete (16 + 4 + 1), not 32: the rate is overstated by
    32/21."""
    kw = dict(topology=_skewed(), **_base())
    jt, pt = _trainers(kw)
    for tr in (jt, pt):
        hist = tr.run(log=None)
        last = hist[-1]
        assert last["samples"] == 21 * 2 * 4
        blocks_per_tick = last["samples"] / (2 * 4) / len(hist)
        assert last["samples_per_sec"] == pytest.approx(
            last["meta_steps_per_sec"] * 4 * 2 * 4)
        overstated = (last["samples_per_sec"]
                      / (last["meta_steps_per_sec"] * blocks_per_tick
                         * 2 * 4))
        assert overstated == pytest.approx(32 / 21)
        tr.close()


def test_set_membership_resets_the_work_replay():
    """The quarantine lever swaps the membership schedule; the async
    server's completed-work replay re-simulates under it, as JAX's
    Trainer does (the port's Trainer missed this before)."""
    kw = dict(topology=dict(_skewed((1, 1, 2, 2), 2),
                            elastic=dict(period=4, drop_frac=0.0)),
              **_base())
    jt, pt = _trainers(kw, steps=4, log_every=1)
    m = np.ones((4, 4), np.float32)
    m[1:, 2] = 0.0
    for tr in (jt, pt):
        tr.run(2, log=None)
        tr.set_membership(m)
        tr.run(2, log=None)
    assert [r["samples"] for r in pt.history] == [
        r["samples"] for r in jt.history]
    assert pt._topology.work_completed(3) == jt._topology.work_completed(3)
    jt.close()
    pt.close()


def test_trainer_resume_replays_work_from_the_restored_step(tmp_path):
    """A resumed async run counts its samples from the restored step on:
    the host replay of the clocks starts at tick 0 in a fresh Trainer and
    reaches the same cumulative blocks as the uninterrupted run."""
    kw = dict(topology=_skewed(), **_base())
    _, a = _trainers(kw, steps=8, log_every=1)
    a.run(log=None)
    _, b = _trainers(kw, steps=8, log_every=1)
    b.run(5, log=None)
    path = __import__("repro_torch.checkpoint", fromlist=["x"]).save_state(
        str(tmp_path), b.state, 5)
    _, c = _trainers(kw, steps=8, log_every=1)
    c.restore(path)
    c.run(3, log=None)
    assert [r["samples"] for r in c.history] == [
        r["samples"] for r in a.history[5:]]
    for f in ("global_params", "momentum", "learners"):
        assert torch.equal(getattr(c.state, f), getattr(a.state, f))
    for tr in (a, b, c):
        tr.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["--topology", "async", "--async-profile", "1,1,2,4",
     "--async-staleness", "3"],
    ["--topology", "async", "--async-skew", "3", "--async-staleness", "2",
     "--async-update", "elastic", "--async-decay", "0.9",
     "--async-seed", "1"],
    ["--algorithm", "eamsgd"],
    ["--algorithm", "downpour"],
], ids=["async_profile", "async_skew_elastic", "eamsgd", "downpour"])
def test_launcher_runs_async(args, capsys):
    launch_train.main(["--device", "cpu", "--learners", "4", "--k", "2",
                       "--steps", "4", "--batch", "2", "--seq", "16"]
                      + args)
    out = capsys.readouterr().out
    assert "meta_step=3" in out and "eval loss" in out
    assert "staleness_max" in out and "fired_count" in out
