"""The port's elastic membership and hierarchical topology against the
JAX package's (``repro_torch.topology.elastic``, ``hierarchical``), the
in-port invariants of tests/test_elastic.py and tests/test_topology.py,
and the slice end to end.

Tolerances, with their reasons:

* membership schedules: EXACTLY equal (the same numpy code); masked
  mixing matrices within rtol 1e-6 (two f32 LAPACK solves), and bitwise
  W when every learner is present (the correction is exactly zero);
* meta steps on the MLP (4 learners, 3 steps, JAX's dither): rtol 1e-5 /
  atol 1e-6 for dense runs (the local phase differs by a few ulps
  between XLA:CPU and ATen); compressed runs agree but for a share
  ``FLIP_SHARE`` of the values, each within ``FLIP_QUANTA`` quanta of the
  largest scale, where a displacement moved by an ulp flipped a
  stochastic-rounding decision (tests/test_torch_comm.py); a top-k
  selection flip moves one kept value (at most the largest displacement)
  besides. The hierarchical int8 / int8_topk runs flipped at most 0.4 %
  of a plane, the elastic and reduced-Qwen gossip runs less;
* the invariants E1 (all-present elastic == static), E2 (uniform group_k
  == scalar K) and T1 (Hierarchical G=1, H=1, mu_out=0 == flat M-AVG) are
  BITWISE in the port. T1 rests on gp + (A - gp) == A, exact when A and
  gp are within a factor of two of each other (Sterbenz), as every
  coordinate of these runs is. E1 holds for hierarchical int8 + EF inner
  / int8_topk + EF outer too, which the JAX package misses by 2.98e-8
  (ROADMAP Queue 3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.configs.base import CommConfig as JCommConfig  # noqa: E402
from repro.configs.base import ElasticConfig as JElasticConfig  # noqa: E402
from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import TopologyConfig as JTopologyConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import lm_batch_fn as jlm_batch_fn  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.topology import elastic as jelastic  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    CommConfig,
    ElasticConfig,
    MAvgConfig,
    TopologyConfig,
    get_config,
)
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.topology import elastic, gossip, make_topology  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
FLIP_SHARE = 5e-3
FLIP_QUANTA = 2.0
INT8_EF = dict(scheme="int8", error_feedback=True)
TOPK_EF = dict(scheme="int8_topk", error_feedback=True)


def _jax_dither(seed=0):
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def _batches(seed, L, K, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _cfgs(kw, topo):
    """The same MAvgConfig for JAX and for the port. ``topo`` values that
    are dicts under inner_comm/outer_comm/elastic become the configs."""
    def make(M, T, Cm, E):
        t = {k: (E(**v) if k == "elastic" else Cm(**v))
             if isinstance(v, dict) else v for k, v in topo.items()}
        return M(**kw, topology=T(**t))

    return (make(JMAvgConfig, JTopologyConfig, JCommConfig, JElasticConfig),
            make(MAvgConfig, TopologyConfig, CommConfig, ElasticConfig))


def _run_jax(jcfg, batch_list):
    state = jinit_state(JPARAMS, jcfg)
    step = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    metrics = []
    for b in batch_list:
        state, m = step(state, b)
        metrics.append(m)
    return jax.device_get(state), metrics


def _run_port(cfg, batch_list, states=False):
    topology = make_topology(cfg, dither=_jax_dither())
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology)
    metrics, trail = [], []
    for b in batch_list:
        if states:
            trail.append({k: None if v is None else v.clone()
                          for k, v in state.topo.items()})
        state, m = step(state, interop.params_from_jax(b))
        metrics.append(m)
    return (state, metrics, trail) if states else (state, metrics)


@pytest.fixture
def spread(monkeypatch):
    """Record the largest |displacement| any quantizer of the port saw:
    1/127 of it is the largest int8 scale quantum."""
    from repro_torch.kernels import ops

    seen = {"max": 0.0}

    def see(x):
        seen["max"] = max(seen["max"], float(x.abs().max()))

    real_pu, real_pc, real_qd = (ops.pack_update, ops.pack_compress,
                                 ops.quant_dequant)

    def pack_update(w, g, e, u, **kw):
        d = w.float() - g.float()[None]
        see(d if e is None else d + e)
        return real_pu(w, g, e, u, **kw)

    def pack_compress(d, u, **kw):
        see(d)
        return real_pc(d, u, **kw)

    def quant_dequant(x, dither, **kw):
        see(x)
        return real_qd(x, dither, **kw)

    monkeypatch.setattr(ops, "pack_update", pack_update)
    monkeypatch.setattr(ops, "pack_compress", pack_compress)
    monkeypatch.setattr(ops, "quant_dequant", quant_dequant)
    return seen


def _close_or_flipped(got, want, limit):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.mean() <= FLIP_SHARE, off.mean()
    assert np.all(np.abs(got - want)[off] <= limit)


def _close(port, ref, rtol=1e-5, atol=1e-6):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _bitwise(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def _compare(state, jstate, metrics, jmetrics, names, limit=None):
    """States within rtol 1e-5 / atol 1e-6, or (``limit``: a compressed
    run) but for a share FLIP_SHARE of flipped values within ``limit``;
    the metrics ``names`` within rtol 1e-5."""
    pairs = [(state.global_params, jstate.global_params),
             (state.learners, jstate.learners)]
    pairs += [(state.topo[k], v) for k, v in jstate.topo.items()
              if v is not None]
    for port, ref in pairs:
        if limit is None:
            _close(port, ref)
            continue
        for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
            _close_or_flipped(a, b, limit)
    for m, jm in zip(metrics, jmetrics):
        for k in names:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# schedules and masked matrices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,groups,drop,seed", [
    (4, 1, 0.25, 0), (8, 2, 0.25, 3), (8, 4, 0.5, 1), (16, 1, 0.3, 7),
    (4, 2, 0.99, 2), (3, 1, 0.0, 0),
])
def test_membership_schedule_matches_jax(L, groups, drop, seed):
    el = dict(period=6, drop_frac=drop, seed=seed)
    got = elastic.membership_schedule(L, ElasticConfig(**el), groups=groups)
    want = jelastic.membership_schedule(L, JElasticConfig(**el),
                                        groups=groups)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    sched = ((1, 0, 1, 1), (1, 1, 0, 1))
    np.testing.assert_array_equal(
        elastic.membership_schedule(4, ElasticConfig(period=2,
                                                     schedule=sched)),
        jelastic.membership_schedule(4, JElasticConfig(period=2,
                                                       schedule=sched)))


@pytest.mark.parametrize("graph", ["ring", "exponential", "complete",
                                   "one_peer_exponential"])
def test_mask_mixing_matrix_matches_jax(graph):
    rng = np.random.default_rng(8)
    jmask = jax.jit(jelastic.mask_mixing_matrix)
    for L in (4, 7, 8):
        W = gossip.mixing_matrix(graph, L, 1)
        got = elastic.mask_mixing_matrix(W, np.ones(L, np.float32))
        np.testing.assert_array_equal(got.numpy(), W)  # bitwise W
        for _ in range(4):
            m = (rng.random(L) > 0.35).astype(np.float32)
            m[rng.integers(L)] = 1.0
            got = elastic.mask_mixing_matrix(W, m).numpy()
            want = np.asarray(jmask(jnp.asarray(W), jnp.asarray(m)))
            if np.isfinite(want).all():
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:  # JAX's singular solve (ROADMAP Queue 3): see below
                assert graph == "one_peer_exponential"
            p = m > 0
            np.testing.assert_allclose(got[p][:, p].sum(0), 1.0, rtol=1e-6)
            np.testing.assert_allclose(got[p][:, p].sum(1), 1.0, rtol=1e-6)
            np.testing.assert_array_equal(got[~p], np.eye(L)[~p])
            assert (elastic.present_edge_count(W, m)
                    == float(jelastic.present_edge_count(jnp.asarray(W),
                                                         jnp.asarray(m))))


def test_masked_matrix_where_an_absent_pair_is_closed():
    """A matched one-peer pair both absent neighbours no present learner:
    I - W_aa is singular on their block. JAX's solve returns NaN there;
    the port's matrix is the present block unchanged plus identity rows."""
    W = gossip.mixing_matrix("one_peer_exponential", 8, 0)
    m = np.ones(8, np.float32)
    m[[0, 1]] = 0.0
    want = np.eye(8, dtype=np.float32)
    want[2:, 2:] = W[2:, 2:]
    np.testing.assert_allclose(elastic.mask_mixing_matrix(W, m).numpy(),
                               want, atol=1e-7)
    assert not np.isfinite(np.asarray(jelastic.mask_mixing_matrix(
        jnp.asarray(W), jnp.asarray(m)))).all()


def test_one_peer_churn_with_closed_pairs_stays_finite():
    """L=8, drop 0.25, seed 1: from step 6 on a matched pair is absent
    together now and then, where the JAX reference turns NaN."""
    _, cfg = _cfgs(dict(algorithm="mavg", num_learners=8, k_steps=1),
                   dict(kind="gossip", graph="one_peer_exponential",
                        elastic=dict(period=8, drop_frac=0.25, seed=1)))
    state, metrics = _run_port(cfg, [_batches(i, 8, 1) for i in range(10)])
    assert bool(torch.isfinite(state.global_params).all())
    assert all(np.isfinite(m["mixing_spectral_gap"]) for m in metrics)


def test_frozen_rows_are_tree_where_mask():
    """Saving the absent rows and writing them back is the JAX package's
    leafwise where over the mask."""
    rng = np.random.default_rng(9)
    old = {"a": torch.from_numpy(rng.standard_normal((4, 3, 5))),
           "b": torch.from_numpy(rng.standard_normal((4, 7)))}
    new = {k: v + 1.0 for k, v in old.items()}
    m = torch.tensor([1.0, 0.0, 1.0, 0.0])
    want = elastic.tree_where_mask(m, new, old)
    idx = elastic.absent_index(m)
    frozen = elastic.freeze_rows(old, idx)
    got = elastic.restore_rows({k: v.clone() for k, v in new.items()}, idx,
                               frozen)
    _bitwise(got, want)
    assert elastic.absent_index(torch.ones(4)) is None


# ---------------------------------------------------------------------------
# meta steps against JAX
# ---------------------------------------------------------------------------

HIER_METRICS = ("loss", "grad_norm", "v_norm", "group_v_norm",
                "displacement_norm", "consensus_dist", "outer_fired",
                "comm_bytes_intra", "comm_bytes_inter", "comm_bytes",
                "comm_bytes_dense", "comm_compression")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
@pytest.mark.parametrize("groups", [1, 2])
def test_hierarchical_compressed_matches_jax(groups, packed, spread):
    """int8 + EF inner, int8_topk + EF outer, H=2, per-group K_g. A flip
    moves a value by FLIP_QUANTA quanta, a top-k selection flip one kept
    value (at most the largest displacement) besides."""
    kw = dict(algorithm="mavg", num_learners=4, k_steps=4, learner_lr=0.1,
              momentum=0.6, packed=packed)
    topo = dict(kind="hierarchical", groups=groups, outer_every=2,
                outer_momentum=0.3, inner_comm=INT8_EF, outer_comm=TOPK_EF,
                group_k=(2, 4) if groups == 2 else None)
    jcfg, cfg = _cfgs(kw, topo)
    batch_list = [_batches(s, 4, 4) for s in range(3)]
    jstate, jm = _run_jax(jcfg, batch_list)
    state, m = _run_port(cfg, batch_list)
    limit = FLIP_QUANTA * spread["max"] / 127 + spread["max"]
    _compare(state, jstate, m, jm, HIER_METRICS[:2] + HIER_METRICS[6:],
             limit=limit)
    assert [x["outer_fired"] for x in m] == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("case", ["gossip_int8_ef", "hier_dense",
                                  "hier_int8_ef"])
def test_elastic_matches_jax(case, spread):
    """drop 0.25: one of four learners absent per step."""
    churn = dict(period=4, drop_frac=0.25, seed=1)
    topo = {
        "gossip_int8_ef": dict(kind="gossip", graph="one_peer_exponential",
                               momentum_tracking=True, inner_comm=INT8_EF),
        "hier_dense": dict(kind="hierarchical", groups=2, outer_every=2,
                           outer_momentum=0.3),
        "hier_int8_ef": dict(kind="hierarchical", groups=2, outer_every=2,
                             inner_comm=INT8_EF),
    }[case]
    kw = dict(algorithm="mavg", num_learners=4, k_steps=3, learner_lr=0.1,
              momentum=0.6)
    jcfg, cfg = _cfgs(kw, dict(topo, elastic=churn))
    batch_list = [_batches(s, 4, 3) for s in range(3)]
    jstate, jm = _run_jax(jcfg, batch_list)
    state, m = _run_port(cfg, batch_list)
    names = ("loss", "grad_norm", "loss_spread", "present_count",
             "consensus_dist", "comm_bytes", "comm_bytes_dense",
             "comm_compression")
    if case.startswith("gossip"):
        names += ("mixing_spectral_gap",)
    limit = FLIP_QUANTA * spread["max"] / 127 if spread["max"] else None
    _compare(state, jstate, m, jm, names, limit=limit)
    assert all(x["present_count"] == 3.0 for x in m)
    np.testing.assert_array_equal(state.topo["membership"].numpy(),
                                  jstate.topo["membership"])


# ---------------------------------------------------------------------------
# invariants, inside the port
# ---------------------------------------------------------------------------

ALL_PRESENT = dict(period=4, drop_frac=0.0)


@pytest.mark.parametrize("topo", [
    dict(kind="gossip", graph="ring"),
    dict(kind="gossip", graph="one_peer_exponential",
         momentum_tracking=True),
    dict(kind="gossip", graph="exponential", inner_comm=INT8_EF),
    dict(kind="hierarchical", groups=2, outer_every=2, outer_momentum=0.3),
    dict(kind="hierarchical", groups=2, outer_every=2, inner_comm=INT8_EF,
         outer_comm=TOPK_EF),
], ids=["gossip_ring", "gossip_one_peer", "gossip_int8_ef", "hier_dense",
        "hier_int8_ef"])
def test_e1_all_present_is_static_bitwise(topo):
    kw = dict(algorithm="mavg", num_learners=4, k_steps=3, learner_lr=0.1,
              momentum=0.6)
    batch_list = [_batches(s, 4, 3) for s in range(4)]
    _, static = _cfgs(kw, topo)
    _, el = _cfgs(kw, dict(topo, elastic=ALL_PRESENT))
    s_static, _ = _run_port(static, batch_list)
    s_el, _ = _run_port(el, batch_list)
    _bitwise(s_static.global_params, s_el.global_params)
    _bitwise(s_static.learners, s_el.learners)
    for k, v in s_static.topo.items():
        if v is not None:
            _bitwise(v, s_el.topo[k])


def test_e2_uniform_group_k_is_scalar_k_bitwise():
    kw = dict(algorithm="mavg", num_learners=4, k_steps=3, learner_lr=0.1,
              momentum=0.6)
    topo = dict(kind="hierarchical", groups=2, outer_every=2)
    batch_list = [_batches(s, 4, 3) for s in range(4)]
    s_plain, m_plain = _run_port(_cfgs(kw, topo)[1], batch_list)
    s_k, m_k = _run_port(_cfgs(kw, dict(topo, group_k=(3, 3)))[1],
                         batch_list)
    _bitwise(s_plain.global_params, s_k.global_params)
    _bitwise(s_plain.topo["group_params"], s_k.topo["group_params"])
    _bitwise(s_plain.learners, s_k.learners)
    np.testing.assert_allclose(float(m_plain[-1]["loss"]),
                               float(m_k[-1]["loss"]), rtol=1e-6)


def test_e4_gossip_churn_keeps_absent_learners_frozen():
    kw = dict(algorithm="mavg", num_learners=8, k_steps=3, momentum=0.6,
              learner_lr=0.1)
    _, cfg = _cfgs(kw, dict(kind="gossip", graph="ring", inner_comm=INT8_EF,
                            elastic=dict(period=4, drop_frac=0.25, seed=1)))
    batch_list = [_batches(i, 8, 3) for i in range(5)]
    state, metrics, trail = _run_port(cfg, batch_list, states=True)
    sched = state.topo["membership"].numpy()
    trail.append(state.topo)
    for i, m in enumerate(metrics):
        absent = sched[i % 4] == 0
        for key in ("params", "momentum", "residual"):
            np.testing.assert_array_equal(trail[i][key].numpy()[absent],
                                          trail[i + 1][key].numpy()[absent])
            assert not np.array_equal(trail[i][key].numpy()[~absent],
                                      trail[i + 1][key].numpy()[~absent])
        assert m["present_count"] == 6.0
        assert m["comm_bytes"] <= m["comm_bytes_dense"]
    np.testing.assert_allclose(state.topo["params"].mean(0).numpy(),
                               state.global_params.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_e4_hierarchical_churn_runs_finite():
    kw = dict(algorithm="mavg", num_learners=8, k_steps=3, momentum=0.6,
              learner_lr=0.1)
    _, cfg = _cfgs(kw, dict(kind="hierarchical", groups=2, outer_every=2,
                            group_k=(2, 3),
                            elastic=dict(period=4, drop_frac=0.25, seed=1)))
    state, metrics = _run_port(cfg, [_batches(i, 8, 3) for i in range(5)])
    assert bool(torch.isfinite(state.global_params).all())
    assert metrics[-1]["present_count"] == 6.0
    steps = make_topology(cfg).local_steps(state.topo, 0)
    sched = state.topo["membership"].numpy()[0]
    assert steps == [int(k * m) for k, m in zip((2,) * 4 + (3,) * 4, sched)]


@pytest.mark.parametrize("mu", [0.0, 0.6])
@pytest.mark.parametrize("eta", [1.0, 1.3])
def test_t1_hierarchical_g1_is_flat_mavg_bitwise(mu, eta):
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=mu, meta_lr=eta)
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    s_flat, _ = _run_port(MAvgConfig(**kw), batch_list)
    s_h, _ = _run_port(_cfgs(kw, dict(kind="hierarchical", groups=1,
                                      outer_every=1))[1], batch_list)
    _bitwise(s_flat.global_params, s_h.global_params)
    _bitwise(s_flat.learners, s_h.learners)


def test_t5_outer_fires_every_h():
    _, cfg = _cfgs(dict(algorithm="mavg", num_learners=4, k_steps=2,
                        momentum=0.5),
                   dict(kind="hierarchical", groups=2, outer_every=3))
    topology = make_topology(cfg)
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology)
    for i in range(6):
        prev = state.global_params.clone()
        state, m = step(state, interop.params_from_jax(_batches(i, 4, 2)))
        moved = float((state.global_params - prev).abs().max())
        if (i + 1) % 3 == 0:
            assert m["outer_fired"] == 1.0 and moved > 1e-7
            assert m["comm_bytes_inter"] > 0
        else:
            assert m["outer_fired"] == 0.0 and moved == 0.0
            assert m["comm_bytes_inter"] == 0.0


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


def test_qwen_reduced_gossip_int8_ef_trajectory_matches_jax(spread):
    """Two packed gossip steps of qwen3-1.7b.reduced() (f32), exponential
    graph, momentum tracking, int8 + EF, from the same params and batches
    on JAX's dither."""
    jmodel = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                                 dtype="float32")
    tmodel = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                 dtype="float32")
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.7)
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jmodel))(
        jax.random.PRNGKey(0)))
    make_batches = jlm_batch_fn(jmodel, 2, 2, 2, 16)
    batches = [jax.device_get(make_batches(jax.random.PRNGKey(50 + i), i))
               for i in range(2)]
    jcfg, cfg = _cfgs(kw, dict(kind="gossip", graph="exponential",
                               momentum_tracking=True, inner_comm=INT8_EF))
    jstate = jinit_state(params, jcfg)
    jstep = jax.jit(jmake_meta_step(
        lambda p, b: japi.loss_fn(p, jmodel, b), jcfg))
    for b in batches:
        jstate, jm = jstep(jstate, b)
    jstate = jax.device_get(jstate)

    topology = make_topology(cfg, dither=_jax_dither())
    state = init_state(interop.params_from_jax(params), cfg,
                       topology=topology)
    step = make_meta_step(lambda p, b: api.loss_fn(p, tmodel, b), cfg,
                          topology=topology)
    for b in batches:
        state, m = step(state, interop.params_from_jax(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["comm_bytes"], float(jm["comm_bytes"]),
                               rtol=1e-6)
    assert spread["max"] > 0
    for port, ref in ((state.global_params, jstate.global_params),
                      (state.topo["params"], jstate.topo["params"]),
                      (state.topo["residual"], jstate.topo["residual"])):
        _close_or_flipped(port, ref, FLIP_QUANTA * spread["max"] / 127)


@pytest.mark.parametrize("args", [
    ["--topology", "gossip", "--gossip-graph", "one_peer_exponential",
     "--comm", "int8"],
    ["--topology", "hierarchical", "--groups", "2", "--outer-every", "2",
     "--elastic-period", "4", "--elastic-drop", "0.25"],
], ids=["gossip", "hierarchical_elastic"])
def test_launcher_runs_topologies_on_cpu(args, capsys):
    launch_train.main(["--device", "cpu", "--learners", "4", "--k", "2",
                       "--steps", "2", "--batch", "2", "--seq", "16"]
                      + args)
    out = capsys.readouterr().out
    assert "meta_step=1" in out and "eval loss" in out
    assert "consensus_dist" in out or "comm_error_norm" in out


def test_async_is_refused(capsys):
    """The async server is ported now: the launcher runs --topology async
    and make_topology builds the server (its elastic membership composed
    in; parity with JAX: tests/test_torch_async.py)."""
    launch_train.main(["--device", "cpu", "--learners", "4", "--k", "2",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--topology", "async", "--async-profile", "1,2,1,2",
                       "--async-staleness", "1", "--elastic-period", "4",
                       "--elastic-drop", "0.25"])
    out = capsys.readouterr().out
    assert "meta_step=1" in out and "staleness_max" in out
    topo = make_topology(MAvgConfig(topology=TopologyConfig(kind="async")))
    assert topo.name == "async" and topo.degenerate
