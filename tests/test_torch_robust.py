"""The port's robust aggregation (``repro_torch.robust``, the
``robust_reduce`` kernel's plain version, the reducers' ``aggregate`` hook
and the topologies' clip) against the JAX package's ``repro.robust``,
and the contract of tests/test_robust.py re-pinned in the port.

Both sides get the same numpy inputs (JAX's MLP params, batches drawn
with numpy, JAX's own dither). Tolerances, with their reasons:

* ``robust_reduce_plain`` sums the kept values in ascending order and
  divides once, as the JAX oracle ``ref.robust_reduce_ref`` run eagerly
  does: EQUAL, NaN and +-inf included. Under ``jax.jit`` XLA turns the
  division by n = L - 2 trim into a product with 1/n, exact only for a
  power of two: within 1 ulp. ``trim=0`` equals ``torch.mean`` bitwise.
* meta steps on the MLP (4 learners, 3 steps): rtol 1e-5 / atol 1e-6, as
  the other topology tests (the local phase differs by a few ulps between
  XLA:CPU and ATen; the trimmed mean at L=4, trim 1 keeps 2 values, so
  both packages divide exactly). The clip factors come from norms that
  both packages reduce in their own order, so a clipped learner moves by
  a few ulps of its displacement: inside the same bound.
* the robust metrics: the port takes the norms and the Krum distances
  from one f32 Gram matrix (``robust.gram``), JAX its norms from a sum of
  squares and its Gram from an XLA product: rtol 1e-4 (the distances
  G_jj + G_kk - 2 G_jk cancel). The runs are built with a wide margin
  around the clip budget: the clipped learner is 30x or more over it,
  every other learner under a third of it, so both packages clip the
  same learners on the same steps.
* the robust bench (benchmarks/robust_bench.py) runs on the port alone at
  smoke size, on JAX's teacher batches, and is held to the bench's own
  bars: ``loss_vs_fault_free <= 1.05``, ``mean_degrades``,
  ``state_finite``, ``bitwise_off``, and ``rollbacks == 0`` with the
  robust arm run under the port's ``Supervisor``, as the reference runs
  it. The port's runner itself, ``repro_torch.benchmarks.robust_bench``,
  is held against JAX's in ``tests/test_torch_benches.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import CLASSES, D_IN, HIDDEN  # noqa: E402
from repro.chaos import ChaosConfig as JChaosConfig  # noqa: E402
from repro.chaos import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.chaos import FaultSpec as JFaultSpec  # noqa: E402
from repro.chaos import PayloadCorruptor as JPayloadCorruptor  # noqa: E402
from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import Trainer as JTrainer  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import classif_batch_fn as jclassif_batch_fn  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.robust_reduce import median_trim as jmedian_trim  # noqa: E402,E501
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.robust import anomaly_scores as janomaly_scores  # noqa: E402
from repro.robust import make_robust as jmake_robust  # noqa: E402
from repro.robust import robust_ring_buffers as jring  # noqa: E402
from repro.topology import make_topology as jmake_topology  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    ChaosConfig,
    FaultSchedule,
    FaultSpec,
    PayloadCorruptor,
)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.core.supervisor import RecoveryPolicy, Supervisor  # noqa: E402,E501
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import robust_reduce as rr  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    RobustAggregator,
    anomaly_scores,
    make_robust,
    robust_ring_buffers,
)
from repro_torch.topology import make_topology  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
FULL = dict(estimator="trimmed", trim=1, clip_mult=3.0, clip_window=2,
            score=True)
INERT = dict(estimator="mean", clip_mult=0.0, score=False)


def _jax_dither(seed=0):
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def _mcfg(base, **kw):
    """An MAvgConfig of ``base`` (either package's configs module); the
    ``robust``, ``comm`` and ``topology`` (with ``elastic``) entries are
    dicts of the nested configs' fields."""
    if "robust" in kw and kw["robust"] is not None:
        kw["robust"] = base.RobustConfig(**kw["robust"])
    if "comm" in kw:
        kw["comm"] = base.CommConfig(**kw["comm"])
    if "topology" in kw:
        t = dict(kw["topology"])
        if "elastic" in t:
            t["elastic"] = base.ElasticConfig(**t["elastic"])
        kw["topology"] = base.TopologyConfig(**t)
    return base.MAvgConfig(**kw)


def _pair(**kw):
    return _mcfg(jbase, **dict(kw)), _mcfg(tbase, **dict(kw))


def _chaos(pkg, faults, horizon):
    """The same ChaosConfig in JAX (pkg 'jax') or the port."""
    CC, FS = ((JChaosConfig, JFaultSpec) if pkg == "jax"
              else (ChaosConfig, FaultSpec))
    return CC(seed=0, horizon=horizon, faults=tuple(FS(**f) for f in faults))


# learner 3 ships finite-but-corrupt payloads (the robust bench's two
# kinds): a stuck bit 29 every step, and its plane scaled x12 on step 2,
# the first step with a full clip ring
STICKY = (dict(kind="finite_bitflip", step=0, learner=3, duration=3, bit=29,
               sticky=True),
          dict(kind="finite_scale", step=2, learner=3, duration=1,
               magnitude=12.0, sticky=True))


def _batches(seed, L, K, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _run_jax(jcfg, batch_list, faults=(), horizon=3):
    cor = (JPayloadCorruptor(JFaultSchedule(
        _chaos("jax", faults, horizon), jcfg.num_learners))
        if faults else None)
    state = jinit_state(JPARAMS, jcfg)
    step = jax.jit(jmake_meta_step(jmlp_loss, jcfg, chaos=cor))
    metrics = []
    for b in batch_list:
        state, m = step(state, b)
        metrics.append(jax.device_get(m))
    return jax.device_get(state), metrics


def _run_port(cfg, batch_list, faults=(), horizon=3):
    cor = (PayloadCorruptor(FaultSchedule(
        _chaos("port", faults, horizon), cfg.num_learners))
        if faults else None)
    topology = make_topology(cfg, dither=_jax_dither())
    state = init_state(interop.params_from_jax(JPARAMS), cfg,
                       topology=topology)
    step = make_meta_step(mlp_loss, cfg, topology=topology, chaos=cor)
    metrics = []
    for b in batch_list:
        state, m = step(state, interop.params_from_jax(b))
        metrics.append(m)
    return state, metrics


def _close(port, ref, rtol=1e-5, atol=1e-6):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# R1: the kernel's plain version
# ---------------------------------------------------------------------------


def _stack(L, seed, specials=True, shape=(16, 128)):
    """(L,) + shape f32 normals with columns of -0.0 and, with
    ``specials``, NaN, +-inf and mixed-sign zeros (needs 33 values a
    learner)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L,) + shape).astype(np.float32)
    f = x.reshape(L, -1)  # a view
    f[:, :4] = np.float32(-0.0)  # whole columns of -0.0
    if specials:
        f[0, 8:16] = np.nan
        f[1 % L, 12:20] = np.inf
        f[2 % L, 16:24] = -np.inf
        f[L - 1, 24:32] = -0.0
        f[:, 32] = [0.0 if j % 2 else -0.0 for j in range(L)]
    return x


@pytest.mark.parametrize("L", range(2, 17))
def test_r1_trim0_is_bitwise_mean(L):
    x = torch.from_numpy(_stack(L, L, specials=False))
    got = rr.robust_reduce_plain(x, 0)
    assert torch.equal(got, torch.mean(x, dim=0))
    assert torch.equal(got.view(torch.int32),
                       torch.mean(x, dim=0).view(torch.int32))
    assert torch.equal(ops.robust_reduce(x, trim=0), got)


@pytest.mark.parametrize("L", range(2, 9))
def test_r1_plain_matches_jax_oracle(L):
    """Every trim 0..median_trim(L), with NaN, +-inf and -0.0 in the
    stack: equal to the eager oracle (signed zeros included), within 1 ulp
    of the jitted one."""
    x = _stack(L, 10 + L)
    jitted = jax.jit(jref.robust_reduce_ref, static_argnums=1)
    for trim in range(rr.median_trim(L) + 1):
        got = rr.robust_reduce_plain(torch.from_numpy(x), trim).numpy()
        want = np.asarray(jref.robust_reduce_ref(jnp.asarray(x), trim))
        np.testing.assert_array_equal(got, want)
        assert np.array_equal(np.signbit(got), np.signbit(want))
        np.testing.assert_array_max_ulp(got, np.asarray(jitted(x, trim)),
                                        maxulp=1)
    assert rr.median_trim(L) == jmedian_trim(L)


def test_r1_specials_trim_to_finite():
    """L=4, trim=1: one NaN, one +inf and one -inf in a coordinate are
    trimmed away (NaN and +inf at the top, -inf at the bottom); trim=0
    returns them."""
    x = np.ones((4, 8, 128), np.float32)
    x[0, 0, 0], x[1, 0, 0], x[2, 0, 0], x[3, 0, 0] = np.nan, 2.0, -1.0, 5.0
    x[0, 0, 1], x[1, 0, 1], x[2, 0, 1], x[3, 0, 1] = np.inf, 2.0, -np.inf, 4.0
    t = torch.from_numpy(x)
    got = rr.robust_reduce_plain(t, 1)
    assert float(got[0, 0]) == 3.5 and float(got[0, 1]) == 3.0
    assert torch.isfinite(got).all()
    got0 = rr.robust_reduce_plain(t, 0)
    assert torch.isnan(got0[0, 0]) and torch.isnan(got0[0, 1])


def test_r1_median_and_tree_and_bf16():
    for L in (5, 6):
        x = _stack(L, 3, specials=False)
        m = rr.robust_reduce_plain(torch.from_numpy(x), rr.median_trim(L))
        np.testing.assert_allclose(m.numpy(), np.median(x, axis=0),
                                   atol=1e-6)
    tree = {"a": torch.from_numpy(_stack(4, 1, shape=(5, 7))),
            "b": torch.from_numpy(_stack(4, 2, shape=(128,)))}
    out = ops.robust_reduce_tree(tree, trim=1)
    for k in tree:
        np.testing.assert_array_equal(
            out[k].numpy(),
            np.asarray(jref.robust_reduce_ref(jnp.asarray(tree[k].numpy()),
                                              1)))
    xb = torch.from_numpy(_stack(5, 4)).to(torch.bfloat16)
    assert torch.equal(rr.robust_reduce_plain(xb, 2),
                       rr.robust_reduce_plain(xb.float(), 2))
    with pytest.raises(AssertionError):
        rr.robust_reduce_plain(xb, 3)


def test_r1_wrapper_refuses_a_row_tile():
    """``block`` is JAX's Pallas row tile: the port's wrapper takes the
    keyword but refuses a value instead of ignoring it."""
    x = torch.from_numpy(_stack(4, 6, shape=(16, 128), specials=False))
    assert torch.equal(ops.robust_reduce(x, trim=1, block=None),
                       rr.robust_reduce_plain(x, 1))
    with pytest.raises(ValueError, match="row tile"):
        ops.robust_reduce(x, trim=1, block=8)


# ---------------------------------------------------------------------------
# R2: inert robust config == robust=None, bitwise, in the port
# ---------------------------------------------------------------------------

TOPOS = {
    "flat": {},
    "flat_leaf": dict(packed=False),
    "hier": dict(topology=dict(kind="hierarchical", groups=2)),
    "gossip": dict(topology=dict(kind="gossip", graph="ring")),
}


@pytest.mark.parametrize("kind", sorted(TOPOS))
def test_r2_inert_robust_is_bitwise_off(kind):
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, **TOPOS[kind])
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    s_off, _ = _run_port(_mcfg(tbase, **kw), batch_list)
    s_on, m_on = _run_port(_mcfg(tbase, **kw, robust=INERT), batch_list)
    _bitwise(s_off.global_params, s_on.global_params)
    _bitwise(s_off.momentum, s_on.momentum)
    _bitwise(s_off.learners, s_on.learners)
    assert not any(k.startswith("robust_clip") for k in m_on[-1])


# ---------------------------------------------------------------------------
# R3: the trimmed mean bounds a corrupt learner, as in JAX
# ---------------------------------------------------------------------------


def _mix_once(cfg, learners, gp, v, port):
    """One flat mix at step 0 from the JAX init's (gp, v)."""
    if port:
        topo = make_topology(cfg)
        res = topo.init_buffers(gp, cfg)[0]
        learners = tree_map(lambda x: x.clone(), learners)
        return topo.mix(learners, gp.clone(), v.clone(), res, None,
                        step=0)
    topo = jmake_topology(cfg)
    return topo.mix(learners, gp, v, topo.init_buffers(gp, cfg)[0], None,
                    step=0)


def test_r3_trimmed_bounds_corrupt_learner():
    L = 6
    kw = dict(algorithm="mavg", num_learners=L, k_steps=2, learner_lr=0.1,
              momentum=0.0)
    jmean, tmean = _pair(**kw)
    jtrim, ttrim = _pair(**kw, robust=dict(estimator="trimmed", trim=1,
                                           score=False))
    js = jinit_state(JPARAMS, jmean)
    rng = np.random.default_rng(4)
    noise = np.asarray(js.learners) + 1e-3 * rng.standard_normal(
        js.learners.shape).astype(np.float32)
    poisoned = noise.copy()
    poisoned[0] += 1e6
    gp, v = np.array(js.global_params), np.array(js.momentum)

    def gp_after(cfgs, learners):
        jout = _mix_once(cfgs[0], jnp.asarray(learners), jnp.asarray(gp),
                         jnp.asarray(v), port=False)[0]
        tout = _mix_once(cfgs[1], torch.from_numpy(learners),
                         torch.from_numpy(gp), torch.from_numpy(v),
                         port=True)[0]
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-6, atol=1e-6)
        return tout

    def dist(a, b):
        return float(torch.linalg.vector_norm(a - b))

    clean_mean = gp_after((jmean, tmean), noise)
    clean_trim = gp_after((jtrim, ttrim), noise)
    dirty_mean = gp_after((jmean, tmean), poisoned)
    dirty_trim = gp_after((jtrim, ttrim), poisoned)
    assert dist(dirty_mean, clean_mean) > 1e4
    assert dist(dirty_trim, clean_trim) < 1.0


# ---------------------------------------------------------------------------
# the packed int8 path skips the estimator, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm", ["dense", "int8"])
def test_packed_int8_skips_the_robust_estimator(comm):
    """MLP, L=4, learner 0 shifted by +1e3, one flat mix: the trimmed mean
    bounds the dense mix, but on the packed plane with int8 the reducer
    averages C(delta) with the plain mean (comm/quant.py), in JAX and in
    the port alike: robust on and off give the same bits."""
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.0, comm=dict(scheme=comm, error_feedback=False))
    joff, toff = _pair(**kw)
    jon, ton = _pair(**kw, robust=dict(estimator="trimmed", trim=1,
                                       score=False))
    js = jinit_state(JPARAMS, joff)
    shifted = np.asarray(js.learners).copy()
    shifted[0] += 1e3
    gp, v = np.array(js.global_params), np.array(js.momentum)
    out = {}
    for name, (jc, tc) in (("off", (joff, toff)), ("on", (jon, ton))):
        jt = jmake_topology(jc)
        jgp = jt.mix(jnp.asarray(shifted), jnp.asarray(gp), jnp.asarray(v),
                     None, None, step=0)[0]
        tt = make_topology(tc, dither=_jax_dither())
        tgp = tt.mix(torch.from_numpy(shifted.copy()),
                     torch.from_numpy(gp.copy()), torch.from_numpy(v.copy()),
                     None, None, step=0)[0]
        out[name] = (np.asarray(jgp), tgp.numpy())
    for side in (0, 1):  # 0: JAX, 1: the port
        top_off = np.abs(out["off"][side] - gp).max()
        top_on = np.abs(out["on"][side] - gp).max()
        assert top_off > 100.0
        if comm == "int8":
            np.testing.assert_array_equal(out["on"][side], out["off"][side])
        else:
            assert top_on < 1.0
    np.testing.assert_allclose(out["on"][1], out["on"][0], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# R4: rejection, not deferral
# ---------------------------------------------------------------------------


def test_r4_clip_is_rejection_not_deferral():
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, comm=dict(scheme="int8", error_feedback=True))
    rcfg = dict(estimator="mean", clip_mult=1.5, clip_window=1, score=False)
    cfg_a, cfg_b = _mcfg(tbase, **kw, robust=rcfg), _mcfg(tbase, **kw)
    topo_a = make_topology(cfg_a, dither=_jax_dither())
    topo_b = make_topology(cfg_b, dither=_jax_dither())
    state = init_state(interop.params_from_jax(JPARAMS), cfg_a,
                       topology=topo_a)
    gp, v = state.global_params, state.momentum
    res_a = state.comm_residual
    res_b = topo_b.init_buffers(gp, cfg_b)[0]
    ring = {k: state.topo[k] for k in ("robust_ring", "robust_count")}
    rng = np.random.default_rng(5)
    benign = state.learners + 0.01 * torch.from_numpy(
        rng.standard_normal(tuple(state.learners.shape)).astype(np.float32))

    gp_a, v_a, _, res_a, ring, m_a = topo_a.mix(
        benign.clone(), gp.clone(), v.clone(), res_a, ring, step=0)
    gp_b, v_b, _, res_b, _, _ = topo_b.mix(
        benign.clone(), gp.clone(), v.clone(), res_b, None, step=0)
    assert float(m_a["robust_clipped_learners"]) == 0.0
    assert torch.equal(gp_a, gp_b) and torch.equal(res_a, res_b)

    corrupt = benign.clone()
    corrupt[3] += 50.0
    gp_b0, v_b0, res_b0 = gp_b.clone(), v_b.clone(), res_b.clone()
    clipped, _, _ = topo_a.robust.clip_learners(corrupt.clone(), gp_a,
                                                dict(ring))
    gp_a2, _, _, res_a2, ring2, m_a2 = topo_a.mix(
        corrupt, gp_a, v_a, res_a, ring, step=1)
    assert float(m_a2["robust_clipped_learners"]) == 1.0
    assert int(ring2["robust_count"]) == 2
    gp_b2, _, _, res_b2, _, _ = topo_b.mix(clipped, gp_b0, v_b0, res_b0,
                                           None, step=1)
    assert torch.equal(gp_a2, gp_b2)
    assert torch.equal(res_a2, res_b2)


# ---------------------------------------------------------------------------
# R5, R6: the clip budget and the scores, against JAX's functions
# ---------------------------------------------------------------------------


def test_r5_clip_budget_warmup_then_fires_as_in_jax():
    rcfg = dict(estimator="mean", clip_mult=2.0, clip_window=2, score=True)
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1)
    jcfg, tcfg = _pair(**kw, robust=rcfg)
    ra, jra = make_robust(tcfg), jmake_robust(jcfg)
    assert isinstance(ra, RobustAggregator) and ra.has_clip
    rng = np.random.default_rng(6)
    gp = np.zeros((32,), np.float32)
    ben = (0.1 * rng.standard_normal((4, 32))).astype(np.float32)
    big = ben.copy()
    big[0] += 1000.0

    def both(w, jtopo, ttopo):
        jout, jtopo, jm = jra.clip_learners({"w": jnp.asarray(w)},
                                            {"w": jnp.asarray(gp)}, jtopo)
        tout, ttopo, tm = ra.clip_learners({"w": torch.from_numpy(w.copy())},
                                           {"w": torch.from_numpy(gp)},
                                           ttopo)
        np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]),
                                   rtol=1e-6, atol=1e-6)
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(ttopo["robust_ring"].numpy(),
                                   np.asarray(jtopo["robust_ring"]),
                                   rtol=1e-6)
        assert int(ttopo["robust_count"]) == int(jtopo["robust_count"])
        return tout["w"], jtopo, ttopo, tm

    jtopo, ttopo = jring(jcfg.robust), robust_ring_buffers(tcfg.robust)
    out, _, _, m = both(big, jtopo, ttopo)  # warmup: untouched
    assert float(m["robust_clipped_learners"]) == 0.0
    assert torch.equal(out, torch.from_numpy(big))
    for _ in range(2):
        _, jtopo, ttopo, _ = both(ben, jtopo, ttopo)
    out, _, _, m = both(big, jtopo, ttopo)
    assert float(m["robust_clipped_learners"]) == 1.0
    budget = float(m["robust_clip_budget"])
    assert float(torch.linalg.vector_norm(out[0])) <= budget * (1 + 1e-5)
    assert torch.equal(out[1:], torch.from_numpy(big[1:]))


def test_r6_anomaly_score_singles_out_corrupt_learner():
    rng = np.random.default_rng(7)
    delta = (0.1 * rng.standard_normal((6, 64))).astype(np.float32)
    delta[2] += 50.0
    s = anomaly_scores({"w": torch.from_numpy(delta)}).numpy()
    np.testing.assert_allclose(
        s, np.asarray(janomaly_scores({"w": jnp.asarray(delta)})),
        rtol=1e-4)
    assert s.shape == (6,) and int(np.argmax(s)) == 2
    assert s[2] > 10.0 * np.delete(s, 2).max()


# ---------------------------------------------------------------------------
# R7: the full robust stack, corrupted, against JAX on every topology
# ---------------------------------------------------------------------------

R7_CASES = {
    # flat: trimmed mean + clip + scores + finite guard, packed and per-leaf
    "flat": dict(robust=FULL, finite_guard=True),
    "flat_leaf": dict(robust=FULL, finite_guard=True, packed=False),
    # G=2 of width 2 cannot trim: the estimator stays 'mean' (clip, scores)
    "hier": dict(robust=dict(FULL, estimator="mean"),
                 topology=dict(kind="hierarchical", groups=2)),
    "gossip": dict(robust=FULL, topology=dict(kind="gossip", graph="ring")),
}
R7_METRICS = ("robust_clipped_learners", "robust_clip_budget",
              "robust_anomaly_score", "robust_score_0", "robust_score_3",
              "robust_trim_fraction")


@pytest.mark.parametrize("case", sorted(R7_CASES))
def test_r7_full_robust_stack_matches_jax(case):
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, **R7_CASES[case])
    jcfg, cfg = _pair(**kw)
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    jstate, jm = _run_jax(jcfg, batch_list, STICKY)
    state, m = _run_port(cfg, batch_list, STICKY)
    assert tuple(state.topo["robust_ring"].shape) == (2,)
    assert int(state.topo["robust_count"]) == 3
    _close(state.global_params, jstate.global_params)
    _close(state.learners, jstate.learners)
    np.testing.assert_allclose(state.topo["robust_ring"].numpy(),
                               np.asarray(jstate.topo["robust_ring"]),
                               rtol=1e-4)
    for x, y in zip(m, jm):
        for k in R7_METRICS:
            np.testing.assert_allclose(float(x[k]), float(y[k]), rtol=1e-4,
                                       err_msg=k)
    # the clip fires on the full-ring step only, on learner 3 only
    assert [float(x["robust_clipped_learners"]) for x in m] == [0, 0, 1]
    assert int(np.argmax([float(m[2][f"robust_score_{j}"])
                          for j in range(4)])) == 3
    for x in tree_leaves(state.global_params) + tree_leaves(state.learners):
        assert bool(torch.isfinite(x).all())
    if kw.get("finite_guard"):
        assert [float(x["nonfinite_learners"]) for x in m] == [0.0] * 3


@pytest.mark.parametrize("case", ["hier", "gossip"])
def test_burst_before_the_ring_fills_spreads(case):
    """The x12 burst on steps 1-2, before the 2-step ring is full: the
    warm-up clips nothing, the mean-based hierarchical level (groups of 2
    cannot trim) and the gossip mix pass the scaled plane on, and on the
    first full-ring step the clip scales benign learners too. The JAX
    package does the same."""
    early = (STICKY[0], dict(STICKY[1], step=1, duration=2))
    kw = dict(algorithm="mavg", num_learners=4, k_steps=2, learner_lr=0.1,
              momentum=0.6, **R7_CASES[case])
    jcfg, cfg = _pair(**kw)
    batch_list = [_batches(s, 4, 2) for s in range(3)]
    _, jm = _run_jax(jcfg, batch_list, early)
    _, m = _run_port(cfg, batch_list, early)
    clipped = [float(x["robust_clipped_learners"]) for x in m]
    assert clipped == [float(x["robust_clipped_learners"]) for x in jm]
    assert clipped[:2] == [0.0, 0.0] and clipped[2] >= 3.0


# ---------------------------------------------------------------------------
# R9: inline quarantine on an elastic run
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jbatch_fn(d_in, classes, L, K, B):
    """JAX's teacher-classification stream, one for each shape: every
    ``classif_batch_fn`` call jits a generator of its own, which compiles
    anew, so the tests share one."""
    return jclassif_batch_fn(d_in, classes, L, K, B)


def _teacher(L, K, B, steps_seed=0):
    """JAX's teacher-classification stream and MLP init, as the JAX Trainer
    draws them, for the port's Trainer (through interop)."""
    data_rng, init_rng = jax.random.split(jax.random.PRNGKey(steps_seed))
    jbf = _jbatch_fn(D, C, L, K, B)

    def batch_fn(_gen, step):
        return interop.params_from_jax(jax.device_get(
            jbf(jax.random.fold_in(data_rng, step), step)))

    params = jax.device_get(jmlp_init(init_rng, D, H, C))
    return batch_fn, (lambda _gen: interop.params_from_jax(params))


def test_r9_inline_quarantine_masks_anomalous_learner():
    L, K, B, steps = 4, 2, 4, 6
    kw = dict(algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.05,
              momentum=0.6,
              robust=dict(estimator="mean", score=True, quarantine_after=2,
                          score_ratio=4.0),
              topology=dict(kind="gossip", graph="ring",
                            elastic=dict(period=steps, drop_frac=0.0)))
    jcfg, cfg = _pair(**kw)
    faults = (dict(kind="finite_scale", step=0, learner=3, duration=steps,
                   magnitude=100.0, sticky=True),)
    jtr = JTrainer(
        jbase.TrainConfig(model=None, mavg=jcfg, batch_per_learner=B,
                          meta_steps=steps, seed=0, log_every=1,
                          chaos=_chaos("jax", faults, steps),
                          obs=jbase.ObsConfig(sink="none")),
        jmlp_loss, init_params_fn=lambda rng: jmlp_init(rng, D, H, C),
        batch_fn=_jbatch_fn(D, C, L, K, B))
    jtr.run(log=None)
    jtr.close()
    batch_fn, init_fn = _teacher(L, K, B)
    tr = Trainer(
        tbase.TrainConfig(model=None, mavg=cfg, batch_per_learner=B,
                          meta_steps=steps, seed=0, log_every=1,
                          chaos=_chaos("port", faults, steps)),
        mlp_loss, init_params_fn=init_fn, batch_fn=batch_fn, device="cpu")
    history = tr.run(log=None)
    assert len(history) == steps
    assert tr.quarantined == jtr.quarantined
    assert 3 in tr.quarantined and tr.quarantined[3] <= 2
    m = tr.state.topo["membership"].numpy()
    assert (m[:, 3] == 0.0).all() and (m[:, :3] == 1.0).all()
    rows = [rb for rb in tr.robust_records if "quarantined" in rb]
    assert rows and rows[0]["quarantined"] == [3]
    for rec in history:
        assert not any(k.startswith("robust_") for k in rec)
    assert len(tr.robust_records) == steps
    np.testing.assert_allclose(history[-1]["loss"], jtr.history[-1]["loss"],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# R10, R11: finite faults and config validation
# ---------------------------------------------------------------------------


def test_r10_finite_fault_validation():
    with pytest.raises(AssertionError):
        FaultSpec("finite_scale", step=0, learner=0, magnitude=float("inf"))
    with pytest.raises(AssertionError):
        FaultSpec("finite_scale", step=0, learner=0, magnitude=0.0)
    with pytest.raises(AssertionError):
        FaultSpec("finite_scale", step=0, learner=0, magnitude=2.0 ** 41)
    assert FaultSpec("finite_bitflip", step=0, learner=0, bit=31).bit == 29


@pytest.mark.parametrize("fault", [
    dict(kind="finite_scale", step=0, learner=1, magnitude=64.0),
    dict(kind="finite_bitflip", step=0, learner=1, bit=29),
], ids=["scale", "bitflip"])
def test_r10_finite_guard_is_blind_to_finite_corruption(fault):
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.6, finite_guard=True)
    jcfg, cfg = _pair(**kw)
    b = [_batches(0, 2, 2)]
    plain, _ = _run_port(cfg, b)
    dirty, md = _run_port(cfg, b, (fault,))
    jdirty, jmd = _run_jax(jcfg, b, (fault,))
    assert not torch.equal(plain.global_params, dirty.global_params)
    assert float(md[0]["nonfinite_learners"]) == 0.0
    assert float(jmd[0]["nonfinite_learners"]) == 0.0
    _close(dirty.global_params, jdirty.global_params)
    for x in tree_leaves(dirty.global_params) + tree_leaves(dirty.learners):
        assert bool(torch.isfinite(x).all())


def test_r11_config_validation():
    with pytest.raises(ValueError, match="trim"):
        tbase.MAvgConfig(num_learners=4, k_steps=2,
                         robust=tbase.RobustConfig(trim=2))
    with pytest.raises(ValueError, match="trim"):
        tbase.MAvgConfig(num_learners=8, k_steps=2,
                         topology=tbase.TopologyConfig(kind="hierarchical",
                                                       groups=2),
                         robust=tbase.RobustConfig(trim=2))
    with pytest.raises(ValueError, match="quarantine"):
        tbase.MAvgConfig(num_learners=4, k_steps=2,
                         robust=tbase.RobustConfig(quarantine_after=2))
    with pytest.raises(AssertionError):
        tbase.RobustConfig(estimator="mode")
    with pytest.raises(AssertionError):
        tbase.RobustConfig(score_ratio=1.0)
    assert make_robust(tbase.MAvgConfig(num_learners=4, k_steps=2)) is None
    agg = make_robust(tbase.MAvgConfig(num_learners=8, k_steps=2,
                                       robust=tbase.RobustConfig(trim=3)))
    assert [agg.trim_for(n) for n in (8, 4, 2)] == [3, 1, 0]
    assert make_robust(tbase.MAvgConfig(
        num_learners=5, k_steps=2,
        robust=tbase.RobustConfig(estimator="median"))).trim_for(5) == 2


# ---------------------------------------------------------------------------
# the robust bench's arms at smoke size, on the port
# ---------------------------------------------------------------------------

BENCH_P, BENCH_K, BENCH_B, BENCH_STEPS = 4, 4, 16, 16


def _bench_trainer(steps, *, faults=(), robust=None, guard=False):
    mcfg = tbase.MAvgConfig(
        algorithm="mavg", num_learners=BENCH_P, k_steps=BENCH_K,
        learner_lr=0.2, momentum=0.7, finite_guard=guard,
        robust=None if robust is None else tbase.RobustConfig(**robust))
    tcfg = tbase.TrainConfig(
        model=None, mavg=mcfg, batch_per_learner=BENCH_B, meta_steps=steps,
        seed=0, log_every=2,
        chaos=_chaos("port", faults, steps) if faults else None)
    data_rng, init_rng = jax.random.split(jax.random.PRNGKey(0))
    jbf = _jbatch_fn(D_IN, CLASSES, BENCH_P, BENCH_K, BENCH_B)
    params = jax.device_get(jmlp_init(init_rng, D_IN, HIDDEN, CLASSES))
    return Trainer(
        tcfg, mlp_loss,
        init_params_fn=lambda _g: interop.params_from_jax(params),
        batch_fn=lambda _g, step: interop.params_from_jax(jax.device_get(
            jbf(jax.random.fold_in(data_rng, step), step))),
        device="cpu")


def test_robust_bench_arms_on_the_port():
    steps = BENCH_STEPS
    bad = BENCH_P - 1
    sticky = (dict(kind="finite_bitflip", step=0, learner=bad,
                   duration=steps, bit=29, sticky=True),
              dict(kind="finite_scale", step=steps // 4, learner=bad,
                   duration=3, magnitude=12.0, sticky=True))
    robust = dict(estimator="trimmed", trim=1, clip_mult=3.0, clip_window=4,
                  score=True)

    def final(hist):
        tail = [r["loss"] for r in hist[-5:]]
        return sum(tail) / len(tail)

    base = _bench_trainer(steps).run(log=None)

    def base_at(samples):
        return final([r for r in base if r["samples"] <= samples]
                     or base[:1])

    mean_hist = _bench_trainer(steps, faults=sticky, guard=True).run(
        log=None)
    mean_gap = final(mean_hist) / base_at(mean_hist[-1]["samples"])
    sup = Supervisor(
        lambda plan: _bench_trainer(steps, faults=sticky, robust=robust,
                                    guard=True),
        target_steps=steps, checkpoint_dir=None,
        policy=RecoveryPolicy(max_retries=2))
    tr, _ = sup.run(log=None)
    rob_hist = tr.history
    rollbacks = sum(1 for r in sup.records if r.get("kind") == "recovery")
    gap = final(rob_hist) / base_at(rob_hist[-1]["samples"])
    finite = all(bool(torch.isfinite(p).all()) for p in (
        tr.state.global_params, tr.state.momentum, tr.state.learners))
    short = steps // 2
    ta, tb = _bench_trainer(short), _bench_trainer(short, robust=INERT)
    ta.run(log=None)
    tb.run(log=None)
    bitwise_off = all(torch.equal(x, y) for x, y in (
        (ta.state.global_params, tb.state.global_params),
        (ta.state.learners, tb.state.learners),
        (ta.state.momentum, tb.state.momentum)))
    assert gap <= 1.05, gap  # within_5pct
    assert mean_gap > 1.5 * max(gap, 1.0), (mean_gap, gap)  # mean_degrades
    assert finite  # state_finite
    assert rollbacks == 0 and rob_hist[-1]["meta_step"] == steps - 1
    assert bitwise_off
    scored = [rb for rb in tr.robust_records if "scores" in rb]
    worst = max(scored, key=lambda rb: max(rb["scores"]))
    assert int(np.argmax(worst["scores"])) == bad
