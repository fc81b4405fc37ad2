"""The port's compressed meta averaging (``repro_torch.comm``) against the
JAX package's ``repro.comm``.

Both sides get the same numpy inputs and JAX's own stochastic-rounding
dither: the port's reducers take it through ``interop.dither_from_numpy``
(``_jax_dither``), so every rounding decision is made on the same
uniforms.

Tolerances, with their reasons:

* one reduce on the same inputs: the residual (the compression error) and
  every ``comm_bytes*``/``comm_compression`` metric are EXACTLY equal
  (the same ops in the same order, and the same Python float arithmetic
  for the bytes); ``avg`` is exact up to the order in which the mean over
  L learners is summed (rtol 1e-6); ``comm_error_norm`` is a sum of
  squares taken in another order (rtol 1e-5).
* meta-step trajectories: the local phase differs between XLA:CPU and
  ATen by a few ulps (rtol 1e-5 in tests/test_torch_meta.py), and a
  displacement that moves by an ulp can flip a stochastic-rounding
  decision, which moves that value by one scale quantum s. The meta
  params then differ there by s/L through the average (plus mu s/L
  carried by the momentum into the next step), the residual by s. So a
  trajectory agrees to rtol 1e-5 / atol 1e-6 except at a share of
  ``FLIP_SHARE`` of the values, each within ``FLIP_QUANTA`` quanta of
  the largest scale. On qwen3-1.7b.reduced() (two packed int8+EF steps,
  L=2) 0.16 % of the meta params flipped, by at most 0.50 quanta, and
  0.13 % of the residual, by at most 1.00; the MLP runs flip nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import QuantReducer as JQuantReducer  # noqa: E402
from repro.comm import make_reducer as jmake_reducer  # noqa: E402
from repro.configs.base import CommConfig as JCommConfig  # noqa: E402
from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import lm_batch_fn as jlm_batch_fn  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro.pack import make_pack_spec as jmake_pack_spec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.comm import (  # noqa: E402
    ErrorFeedback,
    QuantReducer,
    TopKReducer,
    make_reducer,
    seeded_dither,
    uses_error_feedback,
)
from repro_torch.configs.base import CommConfig, MAvgConfig  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
L = 3
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))
FLIP_SHARE = 5e-3
FLIP_QUANTA = 2.0


def _jax_dither(seed=0):
    """JAX's own uniforms for (leaf, step, shape), as the port's dither."""
    red = JQuantReducer(seed=seed)
    return interop.dither_from_numpy(
        lambda i, step, shape: np.asarray(
            jax.random.uniform(red._leaf_key(i, step), shape, jnp.float32)))


def _stack(seed, packed):
    """(gp, learners, residual) as numpy: the MLP params, L learners
    displaced from them, and a small residual; packed into planes or
    left as trees."""
    rng = np.random.default_rng(seed)
    gp = JPARAMS
    learners = jax.tree.map(
        lambda x: (x[None] + 0.01 * rng.standard_normal((L,) + x.shape))
        .astype(np.float32), gp)
    residual = jax.tree.map(
        lambda x: (1e-4 * rng.standard_normal(x.shape)).astype(np.float32),
        learners)
    if packed:
        spec = jmake_pack_spec(gp)
        gp = np.asarray(spec.pack(gp))
        learners, residual = (
            np.stack([np.asarray(spec.pack(jax.tree.map(lambda x: x[j], t)))
                      for j in range(L)])
            for t in (learners, residual))
    return gp, learners, residual


def _pairs(scheme, ef):
    jred = jmake_reducer(JMAvgConfig(
        num_learners=L, comm=JCommConfig(scheme=scheme, error_feedback=ef)))
    tred = make_reducer(MAvgConfig(
        num_learners=L, comm=CommConfig(scheme=scheme, error_feedback=ef)),
        dither=_jax_dither())
    return jred, tred


def _leaves_np(tree):
    return [x.numpy() for x in tree_leaves(tree)]


SCHEMES = ["int8", "fp8", "topk", "int8_topk"]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_reducer_matches_jax(scheme, ef, packed):
    gp, learners, residual = _stack(1, packed)
    jred, tred = _pairs(scheme, ef)
    assert tred.name == jred.name
    jres = jax.tree.map(jnp.asarray, residual) if ef else None
    javg, jnew, jm = jred.reduce(jax.tree.map(jnp.asarray, learners),
                                 jax.tree.map(jnp.asarray, gp), jres, step=3)
    tres = interop.params_from_jax(jres) if ef else None
    tavg, tnew, tm = tred.reduce(interop.params_from_jax(learners),
                                 interop.params_from_jax(gp), tres, step=3)
    for a, b in zip(_leaves_np(tavg), jax.tree.leaves(javg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8)
    if ef:
        for a, b in zip(_leaves_np(tnew), jax.tree.leaves(jnew)):
            np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert tnew is None and jnew is None
    for k in ("comm_bytes", "comm_bytes_dense", "comm_compression"):
        assert tm[k] == jm[k], (k, tm[k], jm[k])
    np.testing.assert_allclose(float(tm["comm_error_norm"]),
                               float(jm["comm_error_norm"]), rtol=1e-5)


def test_packed_int8_reduce_writes_over_dither_and_residual():
    """The packed path's c lands in the dither's buffer and err in the
    residual's, which is the new residual."""
    gp, learners, residual = (x.copy() for x in _stack(2, packed=True))
    drawn = []

    def dither(i, step, shape, device):
        drawn.append(torch.rand(shape))
        return drawn[-1]

    red = ErrorFeedback(QuantReducer(dither=dither))
    res = torch.from_numpy(residual.copy())
    avg, new_res, _ = red.reduce(torch.from_numpy(learners),
                                 torch.from_numpy(gp), res, step=0)
    assert new_res is res and len(drawn) == 1
    # drawn[0] now holds c: avg = gp + mean_j c_j (the sum in f64, one
    # f32 rounding), and d + e = c + e'
    np.testing.assert_array_equal(
        avg.numpy(), (torch.from_numpy(gp) + drawn[0].sum(
            0, dtype=torch.float64).div(drawn[0].shape[0]).float()).numpy())
    total = learners - gp[None] + residual
    np.testing.assert_allclose((drawn[0] + new_res).numpy(), total,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_error_feedback_invariant(packed):
    """delta + e = C(delta + e) + e', leaf by leaf (tests/test_comm.py's
    invariant, with its tolerance), and avg = gp + mean_j C_j."""
    gp, learners, residual = _stack(3, packed)
    inner = (QuantReducer(dither=_jax_dither()) if packed else
             TopKReducer(k_frac=0.1, quant_dtype="int8",
                         dither=_jax_dither()))
    red = ErrorFeedback(inner)
    tgp, tl = interop.params_from_jax(gp), interop.params_from_jax(learners)
    e0 = interop.params_from_jax(residual)
    total = tree_map(lambda w, g, e: w - g[None] + e, tl, tgp, e0)
    total_np = _leaves_np(total)
    avg, e1, _ = red.reduce(tl, tgp, e0, step=0)
    c = tree_map(lambda t, e: t - e, total, e1)
    for ci, ti, ei in zip(_leaves_np(c), total_np, _leaves_np(e1)):
        np.testing.assert_allclose(ci + ei, ti, rtol=1e-6, atol=1e-7)
    want = tree_map(lambda g, ci: g + ci.mean(0), tgp, c)
    for a, w in zip(_leaves_np(avg), _leaves_np(want)):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7)


def test_residual_only_with_error_feedback():
    for scheme, ef, expect in [("dense", True, False), ("int8", False, False),
                               ("int8", True, True), ("int8_topk", True, True)]:
        cfg = MAvgConfig(num_learners=3,
                         comm=CommConfig(scheme=scheme, error_feedback=ef))
        assert uses_error_feedback(cfg) == expect
        state = init_state(interop.params_from_jax(JPARAMS), cfg)
        assert (state.comm_residual is not None) == expect, (scheme, ef)
        if expect:
            assert tuple(state.comm_residual.shape) == (
                3,) + tuple(state.global_params.shape)
            assert not state.comm_residual.any()


def test_masked_zeros_survive_quantization():
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((16, 128)).astype(
            np.float32))
    x[:8] = 0.0
    dq, _ = ops.quant_dequant(x, lambda shape: torch.rand(shape))
    assert float(dq[:8].abs().max()) == 0.0


def test_topk_mostly_zero_leaf_stays_sparse():
    """thresh == 0 (ties at zero) must not disable sparsification."""
    gp = {"w": torch.zeros(8, 16)}
    learners = {"w": torch.zeros(2, 8, 16)}
    learners["w"][:, 0, 0] = 1.0
    avg, _, _ = TopKReducer(k_frac=0.1).reduce(learners, gp, None, step=0)
    assert int((avg["w"] != 0).sum()) == 1


def test_seeded_dither_is_reproducible():
    d = seeded_dither(5)
    a = d(0, 3, (4, 128), torch.device("cpu"))
    assert torch.equal(a, d(0, 3, (4, 128), torch.device("cpu")))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert not torch.equal(a, d(1, 3, (4, 128), torch.device("cpu")))
    assert not torch.equal(a, d(0, 4, (4, 128), torch.device("cpu")))
    assert not torch.equal(a, seeded_dither(6)(0, 3, (4, 128), "cpu"))


def test_dither_bridge_gives_jax_uniforms():
    dither = _jax_dither(seed=4)
    got = dither(2, 7, (16, 128), "cpu")
    want = jax.random.uniform(JQuantReducer(seed=4)._leaf_key(2, 7),
                              (16, 128), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() != dither(2, 7, (16, 128), "cpu").data_ptr()
    with pytest.raises(ValueError, match="shape"):
        interop.dither_from_numpy(lambda i, s, shape: np.zeros(3))(
            0, 0, (2,), "cpu")


# ---------------------------------------------------------------------------
# meta-step trajectories against JAX's meta_step
# ---------------------------------------------------------------------------


def _close_or_flipped(got, want, quantum):
    """rtol 1e-5 / atol 1e-6, except a share FLIP_SHARE of the values,
    each within FLIP_QUANTA quanta (see the module docstring)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.mean() <= FLIP_SHARE, off.mean()
    assert np.all(np.abs(got - want)[off] <= FLIP_QUANTA * quantum)


class _QuantumSpy:
    """Wraps a packed reducer and records the largest scale quantum,
    max |w_j - gp + e_j| / 127, that any of its reduces used."""

    def __init__(self, inner):
        self.inner, self.quantum = inner, 0.0

    def init_residual(self, gp, num_learners):
        return self.inner.init_residual(gp, num_learners)

    def reduce(self, learners, gp, residual, *, step):
        d = (learners - gp[None] + residual).abs().max()
        self.quantum = max(self.quantum, float(d) / 127)
        return self.inner.reduce(learners, gp, residual, step=step)


def _mlp_batches(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, 2, 4, D)).astype(np.float32),
            "y": rng.integers(0, C, (2, 2, 4)).astype(np.int32)}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_mlp_int8_ef_trajectory_matches_jax(packed):
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.7, packed=packed)
    batches = [_mlp_batches(s) for s in range(2)]
    jcfg = JMAvgConfig(**kw, comm=JCommConfig(scheme="int8"),
                       use_pallas=True)
    jstate = jinit_state(JPARAMS, jcfg)
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    jm = []
    for b in batches:
        jstate, m = jstep(jstate, b)
        jm.append(m)
    jstate = jax.device_get(jstate)

    cfg = MAvgConfig(**kw, comm=CommConfig(scheme="int8"))
    red = make_reducer(cfg, dither=_jax_dither(cfg.comm.seed))
    state = init_state(interop.params_from_jax(JPARAMS), cfg, reducer=red)
    step = make_meta_step(mlp_loss, cfg, reducer=red)
    for b, want in zip(batches, jm):
        state, m = step(state, interop.params_from_jax(b))
        for k in ("comm_bytes", "comm_bytes_dense", "comm_compression"):
            assert np.float32(m[k]) == np.float32(want[k]), k
        np.testing.assert_allclose(float(m["comm_error_norm"]),
                                   float(want["comm_error_norm"]),
                                   rtol=1e-4)
    for field in ("global_params", "momentum", "learners", "comm_residual"):
        for a, b in zip(tree_leaves(getattr(state, field)),
                        jax.tree.leaves(getattr(jstate, field))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_qwen_reduced_int8_ef_trajectory_matches_jax():
    """Two packed int8+EF meta steps of qwen3-1.7b.reduced() (f32), from
    the same params and batches, on JAX's dither."""
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.7)
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    make_batches = jlm_batch_fn(jcfg, 2, 2, 2, 16)
    batches = [jax.device_get(make_batches(jax.random.PRNGKey(30 + i), i))
               for i in range(2)]
    mcfg = JMAvgConfig(**kw, comm=JCommConfig(scheme="int8"),
                       use_pallas=True)
    jstate = jinit_state(params, mcfg)
    jstep = jax.jit(jmake_meta_step(
        lambda p, b: japi.loss_fn(p, jcfg, b), mcfg))
    for b in batches:
        jstate, jm = jstep(jstate, b)
    jstate = jax.device_get(jstate)

    cfg = MAvgConfig(**kw, comm=CommConfig(scheme="int8"))
    red = _QuantumSpy(make_reducer(cfg, dither=_jax_dither()))
    state = init_state(interop.params_from_jax(params), cfg, reducer=red)
    step = make_meta_step(lambda p, b: api.loss_fn(p, tcfg, b), cfg,
                          reducer=red)
    for b in batches:
        state, m = step(state, interop.params_from_jax(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert np.float32(m["comm_bytes"]) == np.float32(jm["comm_bytes"])
    assert red.quantum > 0
    for field in ("global_params", "momentum", "comm_residual"):
        _close_or_flipped(getattr(state, field), getattr(jstate, field),
                          red.quantum)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_state_from_jax_carries_the_residual(packed):
    """A JAX int8+EF state crosses over with its residual, bitwise, and
    the run continues in the port as in JAX on the bridged dither."""
    kw = dict(algorithm="mavg", num_learners=2, k_steps=2, learner_lr=0.1,
              momentum=0.7, packed=packed)
    jcfg = JMAvgConfig(**kw, comm=JCommConfig(scheme="int8"),
                       use_pallas=True)
    jstep = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    jstate, _ = jstep(jinit_state(JPARAMS, jcfg), _mlp_batches(40))
    jstate = jax.device_get(jstate)
    carried = interop.state_from_jax(jstate)
    assert carried.step == 1
    assert any(bool(x.any()) for x in tree_leaves(carried.comm_residual))
    for field in ("global_params", "momentum", "learners", "comm_residual"):
        for a, b in zip(tree_leaves(getattr(carried, field)),
                        jax.tree.leaves(getattr(jstate, field))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    b1 = _mlp_batches(41)
    ref = jax.device_get(jstep(jstate, b1)[0])
    cfg = MAvgConfig(**kw, comm=CommConfig(scheme="int8"))
    state, _ = make_meta_step(
        mlp_loss, cfg, reducer=make_reducer(cfg, dither=_jax_dither()))(
        carried, interop.params_from_jax(b1))
    for field in ("global_params", "comm_residual"):
        for a, b in zip(tree_leaves(getattr(state, field)),
                        jax.tree.leaves(getattr(ref, field))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
