"""The port's meta step against the JAX package's, on the MLP.

Algorithm matrix: {mavg, kavg, sync, mavg_mlocal} x Nesterov {off, on} x
packed {on, off}, L=2, K=2, 3 meta steps, from the same params and
batches. JAX runs ``make_meta_step`` with ``use_pallas=True`` (Pallas in
interpret mode, as its own tests run it). ``global_params``, ``momentum``
and the learners agree to rtol=1e-5, atol=1e-6: tanh and the matmul sums
differ by a few ulps between XLA:CPU and ATen, XLA contracts FMAs inside
the Pallas bodies, and this compounds over 6 local steps.

Then invariants I1-I5 of tests/test_meta_properties.py, pinned inside the
port with fixed seeds, and the packed/per-leaf parity of the port, which
is bitwise as in the JAX package (tests/test_pack.py PK3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.models.simple import mlp_loss as jmlp_loss  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import MAvgConfig  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.pack import make_pack_spec  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

D, C, H = 8, 4, 16
JPARAMS = jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C))


def _params():
    return interop.params_from_jax(JPARAMS)


def _batches(seed, L, K, B=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((L, K, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (L, K, B)).astype(np.int32)}


def _run_port(cfg, batch_list, params=None):
    state = init_state(_params() if params is None else params, cfg)
    step = make_meta_step(mlp_loss, cfg)
    history = []
    for b in batch_list:
        state, metrics = step(state, interop.params_from_jax(b))
        history.append(metrics)
    return state, history


def _run_jax(kwargs, batch_list):
    cfg = JMAvgConfig(**kwargs, use_pallas=True)
    state = jinit_state(JPARAMS, cfg)
    step = jax.jit(jmake_meta_step(jmlp_loss, cfg))
    for b in batch_list:
        state, _ = step(state, b)
    return jax.device_get(state)


def _close(port, ref, rtol=1e-5, atol=1e-6):
    pl, rl = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        assert tuple(p.shape) == tuple(np.shape(r))
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["hb", "nesterov"])
@pytest.mark.parametrize("algorithm",
                         ["mavg", "kavg", "sync", "mavg_mlocal"])
def test_meta_step_matches_jax(algorithm, nesterov, packed):
    kwargs = dict(algorithm=algorithm, num_learners=2, k_steps=2,
                  learner_lr=0.1, momentum=0.7, nesterov=nesterov,
                  packed=packed,
                  local_momentum=0.5 if algorithm == "mavg_mlocal" else 0.0)
    batch_list = [_batches(s, 2, 2) for s in range(3)]
    ref = _run_jax(kwargs, batch_list)
    state, history = _run_port(MAvgConfig(**kwargs), batch_list)
    assert state.step == 3 and (state.spec is not None) == packed
    _close(state.global_params, ref.global_params)
    _close(state.momentum, ref.momentum)
    _close(state.learners, ref.learners)
    if algorithm == "mavg_mlocal":
        _close(state.local_momentum, ref.local_momentum)
    assert all(np.isfinite(float(m["loss"])) for m in history)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "leaf"])
def test_state_carried_from_jax_continues_the_run(packed):
    """A JAX MetaState taken mid-run (``interop.state_from_jax``) steps
    on in the port as it does in JAX."""
    kwargs = dict(algorithm="mavg_mlocal", num_learners=2, k_steps=2,
                  learner_lr=0.1, momentum=0.7, local_momentum=0.5,
                  packed=packed)
    b0, b1 = _batches(20, 2, 2), _batches(21, 2, 2)
    jcfg = JMAvgConfig(**kwargs, use_pallas=True)
    step = jax.jit(jmake_meta_step(jmlp_loss, jcfg))
    jstate, _ = step(jinit_state(JPARAMS, jcfg), b0)
    carried = interop.state_from_jax(jax.device_get(jstate))
    assert carried.step == 1 and (carried.spec is not None) == packed
    ref = jax.device_get(step(jstate, b1)[0])
    state, _ = make_meta_step(mlp_loss, MAvgConfig(**kwargs))(
        carried, interop.params_from_jax(b1))
    assert state.step == 2
    _close(state.global_params, ref.global_params)
    _close(state.momentum, ref.momentum)
    _close(state.learners, ref.learners)
    _close(state.local_momentum, ref.local_momentum)


# ---------------------------------------------------------------------------
# invariants I1-I5 (tests/test_meta_properties.py), inside the port
# ---------------------------------------------------------------------------


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed,k", [(0, 1), (7, 3)])
def test_i1_mu0_is_kavg(seed, k):
    b = [_batches(seed, 2, k)] * 2
    s1, _ = _run_port(MAvgConfig(algorithm="mavg", num_learners=2,
                                 k_steps=k, learner_lr=0.05, momentum=0.0), b)
    s2, _ = _run_port(MAvgConfig(algorithm="kavg", num_learners=2,
                                 k_steps=k, learner_lr=0.05, momentum=0.9), b)
    _equal(s1.global_params, s2.global_params)


@pytest.mark.parametrize("mu", [0.0, 0.6])
def test_i2_sync_is_k1(mu):
    b = [_batches(3, 2, 1)] * 2
    s1, _ = _run_port(MAvgConfig(algorithm="sync", num_learners=2,
                                 k_steps=1, momentum=mu), b)
    s2, _ = _run_port(MAvgConfig(algorithm="mavg", num_learners=2,
                                 k_steps=1, momentum=mu), b)
    _equal(s1.global_params, s2.global_params)


def test_i3_identical_learners_collapse():
    b1 = _batches(11, 1, 2)
    b4 = {k: np.broadcast_to(v, (4,) + v.shape[1:]).copy()
          for k, v in b1.items()}
    s1, _ = _run_port(MAvgConfig(algorithm="mavg", num_learners=1,
                                 k_steps=2, momentum=0.5), [b1] * 2)
    s4, _ = _run_port(MAvgConfig(algorithm="mavg", num_learners=4,
                                 k_steps=2, momentum=0.5), [b4] * 2)
    _equal(s1.global_params, s4.global_params)


@pytest.mark.parametrize("mu,eta", [(0.3, 0.5), (0.9, 1.5)])
def test_i4_block_momentum_closed_form(mu, eta):
    b = [_batches(5, 2, 2)]
    spec = make_pack_spec(_params())
    w0 = spec.pack(_params())
    s1, _ = _run_port(MAvgConfig(algorithm="mavg", num_learners=2,
                                 k_steps=2, momentum=mu, meta_lr=eta), b)
    s_kavg, _ = _run_port(MAvgConfig(algorithm="kavg", num_learners=2,
                                     k_steps=2, meta_lr=1.0), b)
    d = s_kavg.global_params - w0  # kavg with eta=1: w' = w + d
    v_expect = eta * d  # v0 = 0
    np.testing.assert_allclose(s1.momentum.numpy(), v_expect.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1.global_params.numpy(),
                               (w0 + v_expect).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("lr", [0.01, 0.2])
def test_i5_k1_p1_is_sgd(lr):
    b = _batches(9, 1, 1)
    s, _ = _run_port(MAvgConfig(algorithm="kavg", num_learners=1,
                                k_steps=1, learner_lr=lr), [b])
    params = tree_map(lambda x: x.requires_grad_(True), _params())
    loss, _ = mlp_loss(params, {k: torch.from_numpy(v[0, 0])
                                for k, v in b.items()})
    loss.backward()
    lr32 = float(np.float32(lr))
    expect = tree_map(lambda p: (p - lr32 * p.grad).detach(), params)
    spec = make_pack_spec(expect)
    np.testing.assert_allclose(s.global_params.numpy(),
                               spec.pack(expect).numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("algorithm", ["mavg", "mavg_mlocal"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["hb", "nesterov"])
def test_packed_matches_per_leaf_bitwise(algorithm, nesterov):
    kw = dict(algorithm=algorithm, num_learners=2, k_steps=2, momentum=0.7,
              nesterov=nesterov,
              local_momentum=0.5 if algorithm == "mavg_mlocal" else 0.0)
    b = [_batches(s, 2, 2) for s in range(2)]
    sp, hp = _run_port(MAvgConfig(**kw, packed=True), b)
    sl, hl = _run_port(MAvgConfig(**kw, packed=False), b)
    _equal(sp.spec.unpack(sp.global_params), sl.global_params)
    _equal(sp.spec.unpack(sp.momentum), sl.momentum)
    _equal(sp.spec.unpack_stacked(sp.learners), sl.learners)
    assert float(hp[-1]["loss"]) == float(hl[-1]["loss"])


def test_unported_configs_raise():
    from repro_torch.configs.base import TopologyConfig

    for cfg in (MAvgConfig(algorithm="downpour"),
                MAvgConfig(finite_guard=True),
                MAvgConfig(topology=TopologyConfig(kind="gossip"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_state(_params(), cfg)
