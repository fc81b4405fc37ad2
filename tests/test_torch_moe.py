"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on ``deepseek-moe-16b.reduced()`` and
``kimi-k2-1t-a32b.reduced()`` in float32, with the same (carried-over)
params and inputs.

Exactly equal: the capacity ``C`` and the routing integers (slot experts,
positions in capacity, ``keep``), with capacity dropping
(``capacity_factor`` 1.25, and 0.01, which drops most slots) and dropless.
To tolerance: gates rtol 1e-6 (one softmax and one division, in another
order), output and aux loss rtol 1e-5 / atol 1e-6 (f32 matmul sums in
another order in XLA:CPU and ATen), gradients rtol/atol 1e-5.

Then the invariants of ``tests/test_moe_properties.py`` as hypothesis
properties of the port's ``_route`` and ``moe_layer``, and the oracle
checks of ``tests/test_moe.py`` on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import swiglu  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
# capacity_factor, dropless
CASES = [(1.25, False), (0.01, False), (1.25, True)]
CASE_IDS = ["cf1.25", "cf0.01", "dropless"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(),
                                dtype="float32", **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **kw))


def _setup(arch, seed=0, B=2, S=16, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (B, S, jcfg.d_model))) * 0.5
    return jcfg, tcfg, params, x.astype(np.float32)


@pytest.mark.parametrize("cf,dropless", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_route_integers_equal_jax(arch, cf, dropless):
    jcfg, tcfg, params, x = _setup(arch, capacity_factor=cf)
    xt = x.reshape(-1, jcfg.d_model)
    jg, jse, jpos, jkeep, jaux, jC = jax.device_get(
        jmoe._route(jnp.asarray(xt), params, jcfg, dropless))
    g, se, pos, keep, aux, C = moe._route(
        torch.from_numpy(xt), interop.params_from_jax(params), tcfg,
        dropless)
    assert C == jC == jmoe._capacity(xt.shape[0], jcfg, dropless)
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    if cf == 0.01 and not dropless:
        assert not keep.all()  # slots were dropped


@pytest.mark.parametrize("cf,dropless", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_output_aux_and_grads_match_jax(arch, cf, dropless):
    jcfg, tcfg, params, x = _setup(arch, capacity_factor=cf)

    def jloss(p, xx):
        out, aux = jmoe.moe_layer(xx, p, jcfg, dropless)
        return jnp.sum(out * out) * 0.5 + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.device_get(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x)))
    tp = tree_map(lambda t: t.requires_grad_(True),
                  interop.params_from_jax(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_layer(tx, tp, tcfg, dropless)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    ((out * out).sum() * 0.5 + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgp)
    assert len(tree_leaves(tp)) == len(jleaves)
    for t, j in zip(tree_leaves(tp), jleaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T", [1, 7, 8, 31, 64, 4096])
@pytest.mark.parametrize("arch", ARCHS + ["deepseek-moe-16b-full"])
@pytest.mark.parametrize("cf", [1e-6, 0.01, 1.0, 1.25, 2.0, 8.0])
def test_capacity_equals_jax(arch, cf, T):
    full = arch.endswith("-full")
    name = arch.removesuffix("-full")
    jcfg = dataclasses.replace(jget_config(name), capacity_factor=cf)
    tcfg = dataclasses.replace(get_config(name), capacity_factor=cf)
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for dropless in (False, True):
        c = moe._capacity(T, tcfg, dropless)
        assert c == jmoe._capacity(T, jcfg, dropless)
        assert c >= 8 and c % 8 == 0


def test_init_moe_keys_and_shapes_equal_jax():
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    jshapes = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg),
                             jax.random.PRNGKey(0))
    tp = moe.init_moe(None, tcfg, "meta")
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert len(flat) == len(tree_leaves(tp))
    for (path, j), t in zip(flat, tree_leaves(tp)):
        assert tuple(t.shape) == j.shape, path
    gen = torch.Generator().manual_seed(0)
    real = moe.init_moe(gen, tcfg, "cpu")
    # dense_init's scale 1/sqrt(fan_in): d for router and w_in, d_expert
    # for w_out
    for key, fan in (("router", tcfg.d_model), ("w_in", tcfg.d_model),
                     ("w_out", tcfg.d_expert)):
        std = float(real[key].std())
        assert abs(std * np.sqrt(fan) - 1) < 0.05, key


# ---------------------------------------------------------------------------
# the invariants of tests/test_moe_properties.py, on the port
# ---------------------------------------------------------------------------

_BASE = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                            dtype="float32")
_PARAMS = moe.init_moe(torch.Generator().manual_seed(0), _BASE, "cpu")


def _x(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16), T=st.integers(4, 48),
       cf=st.floats(0.05, 2.0))
def test_capacity_invariants(seed, T, cf):
    """Per-expert load never exceeds capacity; kept slots route
    uniquely; gates are a normalised distribution over the top-k."""
    cfg = dataclasses.replace(_BASE, capacity_factor=cf)
    xt = _x(seed, (T, cfg.d_model))
    gates, se, pos, keep, aux, C = moe._route(xt, _PARAMS, cfg)
    assert C == moe._capacity(T, cfg)
    se, pos, keep = se.numpy(), pos.numpy(), keep.numpy()
    for e in range(cfg.num_experts):
        assert keep[se == e].sum() <= C
    pairs = set()
    for i in np.where(keep)[0]:
        key = (int(se[i]), int(pos[i]))
        assert key not in pairs, key
        pairs.add(key)
    g = gates.numpy()
    np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-4)
    assert (g >= 0).all()
    assert np.isfinite(float(aux))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_moe_output_finite_and_shaped(seed):
    x = _x(seed, (2, 8, _BASE.d_model))
    out, aux = moe.moe_layer(x, _PARAMS, _BASE)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) >= 0


def test_capacity_zero_factor_still_defined():
    """Degenerate capacity floors at 8 slots; output stays finite."""
    cfg = dataclasses.replace(_BASE, capacity_factor=1e-6)
    out, _ = moe.moe_layer(_x(3, (1, 64, cfg.d_model)), _PARAMS, cfg)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# tests/test_moe.py's per-token oracle, on the port
# ---------------------------------------------------------------------------


def _oracle(x, p, cfg):
    """Route each token to its top-k experts under the first-come
    capacity rule, one token at a time, in numpy."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d).numpy().astype(np.float64)
    logits = xt @ p["router"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k, C = cfg.moe_top_k, moe._capacity(T, cfg)
    topk = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, topk, axis=-1)
    gates /= gates.sum(-1, keepdims=True)
    counts = np.zeros(cfg.num_experts, int)
    out = np.zeros((T, d))
    w_in, w_out = p["w_in"].numpy(), p["w_out"].numpy()
    for t in range(T):
        for j in range(k):
            e = int(topk[t, j])
            counts[e] += 1
            if counts[e] > C:
                continue
            h = np.einsum("d,dtf->tf", xt[t], w_in[e])
            act = h[0] / (1 + np.exp(-h[0])) * h[1]
            out[t] += gates[t, j] * (act @ w_out[e])
    if cfg.num_shared_experts:
        out += swiglu(x.reshape(T, d), p["shared"]).numpy()
    return out.reshape(B, S, d)


@pytest.mark.parametrize("cf,S,shared", [(1.25, 8, True), (0.01, 32, False)],
                         ids=["routed", "capacity-drops"])
def test_moe_matches_oracle(cf, S, shared):
    cfg = dataclasses.replace(_BASE, capacity_factor=cf,
                              num_shared_experts=_BASE.num_shared_experts
                              if shared else 0)
    x = _x(1, (2, S, cfg.d_model)) * 0.5
    out, aux = moe.moe_layer(x, _PARAMS, cfg)
    np.testing.assert_allclose(out.numpy(), _oracle(x, _PARAMS, cfg),
                               rtol=2e-3, atol=2e-3)
    assert torch.isfinite(aux)


def test_moe_aux_loss_balanced_router():
    """A uniform router gives about the least aux loss there is, the
    coefficient; its tied probabilities pick the lowest experts first, as
    ``lax.top_k`` does."""
    p = dict(_PARAMS, router=torch.zeros_like(_PARAMS["router"]))
    x = _x(2, (2, 64, _BASE.d_model))
    _, aux = moe.moe_layer(x, p, _BASE)
    assert float(aux) <= _BASE.moe_aux_coef * 1.3
    xt = x.reshape(-1, _BASE.d_model)
    _, se, pos, keep, _, _ = moe._route(xt, p, _BASE)
    k = _BASE.moe_top_k
    np.testing.assert_array_equal(se.view(-1, k).numpy(),
                                  np.tile(np.arange(k), (128, 1)))
    jp = {key: np.asarray(v.numpy()) for key, v in p.items()
          if key != "shared"}
    _, jse, jpos, jkeep, _, _ = jax.device_get(jmoe._route(
        jnp.asarray(xt.numpy()), jp, jget_config("deepseek-moe-16b")
        .reduced()))
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


# ---------------------------------------------------------------------------
# the dispatch and combine (kernels/moe_rows.py's plain versions on the
# CPU) against autograd through the index formulation they replace
# ---------------------------------------------------------------------------


def _tables(cf, dropless, routing, T=64):
    """The routing tables of T tokens through ``_BASE``'s router, or with
    ``routing="tied"`` a zero router: every token picks experts 0..k-1, the
    others get no slot, and past the capacity a token's every slot is
    dropped."""
    cfg = dataclasses.replace(_BASE, capacity_factor=cf)
    p = _PARAMS if routing == "router" else dict(
        _PARAMS, router=torch.zeros_like(_PARAMS["router"]))
    _, se, pos, keep, _, C = moe._route(_x(5, (T, cfg.d_model)), p, cfg,
                                        dropless)
    E, k = cfg.num_experts, cfg.moe_top_k
    flat, dispatch, slots = moe._tables(se, pos, keep, T, k, E, C, "cpu")
    if cf == 0.01 and not dropless:
        assert not keep.all()  # dropped slots
    else:
        assert (dispatch == T).any()  # empty cells
    if routing == "tied":
        assert (dispatch.view(E, C)[k:] == T).all()
        if not dropless and cf == 0.01:
            assert (slots == E * C).all(dim=1).any()  # all slots dropped
    return cfg, E * C, dispatch, slots


@pytest.mark.parametrize("routing", ["router", "tied"])
@pytest.mark.parametrize("cf,dropless", CASES, ids=CASE_IDS)
def test_dispatch_and_combine_equal_the_index_formulation(cf, dropless,
                                                          routing):
    """f64: ``ops.moe_dispatch`` equals ``cat([x, 0])[dispatch]`` and
    ``ops.moe_combine`` the clamped gather, ``where`` and ``sum``, forward
    and gradient, bitwise."""
    from repro_torch.kernels import ops

    cfg, N, dispatch, slots = _tables(cf, dropless, routing)
    T, d = slots.shape[0], cfg.d_model
    gen = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    x = rand(T, d)
    got_x, want_x = (x.clone().requires_grad_(True) for _ in range(2))
    got = ops.moe_dispatch(got_x, dispatch, slots)
    want = torch.cat([want_x, want_x.new_zeros((1, d))])[dispatch]
    assert torch.equal(got, want)
    g = rand(N, d)
    got.backward(g)
    want.backward(g)
    assert torch.equal(got_x.grad, want_x.grad)

    y = rand(N, d)
    got_y, want_y = (y.clone().requires_grad_(True) for _ in range(2))
    got = ops.moe_combine(got_y, slots, dispatch)
    rows = want_y[slots.clamp(max=N - 1)]
    want = torch.where((slots < N)[..., None], rows, 0).sum(dim=1)
    assert torch.equal(got, want)
    g = rand(T, d)
    got.backward(g)
    want.backward(g)
    assert torch.equal(got_y.grad, want_y.grad)


def test_dispatch_and_combine_charge_their_kernels_on_meta():
    """On the meta device (the cost model) each move charges its kernel's
    declared bytes, forward and backward, and no flops."""
    from repro_torch.kernels import moe_rows, ops
    from repro_torch.roofline.cost import jit_cost

    cfg, N, dispatch, slots = _tables(1.25, False, "router")
    T, d = slots.shape[0], cfg.d_model
    x = torch.empty((T, d), device="meta", requires_grad=True)
    y = torch.empty((N, d), device="meta", requires_grad=True)
    table, sl = dispatch.to("meta"), slots.to("meta")

    def moves(x, y, table, sl):
        out = (ops.moe_dispatch(x, table, sl).sum()
               + ops.moe_combine(y, sl, table).sum())
        return torch.autograd.grad(out, (x, y))

    jc = jit_cost(moves, x, y, table, sl)
    assert jc.kernel_calls == {"moe_rows_by_table": 2, "moe_sum_by_slots": 2}
    assert jc.flops == 0
    declared = (moe_rows.rows_by_table_cost(x, table).nbytes
                + moe_rows.sum_by_slots_cost(y, sl).nbytes)
    k = slots.shape[1]
    assert declared == (8 * N + 4 * d * (min(T, N) + N)
                        + 8 * T * k + 4 * d * (min(N, T * k) + T))
    assert jc.hbm_bytes >= 2 * declared
