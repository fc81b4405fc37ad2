"""The port's xLSTM (``repro_torch.models.xlstm``) against the JAX
package's, on ``xlstm-350m.reduced()`` in float32 (one super-block: one
mLSTM and one sLSTM block, d 256, 4 heads), params and inputs from the JAX
side.

Limits (f32 matmul and reduction sums run in another order in XLA:CPU and
ATen): block outputs, states, logits, caches and decode steps rtol = atol
= 1e-5; the loss rtol 1e-5 / atol 1e-6; gradients rtol = atol = 1e-5;
greedy tokens equal. The port's chunkwise-parallel mLSTM equals its own
recurrent form within ``tests/test_mlstm_chunked.py``'s limits (3e-4 on
outputs, 3e-3 on the states: the two forms sum in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_map  # noqa: E402,E501

torch.set_num_threads(2)

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = dataclasses.replace(jget_config(ARCH).reduced(), dtype="float32")
TCFG = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
B, S = 2, 32


@pytest.fixture(scope="module")
def blocks():
    """JAX's mLSTM and sLSTM block params, and an input."""
    mp = jax.device_get(jax.jit(lambda k: jx._init_mlstm_block(k, JCFG))(
        jax.random.PRNGKey(0)))
    sp = jax.device_get(jax.jit(lambda k: jx._init_slstm_block(k, JCFG))(
        jax.random.PRNGKey(1)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                     (B, S, JCFG.d_model))) * 0.5
    return mp, sp, x.astype(np.float32)


def _jit(fn):
    """JAX's block function, jitted, its config bound."""
    return jax.jit(lambda p, x, state=None: fn(p, JCFG, x, state))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol, err_msg=msg)


def _states(got, want, msg):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == np.asarray(w).shape
        _close(g, w, msg=f"{msg} state {i}")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_mlstm_seq_matches_jax(blocks, carried):
    mp, _, x = blocks
    jstate = None
    if carried:
        _, jstate = jax.device_get(_jit(jx.mlstm_seq)(mp, jnp.asarray(x)))
    want, wst = jax.device_get(_jit(jx.mlstm_seq)(mp, jnp.asarray(x),
                                                  jstate))
    got, gst = xlstm.mlstm_seq(interop.params_from_jax(mp), TCFG,
                               torch.from_numpy(x),
                               interop.params_from_jax(jstate) if carried
                               else None)
    _close(got, want)
    _states(gst, wst, "mlstm")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_slstm_seq_matches_jax(blocks, carried):
    _, sp, x = blocks
    jstate = None
    if carried:
        _, jstate = jax.device_get(_jit(jx.slstm_seq)(sp, jnp.asarray(x)))
    want, wst = jax.device_get(_jit(jx.slstm_seq)(sp, jnp.asarray(x),
                                                  jstate))
    got, gst = xlstm.slstm_seq(interop.params_from_jax(sp), TCFG,
                               torch.from_numpy(x),
                               interop.params_from_jax(jstate) if carried
                               else None)
    _close(got, want)
    _states(gst, wst, "slstm")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_chunked_matches_jax_and_the_recurrence(blocks, chunk,
                                                      carried):
    mp, _, x = blocks
    jstate = None
    if carried:
        _, jstate = jax.device_get(_jit(jx.mlstm_seq)(mp, jnp.asarray(x)))
    tstate = interop.params_from_jax(jstate) if carried else None
    want, wst = jax.device_get(jax.jit(lambda p, x, s: jx.mlstm_chunked(
        p, JCFG, x, s, chunk=chunk))(mp, jnp.asarray(x), jstate))
    tp = interop.params_from_jax(mp)
    got, gst = xlstm.mlstm_chunked(tp, TCFG, torch.from_numpy(x), tstate,
                                   chunk=chunk)
    _close(got, want)
    _states(gst, wst, "chunked")
    rec, rst = xlstm.mlstm_seq(tp, TCFG, torch.from_numpy(x), tstate)
    torch.testing.assert_close(got, rec, rtol=3e-4, atol=3e-4)
    for a, b in zip(gst[:3], rst[:3]):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-3)


@pytest.fixture(scope="module")
def model():
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, JCFG))(
        jax.random.PRNGKey(0)))
    toks = np.random.RandomState(1).randint(
        0, JCFG.vocab_size, (B, 16)).astype(np.int32)
    return params, toks


def test_full_model_with_chunking_matches_jax(model):
    """``set_mlstm_chunk`` switches both packages' forward to the chunked
    form; the module global is restored either way."""
    params, toks = model
    batch = {"tokens": toks}
    jx.set_mlstm_chunk(8)
    xlstm.set_mlstm_chunk(8)
    try:
        want, _ = jax.device_get(jax.jit(
            lambda p: jx.forward(p, JCFG, batch))(params))
        with torch.no_grad():
            got, _ = xlstm.forward(interop.params_from_jax(params), TCFG,
                                   interop.params_from_jax(batch))
    finally:
        jx.set_mlstm_chunk(0)
        xlstm.set_mlstm_chunk(0)
    _close(got, want)
    assert xlstm.MLSTM_CHUNK == 0


def test_forward_loss_and_grads_match_jax(model):
    params, toks = model
    batch = {"tokens": toks, "labels": toks}
    want, _ = jax.device_get(jax.jit(
        lambda p: japi.forward(p, JCFG, batch))(params))
    jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, JCFG, batch)[0]))(params))
    tparams = tree_map(lambda t: t.requires_grad_(True),
                       interop.params_from_jax(params))
    tbatch = interop.params_from_jax(batch)
    with torch.no_grad():
        got, aux = api.forward(tparams, TCFG, tbatch)
    _close(got, want)
    assert float(aux["aux_loss"]) == 0.0
    loss, metrics = api.loss_fn(tparams, TCFG, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    assert float(metrics["ce"].detach()) == float(loss.detach())
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tree_leaves(tparams)) == 31
    for path, t, g in zip(tree_paths(tparams), tree_leaves(tparams),
                          jleaves):
        _close(t.grad, g, msg=path)


def test_prefill_cache_and_decode_match_jax(model):
    """The prefill's logits and its whole cache (tuple structure, shapes,
    dtypes, values), then 8 decode steps from it and the greedy tokens."""
    params, toks = model
    jlogits, jcache = jax.device_get(jax.jit(
        lambda p: japi.prefill(p, JCFG, {"tokens": toks}, 0))(params))
    tparams = interop.params_from_jax(params)
    with torch.no_grad():
        logits, cache = api.prefill(tparams, TCFG,
                                    {"tokens": torch.from_numpy(toks)}, 0)
    _close(logits, jlogits)

    def same_cache(got, want, msg):
        assert set(got) == set(want) == {"m", "s", "pos"}
        assert int(got["pos"]) == int(want["pos"])
        assert got["pos"].dtype == torch.int32 and got["pos"].dim() == 0
        for key in ("m", "s"):
            assert isinstance(got[key], tuple) and len(got[key]) == 4
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                assert tuple(g.shape) == w.shape, (key, i)
                assert g.dtype == torch.float32 and w.dtype == np.float32
                _close(g, w, msg=f"{msg} {key}[{i}]")

    same_cache(cache, jcache, "prefill")
    # the JAX cache carried over decodes as the port's own
    carried = interop.cache_from_jax(jcache)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, JCFG, c, t))
    nxt = np.argmax(jlogits, -1).astype(np.int32)
    for i in range(8):
        jlogits, jcache = jax.device_get(decode(params, jcache, nxt))
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, TCFG, cache,
                                            torch.from_numpy(nxt))
            clogits, carried = api.decode_step(tparams, TCFG, carried,
                                               torch.from_numpy(nxt))
        _close(logits, jlogits, msg=f"decode {i}")
        _close(clogits, jlogits, msg=f"decode {i} from JAX's cache")
        same_cache(cache, jcache, f"decode {i}")
        assert np.array_equal(torch.argmax(logits, -1).numpy(),
                              np.argmax(jlogits, -1))
        nxt = np.argmax(jlogits, -1).astype(np.int32)


def test_init_cache_is_jax_zero_state():
    jcache = jax.device_get(japi.init_cache(JCFG, 3, 64))
    cache = api.init_cache(TCFG, 3, 64, device="cpu")
    for key in ("m", "s"):
        for g, w in zip(cache[key], jcache[key]):
            np.testing.assert_array_equal(g.numpy(), w)
    # every state tensor is its own storage: decode writes them in place
    ptrs = [t.data_ptr() for t in cache["m"] + cache["s"]]
    assert len(set(ptrs)) == 8
    assert int(cache["pos"]) == 0


def test_init_matches_jax_keys_shapes_and_constants():
    jparams = jax.eval_shape(lambda k: japi.init_params(k, JCFG),
                             jax.random.PRNGKey(0))
    tparams = api.init_params(torch.Generator().manual_seed(0), TCFG, "cpu")
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    for t, j in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    assert torch.all(tparams["mlstm"]["b_f"] == 3.0)
    assert torch.all(tparams["slstm"]["b_f"] == 3.0)
    assert torch.all(tparams["slstm"]["b_i"] == 0.0)
    assert xlstm.slstm_up_width(1024) == 1408
    assert xlstm.slstm_up_width(256) == 384
