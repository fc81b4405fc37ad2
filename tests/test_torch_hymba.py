"""The port's Hymba (``repro_torch.models.hymba``) against the JAX
package's, on ``hymba-1.5b.reduced()`` in float32 (2 layers, d 256, 4
query heads and 1 KV head, window 16, 8 meta tokens), params and inputs
from the JAX side.

Limits (f32 matmul and reduction sums run in another order in XLA:CPU and
ATen): branch outputs, states, logits, caches and decode steps rtol = atol
= 1e-5; the loss rtol 1e-5 / atol 1e-6; gradients rtol = atol = 1e-5;
greedy tokens equal. The associative scan itself is JAX's bit for bit on
the CPU: the same odd/even recursion, its multiply-adds fused as XLA fuses
them (measured difference 0). Teacher forcing (decode against the forward)
holds ``tests/test_decode_consistency.py``'s 2e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import hymba as jh  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import hymba  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_map  # noqa: E402,E501

torch.set_num_threads(2)
# see tests/test_torch_attention.py: ATen's first CPU exp on two threads
# can race in this build; one call on one thread makes later ones exact
torch.exp(torch.zeros(8))

ARCH = "hymba-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = dataclasses.replace(jget_config(ARCH).reduced(), dtype="float32")
TCFG = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
B = 2


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol,
                               err_msg=msg)


@pytest.mark.parametrize("n", [1, 2, 7, 24, 33])
def test_associative_scan_is_jax_bitwise(n):
    rng = np.random.default_rng(n)
    a = np.exp(-rng.random((2, n, 5, 3))).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)

    def combine(x, y):
        return y[0] * x[0], y[0] * x[1] + y[1]

    ja, jh_ = jax.device_get(jax.jit(lambda a, b: lax.associative_scan(
        combine, (a, b), axis=1))(a, b))
    ta, th = hymba._associative_scan(torch.from_numpy(a),
                                     torch.from_numpy(b), need_a=True)
    np.testing.assert_array_equal(th.numpy(), jh_)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert hymba._associative_scan(torch.from_numpy(a),
                                   torch.from_numpy(b))[0] is None or n < 2


@pytest.fixture(scope="module")
def block():
    bp = jax.device_get(jax.jit(lambda k: jh._init_block(k, JCFG))(
        jax.random.PRNGKey(0)))
    xn = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                      (B, 12, JCFG.d_model)), np.float32)
    return bp, xn


def jseq(bp, xn, conv=None, ssm=None):
    return jax.jit(lambda *a: jh.mamba_seq(a[0], JCFG, *a[1:]))(
        bp, xn, conv, ssm)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_mamba_seq_matches_jax(block, carried):
    bp, xn = block
    states = (None, None)
    if carried:  # a previous call's conv and SSM states
        _, states = jax.device_get(jseq(bp, jnp.asarray(xn)))
    want, (wconv, wssm) = jax.device_get(jseq(bp, jnp.asarray(xn), *states))
    got, (gconv, gssm) = hymba.mamba_seq(
        interop.params_from_jax(bp), TCFG, torch.from_numpy(xn),
        *(None if s is None else interop.to_tensor(s) for s in states))
    _close(got, want)
    _close(gconv, wconv)
    _close(gssm, wssm)
    # a prompt shorter than the conv's reach is left-padded with zeros
    short = xn[:, :2]
    want, (wconv, _) = jax.device_get(jseq(bp, jnp.asarray(short)))
    got, (gconv, _) = hymba.mamba_seq(interop.params_from_jax(bp), TCFG,
                                      torch.from_numpy(short))
    _close(got, want)
    _close(gconv, wconv)
    assert not gconv[:, 0].any()


def test_mamba_step_matches_jax(block):
    bp, xn = block
    _, states = jax.device_get(jseq(bp, jnp.asarray(xn)))
    tp = interop.params_from_jax(bp)
    tstates = [interop.to_tensor(s) for s in states]
    for t in range(3):
        x1 = xn[:, t:t + 1] * 0.7
        want, states = jax.device_get(jax.jit(
            lambda *a: jh.mamba_step(a[0], JCFG, *a[1:]))(
                bp, jnp.asarray(x1), *states))
        got, tstates = hymba.mamba_step(tp, TCFG, torch.from_numpy(x1),
                                        *tstates)
        _close(got, want, msg=f"step {t}")
        _close(tstates[0], states[0])
        _close(tstates[1], states[1])


@pytest.fixture(scope="module")
def model():
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, JCFG))(
        jax.random.PRNGKey(0)))
    toks = np.random.RandomState(1).randint(
        0, JCFG.vocab_size, (B, 16)).astype(np.int32)
    return params, toks


def test_forward_loss_and_grads_match_jax(model):
    """With the meta prefix: the logits cover the meta tokens too, and the
    loss pads their labels with -1."""
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
        got, _ = api.forward(tparams, TCFG, tbatch)
    assert tuple(got.shape) == (B, 16 + TCFG.meta_tokens, TCFG.vocab_size)
    _close(got, want)
    loss, _ = api.loss_fn(tparams, TCFG, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tree_leaves(tparams)) == 25
    for path, t, g in zip(tree_paths(tparams), tree_leaves(tparams),
                          jleaves):
        _close(t.grad, g, msg=path)


CACHE_KEYS = ("k", "v", "k_meta", "v_meta", "conv", "ssm")


def _same_cache(got, want, msg):
    assert set(got) == set(want) == set(CACHE_KEYS) | {"pos"}
    assert int(got["pos"]) == int(want["pos"])
    for key in CACHE_KEYS:
        g, w = got[key], want[key]
        assert tuple(g.shape) == w.shape, (msg, key)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (msg, key)
        _close(g, w, msg=f"{msg} {key}")


@pytest.mark.parametrize("S,cache_len", [(4, 32), (16, 32), (16, 10)],
                         ids=["below-window", "above-window", "short-cache"])
def test_prefill_cache_matches_jax(model, S, cache_len):
    """The window holds the last W = min(16, cache_len) of the meta + S
    positions, left-padded when fewer; the meta K and V apart; pos counts
    the meta tokens."""
    params, toks = model
    batch = {"tokens": toks[:, :S]}
    jlogits, jcache = jax.device_get(jax.jit(
        lambda p: japi.prefill(p, JCFG, batch, cache_len))(params))
    with torch.no_grad():
        logits, cache = api.prefill(interop.params_from_jax(params), TCFG,
                                    interop.params_from_jax(batch),
                                    cache_len)
    _close(logits, jlogits)
    _same_cache(cache, jcache, "prefill")
    assert int(cache["pos"]) == S + TCFG.meta_tokens
    assert cache["k"].shape[2] == min(16, cache_len)


def test_decode_past_the_window_matches_jax(model):
    """12 decode steps from a 4-token prompt (12 positions with the meta
    tokens): the window fills and shifts past its 16 slots; from the
    port's own cache and from JAX's cache carried over."""
    params, toks = model
    batch = {"tokens": toks[:, :4]}
    jlogits, jcache = jax.device_get(jax.jit(
        lambda p: japi.prefill(p, JCFG, batch, 32))(params))
    tparams = interop.params_from_jax(params)
    with torch.no_grad():
        logits, cache = api.prefill(tparams, TCFG,
                                    interop.params_from_jax(batch), 32)
    carried = interop.cache_from_jax(jcache)
    _same_cache(carried, jcache, "carried")
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, JCFG, c, t))
    nxt = np.argmax(jlogits, -1).astype(np.int32)
    for i in range(12):
        jlogits, jcache = jax.device_get(decode(params, jcache, nxt))
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, TCFG, cache,
                                            torch.from_numpy(nxt))
            clogits, carried = api.decode_step(tparams, TCFG, carried,
                                               torch.from_numpy(nxt))
        _close(logits, jlogits, msg=f"decode {i}")
        _close(clogits, jlogits, msg=f"decode {i} from JAX's cache")
        _same_cache(cache, jcache, f"decode {i}")
        assert np.array_equal(torch.argmax(logits, -1).numpy(),
                              np.argmax(jlogits, -1))
        nxt = np.argmax(jlogits, -1).astype(np.int32)
    assert int(cache["pos"]) == 4 + TCFG.meta_tokens + 12


def test_one_token_prefill_then_decode_matches_forward(model):
    """``tests/test_decode_consistency.py``'s route: the meta K and V come
    from a 1-token prefill, then decode token by token reproduces the
    forward's logits (2e-3) and JAX's decode (1e-5)."""
    params, toks = model
    S = toks.shape[1]
    tparams = interop.params_from_jax(params)
    with torch.no_grad():
        fwd, _ = api.forward(tparams, TCFG,
                             {"tokens": torch.from_numpy(toks)})
        _, cache = api.prefill(tparams, TCFG,
                               {"tokens": torch.from_numpy(toks[:, :1])},
                               S + 4)
    _, jcache = jax.jit(lambda p: japi.prefill(
        p, JCFG, {"tokens": toks[:, :1]}, S + 4))(params)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, JCFG, c, t))
    for i in range(1, S):
        jlogits, jcache = decode(params, jcache, toks[:, i])
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, TCFG, cache,
                                            torch.from_numpy(toks[:, i]))
        torch.testing.assert_close(logits, fwd[:, TCFG.meta_tokens + i],
                                   rtol=2e-3, atol=2e-3)
        _close(logits, jax.device_get(jlogits), msg=f"position {i}")


def _fuse_f32(x, a, s, bp, cfg):
    """The branch sum written out in f32, as JAX computes it."""
    from repro_torch.models import layers as L

    f32 = torch.float32
    ra = L.rmsnorm(a, bp["attn_out_norm"], cfg.norm_eps).to(f32)
    rs = L.rmsnorm(s, bp["ssm_out_norm"], cfg.norm_eps).to(f32)
    fused = (bp["beta_attn"].to(f32) * ra + bp["beta_ssm"].to(f32) * rs)
    return x + (fused * 0.5).to(x.dtype)


def _fuse_bf16(x, a, s, bp, cfg):
    """The regression: torch's own promotion of a 0-d f32 beta times a
    bf16 tensor, which stays bf16."""
    from repro_torch.models import layers as L

    fused = (bp["beta_attn"] * L.rmsnorm(a, bp["attn_out_norm"],
                                         cfg.norm_eps)
             + bp["beta_ssm"] * L.rmsnorm(s, bp["ssm_out_norm"],
                                          cfg.norm_eps)) * 0.5
    return x + fused.to(x.dtype)


def test_bf16_branch_sum_is_f32(model, monkeypatch):
    """In bf16 the port's prefill logits equal those of the branch sum
    written out in f32 bit for bit, and differ from torch's bf16 sum: a
    regression to bf16 sums fails here. Betas away from 1 (as trained
    weights have them) so that the products round."""
    params, toks = model
    cfg = dataclasses.replace(TCFG, dtype="bfloat16")
    tparams = interop.params_from_jax(params)
    tparams["blocks"]["beta_attn"] = torch.tensor([0.8137, 1.2291])
    tparams["blocks"]["beta_ssm"] = torch.tensor([1.1713, 0.6659])
    batch = {"tokens": torch.from_numpy(toks)}

    def run(fuse):
        monkeypatch.setattr(hymba, "_fuse", fuse)
        with torch.no_grad():
            return api.prefill(tparams, cfg, batch, 32)[0]

    real = hymba._fuse
    got = run(real)
    assert torch.equal(got, run(_fuse_f32))
    assert not torch.equal(got, run(_fuse_bf16))
    # the branch sum itself, on one layer's bf16 inputs
    gen = torch.Generator().manual_seed(3)
    x, a, s = (torch.randn((2, 8, cfg.d_model), generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    bp = {"attn_out_norm": {"scale": torch.ones(cfg.d_model)},
          "ssm_out_norm": {"scale": torch.ones(cfg.d_model)},
          "beta_attn": torch.tensor(0.8137), "beta_ssm": torch.tensor(1.1713)}
    assert torch.equal(real(x, a, s, bp, cfg), _fuse_f32(x, a, s, bp, cfg))


def test_init_matches_jax_keys_shapes_and_constants():
    jparams = jax.device_get(jax.jit(lambda k: japi.init_params(k, JCFG))(
        jax.random.PRNGKey(0)))
    tparams = api.init_params(torch.Generator().manual_seed(0), TCFG, "cpu")
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_paths(tparams) == jpaths
    for t, j in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    blocks, jblocks = tparams["blocks"], jparams["blocks"]
    assert tuple(blocks["beta_attn"].shape) == (TCFG.num_layers,)
    for key in ("D", "beta_attn", "beta_ssm"):
        np.testing.assert_array_equal(blocks[key].numpy(), jblocks[key])
    # log(1..N) and softplus^-1(0.01): XLA's and ATen's log and expm1
    # round apart by an ulp at some points
    for key in ("A_log", "b_dt"):
        np.testing.assert_allclose(blocks[key].numpy(), jblocks[key],
                                   rtol=2e-7)
    assert hymba._dt_rank(TCFG) == 16
