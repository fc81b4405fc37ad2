"""The port's serving path against the JAX package's, on the CPU:
``prefill`` (plain attention and the flash kernel's plain version),
``decode_step`` from one shared cache (``interop.cache_from_jax``), the
rolling sliding-window cache, greedy ``generate`` and the launcher.

Reduced ``qwen3-1.7b`` (qk-norm, tied embeddings, n_rep 2) and ``qwen2-7b``
(QKV bias, n_rep 4) in float32, params and prompts from the JAX side.
Tolerances: logits and caches to rtol = atol = 1e-5 (both sides compute in
f32; XLA:CPU and ATen sum in another order). The port's own
forward-vs-decode check (the dense cases of
``tests/test_decode_consistency.py``, which holds JAX to 2e-3) holds at
1e-5 as well.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402

torch.set_num_threads(2)
# see tests/test_torch_attention.py: ATen's first CPU exp on two threads
# can race in this build; one call on one thread makes later ones exact
torch.exp(torch.zeros(8))

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-1.7b", "qwen2-7b"]
B, S0, CACHE = 2, 12, 20


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                                **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **kw))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    return jcfg, tcfg, params, interop.params_from_jax(params), toks


def _jprefill(jcfg, params, toks, cache_len, use_pallas=False):
    return jax.device_get(jax.jit(lambda p, b: japi.prefill(
        p, jcfg, b, cache_len, use_pallas=use_pallas))(params,
                                                       {"tokens": toks}))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(setup, use_pallas):
    jcfg, tcfg, params, tparams, toks = setup
    jlogits, jcache = _jprefill(jcfg, params, toks, CACHE, use_pallas)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, cache = api.prefill(tparams, tcfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    CACHE, use_pallas=use_pallas)
    # CPU tensors take the plain version: no kernel launch
    assert ops.launch_counts()["flash_attention"] == 0
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(cache[name].numpy(), jcache[name], **TOL)
    assert cache["pos"].dtype == torch.int32
    assert int(cache["pos"]) == int(jcache["pos"]) == S0


def test_decode_from_shared_cache_matches_jax(setup):
    """JAX's prefill once; then both packages decode 4 steps from the same
    cache, fed the same tokens."""
    jcfg, tcfg, params, tparams, toks = setup
    jlogits, jcache = _jprefill(jcfg, params, toks, CACHE)
    cache = interop.cache_from_jax(jcache)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    nxt = np.argmax(jlogits, -1).astype(np.int32)
    for i in range(4):
        jlogits, jcache = decode(params, jcache, nxt)
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, tcfg, cache,
                                            torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        assert int(cache["pos"]) == int(jcache["pos"]) == S0 + i + 1
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_forward_vs_decode_teacher_forcing(setup):
    """Token-by-token decode through the cache reproduces the forward
    logits at every position (the port's own check)."""
    _, tcfg, _, tparams, _ = setup
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (B, 24)).astype(np.int32))
    with torch.no_grad():
        fwd, _ = api.forward(tparams, tcfg, {"tokens": toks})
        cache = api.init_cache(tcfg, B, 28, dtype="float32", device="cpu")
        for i in range(24):
            logits, cache = api.decode_step(tparams, tcfg, cache, toks[:, i])
            torch.testing.assert_close(logits, fwd[:, i], **TOL,
                                       msg=f"position {i}")


def test_prefill_then_decode_equals_stepwise_decode(setup):
    _, tcfg, _, tparams, toks = setup
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        pf_logits, pf_cache = api.prefill(tparams, tcfg, {"tokens": toks},
                                          CACHE, use_pallas=True)
        cache = api.init_cache(tcfg, B, CACHE, dtype="float32",
                               device="cpu")
        for i in range(S0):
            logits, cache = api.decode_step(tparams, tcfg, cache, toks[:, i])
        torch.testing.assert_close(logits, pf_logits, **TOL)
        for name in ("k", "v"):
            torch.testing.assert_close(cache[name], pf_cache[name], **TOL)


@pytest.mark.parametrize("prompt", [6, 20])
def test_rolling_window_cache_matches_jax(prompt):
    """sliding_window=16: the rolling (window-sized) cache, placed
    window-aligned by prefill (a prompt shorter and longer than the
    window), then 6 decode steps past the window edge, against JAX."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", sliding_window=16)
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(3), jcfg))
    tparams = interop.params_from_jax(params)
    toks = np.random.RandomState(4).randint(
        0, jcfg.vocab_size, (B, prompt + 6)).astype(np.int32)
    cache_len = prompt + 10
    jlogits, jcache = _jprefill(jcfg, params, toks[:, :prompt], cache_len,
                                use_pallas=True)
    with torch.no_grad():
        logits, cache = api.prefill(
            tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :prompt])},
            cache_len, use_pallas=True)
    assert cache["k"].shape[2] == min(cache_len, 16)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), jcache["k"], **TOL)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    for i in range(prompt, prompt + 6):
        jlogits, jcache = decode(params, jcache, toks[:, i])
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, tcfg, cache,
                                            torch.from_numpy(toks[:, i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"position {i}", **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)


def test_rolling_window_decode_vs_forward():
    """Past the window edge the rolling cache still gives the forward's
    sliding-window logits."""
    _, tcfg = _cfgs("qwen3-1.7b", sliding_window=16)
    tparams = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.randint(0, tcfg.vocab_size, (B, 28),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        fwd, _ = api.forward(tparams, tcfg, {"tokens": toks})
        cache = api.init_cache(tcfg, B, 32, dtype="float32", device="cpu")
        assert cache["k"].shape[2] == 16
        for i in range(28):
            logits, cache = api.decode_step(tparams, tcfg, cache, toks[:, i])
            torch.testing.assert_close(logits, fwd[:, i], **TOL,
                                       msg=f"position {i}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_generate_matches_jax(setup, use_pallas):
    jcfg, tcfg, params, tparams, toks = setup
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(toks), 8,
                                      S0 + 16))
    with torch.no_grad():
        got = serve.generate(tparams, tcfg, torch.from_numpy(toks), 8,
                             S0 + 16, use_pallas=use_pallas)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_past_the_cache_jax_clamps_port_refuses():
    """Reduced Qwen3, a prompt of 8 tokens prefilled into 8 cache slots,
    then one decode step. JAX clamps the row index (it overwrites the last
    row) and gives finite logits at pos 9; the port's ``generate`` refuses
    the call before prefill, since its in-place write would fault on the
    card. One more slot is enough for both, and they agree there."""
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    assert not tcfg.sliding_window
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = interop.params_from_jax(params)
    toks = np.random.RandomState(6).randint(
        0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    logits, cache = _jprefill(jcfg, params, toks, 8)
    assert int(cache["pos"]) == 8 and cache["k"].shape[2] == 8
    tok = np.argmax(logits, axis=-1).astype(np.int32)
    logits, cache = jax.jit(lambda p, c, t: japi.decode_step(
        p, jcfg, c, t))(params, cache, tok)
    assert int(cache["pos"]) == 9
    assert np.isfinite(np.asarray(logits)).all()
    with torch.no_grad(), pytest.raises(ValueError, match="cache_len 8"):
        serve.generate(tparams, tcfg, torch.from_numpy(toks), 1, 8)
    with torch.no_grad():
        got = serve.generate(tparams, tcfg, torch.from_numpy(toks), 1, 9)
    want = jserve.generate(params, jcfg, jnp.asarray(toks), 1, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded():
    _, tcfg = _cfgs("qwen3-1.7b")
    tparams = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    prompt = torch.randint(0, tcfg.vocab_size, (B, 4),
                           generator=torch.Generator().manual_seed(1))

    def run(seed):
        with torch.no_grad():
            return serve.generate(tparams, tcfg, prompt, 8, 16,
                                  temperature=1.0, seed=seed)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_serve_launcher_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--tokens", "4",
                "--arch", "qwen2-7b"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2-7b batch=2 generated 4 tokens/seq")
    assert out[0].endswith("on cpu")
    assert len(eval(out[1].split(":", 1)[1])) == 4


def test_cache_from_jax_keeps_layout():
    jcfg, tcfg = _cfgs("qwen3-1.7b", sliding_window=16)
    jcache = jax.device_get(japi.init_cache(jcfg, 3, 40, dtype="float32"))
    jcache["pos"] = np.asarray(7, np.int32)
    cache = interop.cache_from_jax(jcache)
    ours = api.init_cache(tcfg, 3, 40, dtype="float32", device="cpu")
    for name in ("k", "v"):
        assert cache[name].shape == ours[name].shape == (2, 3, 16, 2, 64)
        assert cache[name].dtype == ours[name].dtype == torch.float32
    assert cache["pos"].dtype == ours["pos"].dtype == torch.int32
    assert cache["pos"].shape == () and int(cache["pos"]) == 7


def test_flash_forward_has_no_gradient():
    """``use_pallas`` training is refused at backward, never recomputed
    with the plain version."""
    _, tcfg = _cfgs("qwen3-1.7b")
    tparams = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for leaf in tparams["blocks"]["attn"].values():
        leaf.requires_grad_(True)
    toks = torch.randint(0, tcfg.vocab_size, (B, 8),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = api.loss_fn(tparams, tcfg, {"tokens": toks, "labels": toks},
                          use_pallas=True)
    with pytest.raises(NotImplementedError, match="Queue 2, item 4"):
        loss.backward()
