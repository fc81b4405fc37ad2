"""The port's serving path on the MoE, VLM and audio families against the
JAX package's, on the CPU, in float32, params and inputs from the JAX
side.

* ``deepseek-moe-16b`` and ``kimi-k2-1t-a32b`` reduced: ``prefill``
  (plain attention and the flash kernel's plain version) and 8
  ``decode_step``s from one shared cache (``interop.cache_from_jax``),
  logits and caches to rtol = atol = 1e-5; greedy ``generate`` gives
  JAX's tokens.
* Teacher forcing, as ``tests/test_decode_consistency.py`` (deepseek) and
  ``test_decode_consistency_all.py`` (kimi at ``capacity_factor=8.0``)
  hold JAX: token-by-token decode reproduces the forward logits within
  rtol = atol = 3e-3 (the port's own check), and each decode step's logits
  equal JAX's within 1e-5.
* ``internvl2-76b`` reduced: prefill over patches and tokens (the cache
  holds the patches at positions 0..P-1 and pos = P + S), the prefill's
  logits against the forward's last row (3e-3) and JAX's (1e-5), then
  decode continues at P + S as JAX's does.
* ``hubert-xlarge`` reduced: the bidirectional forward through the flash
  kernel's plain version (non-causal, head dim 64 here) against JAX's;
  the serving launcher refuses it (encoder-only).
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
TF = dict(rtol=3e-3, atol=3e-3)
ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
B, S0, CACHE = 2, 12, 24


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


def _jprefill(jcfg, params, batch, cache_len, use_pallas=False):
    return jax.device_get(jax.jit(lambda p, b: japi.prefill(
        p, jcfg, b, cache_len, use_pallas=use_pallas))(params, batch))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(setup, use_pallas):
    jcfg, tcfg, params, tparams, toks = setup
    jlogits, jcache = _jprefill(jcfg, params, {"tokens": toks}, CACHE,
                                use_pallas)
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
        assert cache[name].shape[0] == tcfg.num_layers
        np.testing.assert_allclose(cache[name].numpy(), jcache[name], **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == S0


def test_decode_from_shared_cache_matches_jax(setup):
    """JAX's prefill once; then both packages decode 8 steps from the same
    cache, fed the same tokens."""
    jcfg, tcfg, params, tparams, toks = setup
    jlogits, jcache = _jprefill(jcfg, params, {"tokens": toks}, CACHE)
    cache = interop.cache_from_jax(jcache)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    nxt = np.argmax(jlogits, -1).astype(np.int32)
    for i in range(8):
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


def test_greedy_generate_equals_jax(setup):
    jcfg, tcfg, params, tparams, toks = setup
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(toks), 8,
                                      CACHE))
    with torch.no_grad():
        got = serve.generate(tparams, tcfg, torch.from_numpy(toks), 8, CACHE,
                             use_pallas=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,kw,seed,S", [
    ("deepseek-moe-16b", {}, 7, 24),
    ("kimi-k2-1t-a32b", {"capacity_factor": 8.0}, 11, 16),
], ids=["deepseek", "kimi-cf8"])
def test_forward_vs_decode_teacher_forcing(arch, kw, seed, S):
    """Token-by-token decode through the cache reproduces the dropless
    forward's logits at every position, and JAX's decode logits."""
    jcfg, tcfg = _cfgs(arch, **kw)
    rng = jax.random.PRNGKey(seed)
    params = jax.device_get(japi.init_params(rng, jcfg))
    toks = np.array(jax.random.randint(rng, (B, S), 0, jcfg.vocab_size,
                                       jnp.int32))
    tparams = interop.params_from_jax(params)
    jcache = japi.init_cache(jcfg, B, S + 4, dtype="float32")
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    with torch.no_grad():
        fwd, _ = api.forward(tparams, tcfg,
                             {"tokens": torch.from_numpy(toks)})
        cache = api.init_cache(tcfg, B, S + 4, dtype="float32",
                               device="cpu")
        for i in range(S):
            logits, cache = api.decode_step(tparams, tcfg, cache,
                                            torch.from_numpy(toks[:, i]))
            jlogits, jcache = decode(params, jcache, toks[:, i])
            torch.testing.assert_close(logits, fwd[:, i], **TF,
                                       msg=f"position {i}")
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       err_msg=f"position {i}", **TOL)


def test_vlm_decode_after_prefill_matches_jax():
    jcfg, tcfg = _cfgs("internvl2-76b")
    rng = jax.random.PRNGKey(11)
    params = jax.device_get(japi.init_params(rng, jcfg))
    S = 8
    P = jcfg.num_patches
    batch = jax.device_get({
        "patches": jax.random.normal(rng, (B, P, jcfg.d_model)) * 0.02,
        "tokens": jax.random.randint(rng, (B, S), 0, jcfg.vocab_size,
                                     jnp.int32),
    })
    cache_len = P + S + 4
    jlogits, jcache = _jprefill(jcfg, params, batch, cache_len)
    tparams = interop.params_from_jax(params)
    tbatch = interop.params_from_jax(batch)
    with torch.no_grad():
        logits, cache = api.prefill(tparams, tcfg, tbatch, cache_len,
                                    use_pallas=True)
        fwd, aux = api.forward(tparams, tcfg, tbatch)
    assert int(cache["pos"]) == int(jcache["pos"]) == P + S
    assert bool(aux["prefix_mask"][:, :P].any()) is False
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    torch.testing.assert_close(logits, fwd[:, -1], **TF)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), jcache[name], **TOL)
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    nxt = np.argmax(jlogits, -1).astype(np.int32)
    for i in range(4):
        jlogits, jcache = decode(params, jcache, nxt)
        with torch.no_grad():
            logits, cache = api.decode_step(tparams, tcfg, cache,
                                            torch.from_numpy(nxt))
        assert logits.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        assert int(cache["pos"]) == P + S + i + 1
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)


def test_audio_bidirectional_flash_forward_matches_jax():
    jcfg, tcfg = _cfgs("hubert-xlarge")
    assert not tcfg.causal and tcfg.is_encoder_only
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jcfg))
    batch = jax.device_get(japi.make_batch(jax.random.PRNGKey(1), jcfg, B,
                                           16))
    jlogits, _ = jax.jit(lambda p: japi.forward(p, jcfg, batch,
                                                use_pallas=True))(params)
    tparams = interop.params_from_jax(params)
    tbatch = interop.params_from_jax(batch)
    with torch.no_grad():
        flash, _ = api.forward(tparams, tcfg, tbatch, use_pallas=True)
        plain, _ = api.forward(tparams, tcfg, tbatch)
    np.testing.assert_allclose(flash.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jlogits), **TOL)


def test_serve_launcher_refuses_the_encoder():
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only: no "
                                         "decode path"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_serve_launcher_serves_moe_on_cpu(capsys):
    serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--batch",
                "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=deepseek-moe-16b batch=2 generated 4 tokens/seq" in out
    assert "on cpu" in out
