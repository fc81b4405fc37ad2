"""Remat, the launchers and ``generate`` on the hybrid (``hymba-1.5b``)
and SSM (``xlstm-350m``) families, reduced, on the CPU.

* Remat (``layers.remat``, ``torch.utils.checkpoint``) changes no
  gradient: bitwise equal with and without it.
* The launchers train and serve both archs reduced on the CPU.
* ``interop.cache_from_jax`` carries both families' caches: keys, tuple
  structure, shapes and dtypes.
* ``generate`` serves them with ``cache_len`` below prompt + new tokens
  (xLSTM's cache is its recurrent state, Hymba's a rolling window) with
  JAX's greedy tokens, in float32.

M-AVG, packing and checkpoints: ``tests/test_torch_families_meta.py``.
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["hymba-1.5b", "xlstm-350m"]


def _cfgs(arch):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    """The training forward recomputes each Hymba block and xLSTM
    super-block in the backward pass; without it (``remat`` a plain call)
    every gradient is the same bit for bit."""
    _, tcfg = _cfgs(arch)
    params = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    batch = api.make_batch(torch.Generator().manual_seed(1), tcfg, 2, 16)
    calls = []
    real = layers.remat

    def counted(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)

    def grads():
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss, _ = api.loss_fn(p, tcfg, batch)
        loss.backward()
        return loss.detach(), [t.grad for t in tree_leaves(p)]

    monkeypatch.setattr(layers, "remat", counted)
    loss, with_remat = grads()
    assert len(calls) == {"hymba-1.5b": tcfg.num_layers,
                          "xlstm-350m": 1}[arch], calls
    monkeypatch.setattr(layers, "remat", lambda fn, *args: fn(*args))
    loss_plain, plain = grads()
    assert torch.equal(loss, loss_plain)
    for a, b in zip(with_remat, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_cpu(capsys, arch):
    assert arch in launch_train.__doc__
    launch_train.main(["--device", "cpu", "--arch", arch, "--learners", "2",
                       "--k", "2", "--steps", "2", "--batch", "2", "--seq",
                       "16"])
    out = capsys.readouterr().out
    assert "meta_step=1" in out and "eval loss" in out
    final = float(out.split("final train loss")[1].split()[0])
    assert np.isfinite(final)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(capsys, arch):
    serve.main(["--device", "cpu", "--batch", "2", "--tokens", "4",
                "--arch", arch])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} batch=2 generated 4 tokens/seq")
    assert out[0].endswith("on cpu")
    assert len(eval(out[1].split(":", 1)[1])) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_a_short_cache_len_matches_jax(arch):
    """xLSTM's cache is its recurrent state and Hymba's a rolling window:
    ``cache_len`` 4 under a 12-token prompt and 8 new tokens is served, as
    JAX serves it (the full-KV refusal is
    ``test_torch_serve.py::test_decode_past_the_cache_jax_clamps_port_refuses``)."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(toks), 8, 4))
    with torch.no_grad():
        got = serve.generate(interop.params_from_jax(params), tcfg,
                             torch.from_numpy(toks), 8, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_jax_carries_both_families(arch):
    """Hymba's window, meta, conv and SSM entries and xLSTM's ``(m, s)``
    4-tuples, as the port's own ``init_cache`` lays them out."""
    jcfg, tcfg = _cfgs(arch)
    jcache = jax.device_get(japi.init_cache(jcfg, 3, 40))
    jcache["pos"] = np.asarray(7, np.int32)
    cache = interop.cache_from_jax(jcache)
    ours = api.init_cache(tcfg, 3, 40, device="cpu")
    assert set(cache) == set(ours) == set(jcache)
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 7
    for key in set(ours) - {"pos"}:
        assert (isinstance(cache[key], tuple) == isinstance(ours[key], tuple)
                == isinstance(jcache[key], tuple)), key
        got = cache[key] if isinstance(cache[key], tuple) else (cache[key],)
        want = ours[key] if isinstance(ours[key], tuple) else (ours[key],)
        for g, w, j in zip(got, want, jax.tree_util.tree_leaves(jcache[key])):
            assert g.shape == w.shape == j.shape, key
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g.numpy(), j)
