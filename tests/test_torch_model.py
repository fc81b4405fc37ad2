"""The port's dense transformer against the JAX package's, on
``qwen3-1.7b.reduced()`` with the same (carried-over) params and tokens.

Tolerances:
* ``dtype="float32"``: logits and loss to rtol=atol=1e-5, gradients to
  1e-4. Both sides compute in f32; matmul and softmax sums run in another
  order in XLA:CPU and ATen.
* the default bf16 compute dtype: loss to atol=2e-2. bf16 rounds at other
  points in the two frameworks and accumulates in another order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

B, S = 2, 16


def _cfgs(dtype):
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_setup():
    jcfg, _ = _cfgs("float32")
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size, jnp.int32))
    return params, {"tokens": toks, "labels": toks}


def _reference(jcfg, params, batch):
    def loss(p):
        return japi.loss_fn(p, jcfg, batch)[0]

    logits, _ = jax.jit(lambda p: japi.forward(p, jcfg, batch))(params)
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return np.asarray(logits), float(value), jax.device_get(grads)


def test_f32_logits_loss_and_grads_match_jax(jax_setup):
    params, batch = jax_setup
    jcfg, tcfg = _cfgs("float32")
    logits, loss, grads = _reference(jcfg, params, batch)

    tparams = tree_map(lambda x: x.requires_grad_(True),
                       interop.params_from_jax(params))
    tbatch = interop.params_from_jax(batch)
    with torch.no_grad():
        tlogits, _ = api.forward(tparams, tcfg, tbatch)
    np.testing.assert_allclose(tlogits.numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    tloss, _ = api.loss_fn(tparams, tcfg, tbatch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), loss, rtol=1e-5, atol=1e-5)
    jleaves = jax.tree_util.tree_leaves(grads)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves) == 12
    for tg, jg in zip(tleaves, jleaves):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4)


def test_bf16_loss_matches_jax(jax_setup):
    params, batch = jax_setup
    jcfg, tcfg = _cfgs("bfloat16")
    loss = float(jax.jit(lambda p: japi.loss_fn(p, jcfg, batch)[0])(params))
    with torch.no_grad():
        tloss, _ = api.loss_fn(interop.params_from_jax(params), tcfg,
                               interop.params_from_jax(batch))
    assert abs(float(tloss) - loss) <= 2e-2


def test_other_families_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_params(None, get_config("xlstm-350m").reduced(), "meta")
