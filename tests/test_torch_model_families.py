"""The port's transformer against the JAX package's on the MoE, audio and
VLM families, and with a meta-token prefix, at ``.reduced()`` size with the
same (carried-over) params and JAX's own batches (``api.make_batch``).

* ``deepseek-moe-16b`` and ``kimi-k2-1t-a32b`` (a dense leading block,
  then MoE blocks): f32 logits (the dropless forward) and loss (the
  capacity-dropping loss path) to rtol = atol = 1e-5, gradients to 1e-4,
  as ``tests/test_torch_model.py`` holds the dense model; bf16 loss to
  atol 2e-2.
* ``hubert-xlarge`` (precomputed frames, bidirectional, the masked
  prediction loss on ~8 % of positions) and ``internvl2-76b`` (patches
  plus tokens, the labels aligned behind the patch prefix): the same f32
  limits.
* ``qwen3-1.7b.reduced()`` with ``meta_tokens=4``: forward only.
* The init's key paths and shapes equal ``jax.eval_shape`` of JAX's init,
  reduced and at full size, and the batch builders' shapes and dtypes
  equal JAX's.
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
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402,E501

torch.set_num_threads(2)

B, S = 2, 16
FAMILIES = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "hubert-xlarge",
            "internvl2-76b"]


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                **kw))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, _ = _cfgs(request.param)
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    batch = jax.device_get(japi.make_batch(jax.random.PRNGKey(1), jcfg, B,
                                           S))
    return request.param, params, batch


def _grad(t):
    # a leaf the loss does not reach (the token table of the audio model)
    # has no gradient in torch and a zero one in JAX
    return np.zeros(tuple(t.shape), np.float32) if t.grad is None \
        else t.grad.numpy()


def test_f32_logits_loss_and_grads_match_jax(family):
    arch, params, batch = family
    jcfg, tcfg = _cfgs(arch)
    jlogits, jaux = jax.jit(lambda p: japi.forward(p, jcfg, batch))(params)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, batch), has_aux=True))(params)

    tparams = tree_map(lambda x: x.requires_grad_(True),
                       interop.params_from_jax(params))
    tbatch = interop.params_from_jax(batch)
    with torch.no_grad():
        logits, aux = api.forward(tparams, tcfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5, atol=1e-6)
    if jaux["prefix_mask"] is None:
        assert aux["prefix_mask"] is None
    else:
        np.testing.assert_array_equal(aux["prefix_mask"].numpy(),
                                      np.asarray(jaux["prefix_mask"]))
    loss, m = api.loss_fn(tparams, tcfg, tbatch)
    loss.backward()
    for key, want in (("loss", jloss), ("ce", jm["ce"]),
                      ("aux_loss", jm["aux_loss"])):
        got = loss if key == "loss" else m[key]
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    if jcfg.num_experts:
        assert float(jm["aux_loss"]) > 0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tree_leaves(tparams))
    for path, t, j in zip(tree_paths(tparams), tree_leaves(tparams),
                          jleaves):
        np.testing.assert_allclose(_grad(t), np.asarray(j), rtol=1e-4,
                                   atol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_bf16_loss_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jcfg))
    batch = jax.device_get(japi.make_batch(jax.random.PRNGKey(1), jcfg, B,
                                           S))
    want = float(jax.jit(lambda p: japi.loss_fn(p, jcfg, batch)[0])(params))
    with torch.no_grad():
        got, _ = api.loss_fn(interop.params_from_jax(params), tcfg,
                             interop.params_from_jax(batch))
    assert abs(float(got) - want) <= 2e-2


def test_meta_token_prefix_forward_matches_jax():
    jcfg, tcfg = _cfgs("qwen3-1.7b", meta_tokens=4)
    params = jax.device_get(japi.init_params(jax.random.PRNGKey(0), jcfg))
    assert params["embed"]["meta"].shape == (4, jcfg.d_model)
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = japi.forward(params, jcfg, {"tokens": toks})
    with torch.no_grad():
        logits, aux = api.forward(interop.params_from_jax(params), tcfg,
                                  {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, S + 4, tcfg.vocab_size)
    assert aux["prefix_mask"] is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", FAMILIES + ["qwen3-1.7b-meta"])
def test_init_keys_and_shapes_equal_jax(arch, full):
    kw = {"meta_tokens": 4} if arch.endswith("-meta") else {}
    name = arch.removesuffix("-meta")
    jcfg = dataclasses.replace(jget_config(name), **kw)
    tcfg = dataclasses.replace(get_config(name), **kw)
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jshapes = jax.eval_shape(lambda k: japi.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tparams = api.init_params(None, tcfg, "meta")
    assert tree_paths(tparams) == ["/".join(k.key for k in path)
                                   for path, _ in flat]
    for t, (path, j) in zip(tree_leaves(tparams), flat):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
    if name == "deepseek-moe-16b" and full:
        # the serving run's model: 1 dense + 27 MoE layers, 65.50 GB in
        # f32 (norm scales included)
        assert sum(t.numel() for t in tree_leaves(tparams)) == 16_375_728_128
        assert tuple(tparams["blocks"]["moe"]["w_in"].shape) == (
            27, 64, 2048, 2, 1408)


def test_in_place_init_scale_is_the_same_draws():
    """``normal`` scales its draws in place: the same values, bit for bit,
    as the draws times std."""
    from repro_torch.models import layers

    got = layers.normal((64, 33), 0.02, torch.Generator().manual_seed(5),
                        "cpu")
    want = torch.randn((64, 33),
                       generator=torch.Generator().manual_seed(5)) * 0.02
    assert torch.equal(got, want)
    _, tcfg = _cfgs("deepseek-moe-16b")
    a = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    b = api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("arch", FAMILIES + ["qwen3-1.7b"])
def test_batch_builders_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jshapes = japi.batch_shapes(jcfg, 3, 20)
    shapes = api.batch_shapes(tcfg, 3, 20)
    assert list(shapes) == list(jshapes)
    for name, (shape, dtype) in shapes.items():
        jshape, jdtype = jshapes[name]
        assert shape == jshape
        assert str(dtype).removeprefix("torch.") == jnp.dtype(jdtype).name
    batch = api.make_batch(torch.Generator().manual_seed(0), tcfg, 64, 128)
    jbatch = japi.make_batch(jax.random.PRNGKey(0), jcfg, 64, 128)
    assert list(batch) == list(jbatch)
    for name, x in batch.items():
        assert tuple(x.shape) == jbatch[name].shape
        assert str(x.dtype).removeprefix("torch.") == jbatch[name].dtype.name
        if x.dtype == torch.int32:
            assert 0 <= int(x.min()) or name == "labels"
            assert int(x.max()) < tcfg.vocab_size
        else:
            assert abs(float(x.std()) - 0.02) < 1e-3
    labelled = float((batch["labels"] >= 0).float().mean())
    if tcfg.is_encoder_only:
        assert 0.06 < labelled < 0.10 and int(batch["labels"].min()) == -1
    else:
        assert labelled == 1.0
