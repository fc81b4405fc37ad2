"""M-AVG, packing and checkpoints on the hybrid (``hymba-1.5b``) and SSM
(``xlstm-350m``) families: the port against the JAX package on their
reduced configs in float32.

* 2 packed meta steps, mavg, L=2, K=2, B=2, S=16, lr 0.1, mu 0.7, on
  JAX's bigram batches from JAX's initial params: after each step the
  global params, the momentum and both learners' planes agree to rtol
  1e-5 / atol 1e-6, and the loss to rtol 1e-5.
* The pack layout (``PackSpec.layout_dict()``) equals JAX's, reduced and
  at full size.
* A JAX-saved state loads into the port bit for bit, and JAX loads the
  port's file of it back bit for bit.

Remat, the launchers and ``generate`` on the two families:
``tests/test_torch_families_serve.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_state as jload_state  # noqa: E402
from repro.checkpoint import save_state as jsave_state  # noqa: E402
from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import lm_batch_fn as jlm_batch_fn  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.pack import make_pack_spec as jmake_pack_spec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import load_state, save_state  # noqa: E402
from repro_torch.configs.base import MAvgConfig, get_config  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.pack import make_pack_spec  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["hymba-1.5b", "xlstm-350m"]
L, K, B, S, STEPS = 2, 2, 2, 16, 2
MAVG = dict(algorithm="mavg", num_learners=L, k_steps=K, learner_lr=0.1,
            momentum=0.7)
PLANES = ("global_params", "momentum", "learners")


def _cfgs(arch):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def jax_run(request):
    """JAX's params, batches, and its state and loss after each step."""
    arch = request.param
    jcfg, _ = _cfgs(arch)
    params = jax.device_get(jax.jit(lambda k: japi.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    make = jlm_batch_fn(jcfg, L, K, B, S)
    batches = [jax.device_get(make(jax.random.PRNGKey(10 + i), i))
               for i in range(STEPS)]
    mcfg = JMAvgConfig(**MAVG, use_pallas=True)
    state = jinit_state(params, mcfg)
    step = jax.jit(jmake_meta_step(lambda p, b: japi.loss_fn(p, jcfg, b),
                                   mcfg))
    history = []
    for b in batches:
        state, metrics = step(state, b)
        history.append((jax.device_get(state), float(metrics["loss"])))
    return arch, params, batches, history


def test_packed_meta_steps_match_jax_per_step(jax_run):
    arch, params, batches, history = jax_run
    _, tcfg = _cfgs(arch)
    state = init_state(interop.params_from_jax(params), MAvgConfig(**MAVG))
    step = make_meta_step(lambda p, b: api.loss_fn(p, tcfg, b),
                          MAvgConfig(**MAVG))
    for i, (b, (jstate, jloss)) in enumerate(zip(batches, history)):
        state, metrics = step(state, interop.params_from_jax(b))
        np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-5,
                                   err_msg=f"{arch} step {i}")
        for name in PLANES:
            got, want = getattr(state, name), np.asarray(getattr(jstate,
                                                                 name))
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{arch} {name} step {i}")
    assert state.step == STEPS
    assert state.spec.layout_dict() == history[-1][0].spec.layout_dict()


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pack_layout_matches_jax(arch, full):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = jmake_pack_spec(jax.eval_shape(
        lambda k: japi.init_params(k, jcfg), jax.random.PRNGKey(0)))
    tspec = make_pack_spec(api.init_params(None, tcfg, "meta"))
    assert tspec.layout_dict() == jspec.layout_dict()
    assert tspec.paths == jspec.paths and tspec.rows == jspec.rows
    if full:  # the full configs' sizes (PERF.md section 4)
        assert sum(tspec.sizes) == {"hymba-1.5b": 1_662_366_464,
                                    "xlstm-350m": 500_706_448}[arch]


def _words(a):
    a = np.array(a, order="C")
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def test_jax_checkpoint_loads_bitwise_and_back(jax_run, tmp_path):
    arch, params, _, history = jax_run
    jstate = history[-1][0]
    jpath = jsave_state(str(tmp_path / "jax"), jstate, STEPS)
    template = init_state(interop.params_from_jax(params),
                          MAvgConfig(**MAVG))
    state = load_state(jpath, template)
    assert state.step == STEPS
    for name in PLANES:
        np.testing.assert_array_equal(
            _words(getattr(state, name).numpy()),
            _words(np.asarray(getattr(jstate, name))),
            err_msg=f"{arch} {name}")
    tpath = save_state(str(tmp_path / "port"), state, STEPS)
    back = jload_state(tpath, jax.eval_shape(lambda: jstate))
    for name in PLANES:
        np.testing.assert_array_equal(
            _words(np.asarray(getattr(back, name))),
            _words(np.asarray(getattr(jstate, name))),
            err_msg=f"{arch} {name}")
