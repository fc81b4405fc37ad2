"""The mean over the learner axis: one summation order for every leaf
width on the CPU, JAX's (``utils/tree.py::mean_axis0``).

ATen's CPU ``torch.mean(x, 0)`` sums a leaf narrower than its vector width
in another order than a wide plane, so the port's per-leaf dense meta step
and its packed one came out one rounding apart at L=8, where JAX's are
bitwise. The mean now sums in learner order and scales by the f32
reciprocal of L, as XLA's ``jnp.mean`` does on the CPU: bitwise with it
at every width, and the two layouts bitwise with each other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import MAvgConfig  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.models.simple import mlp_loss  # noqa: E402
from repro_torch.utils.tree import mean_axis0, tree_leaves  # noqa: E402

D, H, C = 8, 16, 10  # the 10-wide output bias is narrower than a vector


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("L", [2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("width", [1, 3, 10, 16, 33, 128, 1000])
def test_mean_axis0_is_jnp_mean_bitwise(L, width):
    rng = np.random.default_rng(L * 1000 + width)
    x = (rng.standard_normal((L, 7, width))
         * 10.0 ** rng.uniform(-3, 3, (L, 7, width))).astype(np.float32)
    port = mean_axis0(torch.from_numpy(x.copy())).numpy()
    ref = np.asarray(jnp.mean(jnp.asarray(x), axis=0))
    assert np.array_equal(_bits(port), _bits(ref))


def test_mean_axis0_bf16_is_jnp_mean():
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jnp.mean(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                   axis=0).astype(jnp.float32)
    assert torch.equal(mean_axis0(xb).float(),
                       torch.from_numpy(np.asarray(ref)))


def _run(cfg, params, batches):
    state = init_state(params, cfg)
    step = make_meta_step(mlp_loss, cfg)
    for b in batches:
        state, metrics = step(state, b)
    return state, metrics


@pytest.mark.parametrize("L", [2, 4, 8])
def test_per_leaf_step_equals_packed_bitwise(L):
    """Three dense M-AVG meta steps on the MLP, per-leaf against packed."""
    params = interop.params_from_jax(
        jax.device_get(jmlp_init(jax.random.PRNGKey(0), D, H, C)))
    rng = np.random.default_rng(L)
    batches = [{
        "x": torch.from_numpy(
            rng.standard_normal((L, 2, 4, D)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, C, (L, 2, 4)).astype(np.int32)),
    } for _ in range(3)]
    kw = dict(algorithm="mavg", num_learners=L, k_steps=2, momentum=0.7,
              learner_lr=0.2)
    sp, mp = _run(MAvgConfig(**kw, packed=True), params, batches)
    sl, ml = _run(MAvgConfig(**kw, packed=False), params, batches)
    for a, b in zip(tree_leaves(sp.spec.unpack(sp.global_params)),
                    tree_leaves(sl.global_params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(sp.spec.unpack(sp.momentum)),
                    tree_leaves(sl.momentum)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(sp.spec.unpack_stacked(sp.learners)),
                    tree_leaves(sl.learners)):
        assert torch.equal(a, b)
    assert float(mp["loss"]) == float(ml["loss"])
