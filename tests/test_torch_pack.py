"""The port's packed meta-plane layout against the JAX package's.

The same parameter shapes must give the same leaf order, offsets, sizes
and rows in both packages, so a packed plane means the same thing in
each: on the MLP, on ``qwen3-1.7b.reduced()`` and on the FULL
``qwen3-1.7b`` (13,441,992 rows), built from shapes alone on both sides
(``jax.eval_shape`` / ``torch.device("meta")``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro.pack import make_pack_spec as jmake_pack_spec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import MAvgConfig, get_config  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.simple import mlp_init, mlp_loss  # noqa: E402
from repro_torch.pack import PackSpec, make_pack_spec  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

FULL_ROWS = 13_441_992
REDUCED_ROWS = 10_256


def _same_layout(tspec, jspec):
    assert tspec.paths == jspec.paths
    assert tspec.offsets == jspec.offsets
    assert tspec.sizes == jspec.sizes
    assert tspec.rows == jspec.rows
    assert tspec.layout_dict() == jspec.layout_dict()


def test_mlp_layout_matches_jax():
    jp = jmlp_init(jax.random.PRNGKey(0), 8, 16, 4)
    tp = mlp_init(None, 8, 16, 4, device="meta")
    _same_layout(make_pack_spec(tp), jmake_pack_spec(jp))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_qwen3_layout_matches_jax_from_shapes(full):
    jcfg, tcfg = jget_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jshapes = jax.eval_shape(lambda k: japi.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tspec = make_pack_spec(api.init_params(None, tcfg, "meta"))
    _same_layout(tspec, jmake_pack_spec(jshapes))
    assert tspec.rows == (FULL_ROWS if full else REDUCED_ROWS)
    assert tspec.rows % 8 == 0 and tspec.num_leaves == 12
    assert all(off % 128 == 0 for off in tspec.offsets)
    if full:
        assert tspec.total == 1_720_574_976
        assert tspec.plane_bytes() == 6_882_299_904


def test_layout_dict_round_trip():
    spec = make_pack_spec(api.init_params(
        None, get_config("qwen3-1.7b").reduced(), "meta"))
    assert PackSpec.from_layout(spec.layout_dict()) == spec


def _reduced_params():
    cfg = get_config("qwen3-1.7b").reduced()
    return api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def test_pack_unpack_round_trip_bitwise_and_views():
    params = _reduced_params()
    spec = make_pack_spec(params)
    buf = spec.pack(params)
    assert buf.shape == (REDUCED_ROWS, 128)
    back = spec.unpack(buf)
    for x, y in zip(tree_leaves(params), tree_leaves(back)):
        assert x.shape == y.shape and torch.equal(x, y)
    # padding is zero
    mask = torch.ones(spec.total, dtype=torch.bool)
    for off, size in zip(spec.offsets, spec.sizes):
        mask[off:off + size] = False
    assert int(mask.sum()) == spec.pad_waste
    assert torch.all(buf.view(-1)[mask] == 0)
    # same dtype: the leaves are views, writes reach the plane
    tree_leaves(back)[0].fill_(3.0)
    off, size = spec.offsets[0], spec.sizes[0]
    assert torch.all(buf.view(-1)[off:off + size] == 3.0)
    # cast round trip: bf16 leaves are copies holding bf16 values
    half = spec.unpack(buf, dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(half))


def test_stacked_round_trip_matches_jax_pack():
    rng = np.random.default_rng(0)
    jp = jmlp_init(jax.random.PRNGKey(1), 8, 16, 4)
    stacked = {k: rng.standard_normal((3,) + v.shape).astype(np.float32)
               for k, v in jp.items()}
    jspec = jmake_pack_spec(jp)
    spec = make_pack_spec(interop.params_from_jax(jp))
    buf = spec.pack_stacked(interop.params_from_jax(stacked))
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jspec.pack_stacked(stacked)))
    back = spec.unpack_stacked(buf)
    for k in stacked:
        np.testing.assert_array_equal(back[k].numpy(), stacked[k])


@pytest.mark.parametrize("algorithm", ["mavg", "mavg_mlocal"])
def test_padding_stays_zero_after_meta_steps(algorithm):
    params = mlp_init(torch.Generator().manual_seed(0), 8, 16, 4,
                      device="cpu")
    cfg = MAvgConfig(algorithm=algorithm, num_learners=2, k_steps=2,
                     local_momentum=0.5 if algorithm == "mavg_mlocal"
                     else 0.0)
    state = init_state(params, cfg)
    spec = state.spec
    assert spec.pad_waste > 0
    gen = torch.Generator().manual_seed(1)
    step = make_meta_step(mlp_loss, cfg)
    for _ in range(2):
        batches = {"x": torch.randn((2, 2, 4, 8), generator=gen),
                   "y": torch.randint(0, 4, (2, 2, 4), generator=gen)}
        state, _ = step(state, batches)
    mask = torch.ones(spec.total, dtype=torch.bool)
    for off, size in zip(spec.offsets, spec.sizes):
        mask[off:off + size] = False
    planes = [state.global_params, state.momentum, *state.learners]
    if state.local_momentum is not None:
        planes += list(state.local_momentum)
    for plane in planes:
        assert torch.all(plane.reshape(-1)[mask] == 0)
    assert state.step == 2


def test_full_width_state_budget():
    """The default MAvgConfig at L=4 keeps 2 + L f32 planes of the full
    model: 41.3 GB, which the in-place meta step keeps as the floor."""
    spec = make_pack_spec(api.init_params(
        None, get_config("qwen3-1.7b"), "meta"))
    cfg = MAvgConfig()
    assert dataclasses.asdict(cfg)["compute_dtype"] == "float32"
    planes = 2 + cfg.num_learners
    assert planes * spec.plane_bytes() == 41_293_799_424
