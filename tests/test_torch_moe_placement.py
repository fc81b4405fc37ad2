"""The MoE expert placements of the port (``models/moe.py``:
``EXPERT_AXIS``, ``SHARD_MAP_MESH``, ``set_expert_axis``,
``_constrain_experts``, ``_experts_shard_map``) against the dense route
and JAX's ``moe_layer``.

* Numerically (plain CPU tensors): the sum over n shards of the
  shard-map's local function (``local_experts``: each shard's E/n experts
  on the replicated token block) equals the dense route within rtol 1e-6
  and JAX's MoE forward within rtol 1e-5.
* On a fake 8-rank mesh (DTensors on the meta device, costed by
  ``jit_cost``): the shard-map path is one f32 all-reduce of (T, d) over
  the expert axis a layer and 1/n of the expert matmul flops;
  ``_constrain_experts`` splits the expert dim over the axis; both are
  no-ops unless ``set_expert_axis`` was called; the dry run's
  ``--expert-axis``/``--expert-shard-map`` reach them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.launch import dryrun_lib as D  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.roofline.cost import jit_cost  # noqa: E402
from repro_torch.sharding import Spec  # noqa: E402
from repro_torch.sharding.placed import GroupLabels  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(),
                                dtype="float32", **kw),
            dataclasses.replace(B.get_config(arch).reduced(),
                                dtype="float32", **kw))


def _setup(arch, seed=0, Bt=2, St=16, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (Bt, St, jcfg.d_model))) * 0.5
    return jcfg, tcfg, params, x.astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_shard_sum_equals_dense_route_and_jax(arch, n):
    jcfg, tcfg, params, x = _setup(arch)
    tp = interop.params_from_jax(params)
    tx = torch.from_numpy(x)
    assert moe.EXPERT_AXIS is None and moe.SHARD_MAP_MESH is None
    with torch.no_grad():
        dense, _ = moe.moe_layer(tx, tp, tcfg, dropless=True)
        xt = tx.reshape(-1, tcfg.d_model)
        gates, se, pos, keep, _aux, C = moe._route(xt, tp, tcfg, True)
        E = tcfg.num_experts
        e = E // n
        total = sum(
            moe.local_experts(xt, gates, se, pos, keep, C,
                              tp["w_in"][i * e:(i + 1) * e],
                              tp["w_out"][i * e:(i + 1) * e], i * e,
                              tcfg.moe_top_k)
            for i in range(n))
        if tcfg.num_shared_experts:
            from repro_torch.models.layers import swiglu

            total = total + swiglu(xt, tp["shared"])
    total = total.reshape(dense.shape)
    np.testing.assert_allclose(total.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-7)
    jout, _ = jmoe.moe_layer(jnp.asarray(x), params, jcfg, True)
    np.testing.assert_allclose(total.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


def test_placements_are_no_ops_until_set():
    x = torch.randn(4, 8, 16)
    assert moe._constrain_experts(x) is x
    with moe.expert_axis("model"):
        assert moe.EXPERT_AXIS == "model"
        assert moe._constrain_experts(x) is x  # one device: plain tensor
    assert moe.EXPERT_AXIS is None and moe.SHARD_MAP_MESH is None
    moe.set_expert_axis("model")
    try:
        assert moe.EXPERT_AXIS == "model" and moe.SHARD_MAP_MESH is None
    finally:
        moe.set_expert_axis(None, None)


def test_constrain_experts_splits_the_expert_dim(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = D.fake_mesh((4, 2), ("data", "model"))
    table = S.place(torch.empty((8, 16, 32), device="meta"), Spec(), mesh)
    with moe.expert_axis("model", None):
        out = moe._constrain_experts(table)
    assert tuple(out.placements) == (Replicate(), Shard(0))
    assert tuple(out.to_local().shape) == (4, 16, 32)
    assert moe._constrain_experts(table) is table


def _moe_inputs(tcfg, mesh, T):
    params = moe.init_moe(None, tcfg, torch.device("meta"))
    specs = S.serve_param_shardings(tcfg, mesh)
    blocks = specs["blocks"]["moe"]

    def unstacked(spec):  # the layer view of a stacked leaf's spec
        return Spec(*spec[1:])

    placed = {k: S.place(v, unstacked(blocks[k]) if k != "shared" else None,
                         mesh) if k != "shared" else v
              for k, v in params.items()}
    placed["shared"] = {k: S.place(v, unstacked(blocks["shared"][k]), mesh)
                        for k, v in params["shared"].items()}
    x = S.place(torch.empty((1, T, tcfg.d_model), device="meta"),
                Spec(None, None, None), mesh)
    return placed, x


def test_shard_map_is_one_all_reduce_over_the_expert_axis(fake_group):
    _jcfg, tcfg = _cfgs("deepseek-moe-16b")
    mesh = D.fake_mesh((4, 2), ("data", "model"))
    T = 16
    params, x = _moe_inputs(tcfg, mesh, T)
    labels = GroupLabels(mesh)
    from torch.distributed.tensor.experimental import implicit_replication

    def layer(p, xx):
        with implicit_replication():
            return moe.moe_layer(xx, p, tcfg, dropless=True)[0]

    with moe.expert_axis("model", mesh):
        sm = jit_cost(layer, params, x, groups=labels)
    gspmd = jit_cost(layer, params, x, groups=labels)
    one = jit_cost(lambda p, xx: moe.moe_layer(xx, p, tcfg, True)[0],
                   moe.init_moe(None, tcfg, torch.device("meta")),
                   torch.empty((1, T, tcfg.d_model), device="meta"))
    d = tcfg.d_model
    # one f32 (T, d) all-reduce over the expert axis; the DTensor route
    # all-gathers the (E, C, d) output table instead
    assert sm.collectives_by_type["all-reduce"] == T * d * 4
    assert sm.collectives_by_axes["model"] == sm.collective_bytes
    assert "all-reduce" not in gspmd.collectives_by_type
    assert gspmd.collectives_by_type["all-gather"] >= 2 * T * d * 4
    # this rank's E/2 experts on both routes, and half of the router's
    # and the shared MLP's products (split over 'model' by their specs):
    # half the layer's flops on one device
    assert sm.flops == gspmd.flops == one.flops / 2


def test_dry_run_flags_reach_the_placements(fake_group, monkeypatch):
    cfg = B.get_config("deepseek-moe-16b").reduced()
    monkeypatch.setitem(B.INPUT_SHAPES, "decode_small",
                        B.InputShape("decode_small", 64, 8, "decode"))
    monkeypatch.setattr(D, "get_config", lambda a: cfg)
    monkeypatch.setattr(meshlib, "SINGLE_POD_SHAPE", (4, 2))
    seen = []
    real = moe._experts_shard_map

    def spy(*a, **kw):
        seen.append((moe.EXPERT_AXIS, moe.SHARD_MAP_MESH))
        return real(*a, **kw)

    monkeypatch.setattr(moe, "_experts_shard_map", spy)
    row = D.run_one("deepseek-moe-16b", "decode_small", "single",
                    expert_shard_map=True)
    assert seen and all(ax == "model" and tuple(m.shape) == (4, 2)
                        for ax, m in seen)
    assert moe.EXPERT_AXIS is None and moe.SHARD_MAP_MESH is None
    assert row["collectives"]["by_type"]["all-reduce"] > 0
    from repro_torch.launch import dryrun

    called = []
    monkeypatch.setattr(moe, "set_expert_axis",
                        lambda axis, mesh=None: called.append(axis))
    monkeypatch.setattr(D, "run_one", lambda *a, **kw: {
        "arch": a[0], "shape": a[1], "mesh": a[2], "mode": "faithful",
        "skipped": True, "reason": "stub"})
    monkeypatch.setattr(D, "RESULTS_DIR", "/nonexistent/none")
    monkeypatch.setattr(D, "save_result", lambda res, alg: "none")
    monkeypatch.setattr(D, "result_path", lambda *a: "none")
    assert dryrun.main(["--arch", "deepseek-moe-16b", "--shape",
                        "decode_32k", "--mesh", "single", "--expert-axis",
                        "model"]) == 0
    assert called == ["model"]
